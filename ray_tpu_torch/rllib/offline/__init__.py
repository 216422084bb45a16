from .io import OfflineData, SampleReader, SampleWriter, episodes_to_rows, rows_to_episodes

__all__ = [
    "OfflineData",
    "SampleReader",
    "SampleWriter",
    "episodes_to_rows",
    "rows_to_episodes",
]
