"""The port's Data module (`ray_tpu_torch.data`) against the reference's
(`ray_tpu.data`).

Each pipeline runs through both modules, on both runtimes at once in this
process (one module-scoped cluster of each, 2 CPUs apiece), from inputs
made with numpy from a seed, and the results are compared row for row:
exactly, integers and floats alike, since the floats are only moved or
reduced by the same numpy calls in the same order. The cases mirror
tests/test_data.py, tests/test_data_rules.py and
tests/test_data_resources.py. Then `iter_torch_batches` against
`iter_jax_batches`, its device and sharding, the divergences of numpy
blocks from arrow ones, and the card's path in a subprocess where pyarrow
and pandas cannot be imported.

Every test has a deadline after which it fails instead of hanging.
"""
import importlib
import io
import json
import os
import signal
import sqlite3
import subprocess
import sys
import tarfile
import textwrap

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jrd
from ray_tpu_torch import data as trd

DEADLINE_S = 120
SUBPROCESS_TIMEOUT_S = 100
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
MODULES = {"ray_tpu": jrd, "ray_tpu_torch": trd}


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def clusters():
    """Both runtimes at once, as test_torch_runtime.py shows they can run."""
    ray_tpu.init(num_cpus=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _plain(x):
    """Rows and batches as plain Python values: an array (a tensor column's
    row in the port, a batch column) as nested lists, a numpy scalar as a
    Python one."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return _plain(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def _both(case, tmp_path):
    """`case(rd, tmp)` through each module, in its own directory."""
    out = {}
    for name, rd in MODULES.items():
        tmp = tmp_path / name
        tmp.mkdir()
        out[name] = _plain(case(rd, tmp))
    return out["ray_tpu"], out["ray_tpu_torch"]


def _sub(rd, name):
    return importlib.import_module(f"{rd.__name__}.{name}")


def _ids(rows, key="id"):
    return [r[key] for r in rows]


# ------------------------------------------------------- pipelines (test_data.py)


def _range_count_take(rd, tmp):
    ds = rd.range(100, override_num_blocks=4)
    return ds.count(), ds.take(3), ds.num_blocks()


def _map_batches_fused(rd, tmp):
    ds = (rd.range(64, override_num_blocks=4)
          .map_batches(lambda b: {"id": b["id"] * 2})
          .map_batches(lambda b: {"id": b["id"] + 1}))
    segments = _sub(rd, "_plan").optimize(ds._plan)
    return _ids(ds.take_all()), len(segments), len(segments[0].spec.transforms)


def _map_filter_flat_map(rd, tmp):
    x = np.random.RandomState(1).randint(-50, 50, 40)
    ds = rd.from_items([{"x": int(v)} for v in x], parallelism=3)
    return (ds.map(lambda r: {"x": r["x"] * 10}).take_all(),
            ds.filter(lambda r: r["x"] % 2 == 0).take_all(),
            ds.flat_map(lambda r: [{"x": r["x"]}, {"x": -r["x"]}]).take_all())


def _limits(rd, tmp):
    pushed = rd.range(1000, override_num_blocks=10).map(lambda r: {"id": r["id"]}).limit(7)

    def double(b):
        return {"id": np.repeat(b["id"], 2)}

    return (pushed.count(), _sub(rd, "_plan").optimize(pushed._plan)[0].stop_after_rows,
            rd.range(10, override_num_blocks=4).limit(5).take_all(),
            rd.range(20, override_num_blocks=2).map_batches(double).limit(5).take_all())


def _repartition(rd, tmp):
    ds = rd.range(100, override_num_blocks=7).repartition(3)
    return ds.num_blocks(), ds.count(), _ids(ds.take_all())


def _shuffle_and_sort(rd, tmp):
    x = np.random.RandomState(2).permutation(60)
    ds = rd.from_items([{"id": int(v), "f": float(v) / 7} for v in x], parallelism=4)
    shuffled = ds.random_shuffle(seed=7)
    return (shuffled.take_all(), shuffled.sort("id").take_all(),
            ds.sort("f", descending=True).take_all())


def _groupby(rd, tmp):
    rng = np.random.RandomState(3)
    rows = [{"k": int(k), "v": float(v)} for k, v in zip(rng.randint(0, 4, 50), rng.randn(50))]
    g = rd.from_items(rows, parallelism=4).groupby("k")
    return [g.sum("v").take_all(), g.count().take_all(), g.mean("v").take_all(),
            g.std("v").take_all(), g.min("v").take_all(), g.max("v").take_all(),
            g.aggregate(total="sum:v", n="count:v").take_all(),
            g.map_groups(lambda grp: {"k": grp["k"][:1], "n": np.array([len(grp["v"])])}).take_all()]


def _groupby_string_keys(rd, tmp):
    ds = rd.from_items([{"k": f"key{i % 5}", "v": 1.0} for i in range(200)], parallelism=8)
    return ds.groupby("k").count().take_all()


def _union_zip(rd, tmp):
    a = rd.range(5, override_num_blocks=1)
    b = rd.range(5, override_num_blocks=1).map(lambda r: {"id": r["id"] + 5})
    return a.union(b).take_all(), a.zip(b).take_all()


def _iter_batches(rd, tmp):
    ds = rd.range(100, override_num_blocks=5)
    return ([b["id"] for b in ds.iter_batches(batch_size=32, drop_last=False)],
            [b["id"] for b in ds.iter_batches(batch_size=32, drop_last=True)],
            [b["id"] for b in ds.iter_batches(batch_size=None)],
            [len(b["id"]) for b in ds.iter_batches(batch_size=7, prefetch_batches=3)])


def _aggregates(rd, tmp):
    f = np.random.RandomState(4).randn(30)
    ds = rd.from_items([{"id": i, "f": float(v)} for i, v in enumerate(f)], parallelism=3)
    return (ds.sum("id"), ds.min("f"), ds.max("f"), ds.mean("f"), ds.schema().names,
            ds.columns(), sorted(rd.from_items([1, 3, 1, 2, 3]).unique("item")))


def _tensors(rd, tmp):
    arr = np.random.RandomState(5).randint(0, 9, (4, 2, 3))
    return (rd.range_tensor(4, shape=(2, 2), override_num_blocks=2).take_batch(4)["item"],
            rd.from_numpy(arr).take_batch(4)["item"],
            [b["item"] for b in rd.from_numpy([arr, arr + 1]).iter_batches(batch_size=3)])


def _empty_after_filter(rd, tmp):
    ds = (rd.range(10, override_num_blocks=3).filter(lambda r: False)
          .map_batches(lambda b: {"y": b["id"] * 2}))
    return ds.count(), rd.range(10, override_num_blocks=3).filter(lambda r: False).sort("id").count()


def _columns_ops(rd, tmp):
    ds = rd.range(5).add_column("two", lambda b: b["id"] * 2)
    return (ds.take(2), ds.select_columns(["two"]).columns(), ds.drop_columns(["two"]).columns(),
            ds.rename_columns({"two": "double"}).take_all())


def _sample_and_split(rd, tmp):
    ds = rd.range(40, override_num_blocks=4)
    train, test = ds.train_test_split(0.25, shuffle=True, seed=3)
    return _ids(ds.random_sample(0.5, seed=3).take_all()), train.take_all(), test.take_all()


def _sources(rd, tmp):
    import pandas as pd

    rng = np.random.RandomState(6)
    rows = [{"a": int(a), "s": f"r{a}", "b": bytes([a % 255 + 1]), "f": float(f)}
            for a, f in zip(rng.randint(0, 1000, 12), rng.randn(12))]
    return (rd.from_items(rows, parallelism=3).take_all(),
            rd.from_numpy(rng.randn(5)).take_all(),
            rd.from_pandas(pd.DataFrame({"a": [1, 2, 3], "s": ["x", "y", "z"]})).take_all(),
            rd.from_arrow(pa.table({"a": [1, 2], "f": [0.5, 1.5]})).take_all(),
            rd.from_pandas(pd.DataFrame({"a": [4, 5]})).to_pandas()["a"].tolist())


def _split_and_streaming_split(rd, tmp):
    ds = rd.range(40, override_num_blocks=4)
    parts = [_ids(p.take_all()) for p in ds.split(2)]
    equal = [_ids(p.take_all()) for p in ds.split(3, equal=True)]
    its = ds.streaming_split(2, equal=True)
    epochs = [[[v for b in it.iter_batches(batch_size=None) for v in b["id"].tolist()]
               for it in its] for _ in range(2)]
    return parts, equal, epochs


def _streaming_split_epoch_isolation(rd, tmp):
    fast, slow = rd.range(20, override_num_blocks=2).streaming_split(2)

    def read(it):
        return [v for b in it.iter_batches(batch_size=None) for v in b["id"].tolist()]

    fast_e0 = read(fast)
    fast_e1 = read(fast)  # the fast rank starts epoch 1 before the slow one read epoch 0
    slow_e0 = read(slow)
    return sorted(fast_e0 + slow_e0), fast_e0, fast_e1, slow_e0


PIPELINES = [
    _range_count_take, _map_batches_fused, _map_filter_flat_map, _limits, _repartition,
    _shuffle_and_sort, _groupby, _groupby_string_keys, _union_zip, _iter_batches,
    _aggregates, _tensors, _empty_after_filter, _columns_ops, _sample_and_split, _sources,
    _split_and_streaming_split, _streaming_split_epoch_isolation,
]


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c.__name__.strip("_"))
def test_pipeline_matches_the_reference(clusters, case, tmp_path):
    want, got = _both(case, tmp_path)
    assert got == want


def test_pipelines_give_what_the_reference_tests_expect(clusters, tmp_path):
    """A few of tests/test_data.py's own expectations, on the port alone, so
    that the equality above is not between two wrong answers."""
    count, take, blocks = _plain(_range_count_take(trd, tmp_path))
    assert (count, take, blocks) == (100, [{"id": 0}, {"id": 1}, {"id": 2}], 4)
    ids, n_segments, n_transforms = _plain(_map_batches_fused(trd, tmp_path))
    assert ids == [2 * i + 1 for i in range(64)] and (n_segments, n_transforms) == (1, 2)
    shuffled, ordered, _ = _plain(_shuffle_and_sort(trd, tmp_path))
    assert _ids(shuffled) != list(range(60)) and _ids(ordered) == list(range(60))
    assert sorted(_ids(shuffled)) == list(range(60))
    counts = {r["k"]: r["count()"] for r in _plain(_groupby_string_keys(trd, tmp_path))}
    assert counts == {f"key{i}": 40 for i in range(5)}
    sizes = [len(b) for b in _plain(_iter_batches(trd, tmp_path))[0]]
    assert sizes == [32, 32, 32, 4]
    merged, _, fast_e1, _ = _plain(_streaming_split_epoch_isolation(trd, tmp_path))
    assert merged == list(range(20)) and len(fast_e1) == 10


# ------------------------------------------------------------------ files


def _write_read(fmt):
    def case(rd, tmp):
        x = np.random.RandomState(7).randint(-1000, 1000, 20)
        ds = rd.from_items([{"id": int(v), "sq": int(v) ** 2, "f": float(v) / 8} for v in x],
                           parallelism=2)
        d = str(tmp / fmt)
        paths = getattr(ds, f"write_{fmt}")(d)
        back = getattr(rd, f"read_{fmt}")(d)
        return [os.path.basename(p) for p in paths], sorted(back.take_all(), key=lambda r: r["id"])
    return case


def _write_read_numpy(rd, tmp):
    arr = np.random.RandomState(8).randn(12, 3)
    d = str(tmp / "npy")
    rd.from_numpy([arr[:5], arr[5:]]).write_numpy(d)
    return rd.read_numpy(d).take_batch(12)["item"]


def _write_read_tfrecords(rd, tmp):
    rows = [{"x": i, "y": float(i) / 2, "name": f"r{i}"} for i in range(8)]
    rows += [{"x": -1, "y": 0.0, "name": "n"}, {"x": -(2 ** 40), "y": -1.5, "name": ""}]
    d = str(tmp / "tfr")
    rd.from_items(rows).write_tfrecords(d)
    return sorted(rd.read_tfrecords(d).take_all(), key=lambda r: r["x"])


@pytest.mark.parametrize("case", [_write_read("parquet"), _write_read("csv"), _write_read("json"),
                                  _write_read_numpy, _write_read_tfrecords],
                         ids=["parquet", "csv", "json", "numpy", "tfrecords"])
def test_write_then_read_matches_the_reference(clusters, case, tmp_path):
    want, got = _both(case, tmp_path)
    assert got == want


# ------------------------------------------ the planner (test_data_rules.py)


def _rules_fusion_and_pushdown(rd, tmp):
    plan, rules = _sub(rd, "_plan"), _sub(rd, "_rules")
    fused = rules.OperatorFusion().apply([
        plan.MapLike("map_rows", {"fn": lambda r: r}),
        plan.MapLike("filter", {"fn": lambda r: True}),
        plan.MapLike("map_batches", {"fn": lambda b: b}),
    ])
    pushed = rules.LimitPushdown().apply([
        plan.MapLike("filter", {"fn": lambda r: True}),
        plan.MapLike("map_rows", {"fn": lambda r: r}), plan.Limit(5)])
    return ([type(o).__name__ for o in fused], fused[0].name,
            [o.kind if isinstance(o, plan.MapLike) else type(o).__name__ for o in pushed])


def _rules_column_pruning(rd, tmp):
    rules, source = _sub(rd, "_rules"), _sub(rd, "datasource")
    path = str(tmp / "t.parquet")
    pq.write_table(pa.table({"a": [1, 2], "b": [3, 4], "c": [5, 6]}), path)
    ds = rd.read_parquet(path).select_columns(["a", "b"])
    out = rules.apply_rules(list(ds._plan.ops), [rules.ColumnPruningPushdown()])
    behind_filter = rd.read_parquet(path).filter(lambda r: r["b"] > 0).select_columns(["a"])
    kept = rules.apply_rules(list(behind_filter._plan.ops), [rules.ColumnPruningPushdown()])
    narrow = source.ParquetDatasource(path, columns=["a"])
    return (len(out), out[0].datasource._columns, ds._plan.ops[0].datasource._columns,
            len(kept), narrow.prune_columns(["a", "b"]), narrow.prune_columns(["a"]),
            ds.take_all(), rd.read_parquet(path).select_columns(["c", "a"]).take_all())


def _lance(rd, tmp):
    source, rules = _sub(rd, "datasource"), _sub(rd, "_rules")
    uri = str(tmp / "ds.lance")
    v1 = source.write_lance_dataset(
        uri, {"id": list(range(10)), "text": [f"row{i}" for i in range(10)]},
        max_rows_per_fragment=4)
    v2 = source.write_lance_dataset(uri, {"id": [10], "text": ["c"]})
    errors = []
    for bad in ({"other": [1]}, {"id": ["x"], "text": ["c"]}):
        with pytest.raises(ValueError):
            source.write_lance_dataset(uri, bad)
        errors.append("ValueError")
    pushed = rules.apply_rules(list(rd.read_lance(uri).select_columns(["text"])._plan.ops),
                               [rules.ColumnPruningPushdown()])
    return (v1, v2, len(source.LanceDatasource(uri, version=1).get_read_tasks(8)),
            sorted(rd.read_lance(uri).take_all(), key=lambda r: r["id"]),
            sorted(rd.read_lance(uri, version=1, columns=["id"]).take_all(), key=lambda r: r["id"]),
            pushed[0].datasource._columns, errors)


class _FakeCursor:
    def __init__(self, docs):
        self._docs = docs

    def sort(self, key):
        return _FakeCursor(sorted(self._docs, key=lambda d: d[key]))

    def skip(self, n):
        return _FakeCursor(self._docs[n:])

    def limit(self, n):
        return _FakeCursor(self._docs[:n])

    def __iter__(self):
        return iter(self._docs)


class _FakeCollection:
    """The pymongo Collection surface MongoDatasource drives (as in
    tests/test_data_rules.py)."""

    def __init__(self, docs):
        self._docs = docs

    @staticmethod
    def _match(doc, flt):
        for k, cond in flt.items():
            if isinstance(cond, dict):
                if "$gte" in cond and not doc[k] >= cond["$gte"]:
                    return False
                if "$lt" in cond and not doc[k] < cond["$lt"]:
                    return False
            elif doc.get(k) != cond:
                return False
        return True

    def count_documents(self, flt):
        return sum(1 for d in self._docs if self._match(d, flt))

    def find(self, flt, projection=None):
        docs = [d for d in self._docs if self._match(d, flt)]
        if projection:
            include = {k for k, v in projection.items() if v}
            exclude = {k for k, v in projection.items() if not v}
            docs = [{k: v for k, v in d.items()
                     if (not include or k in include) and k not in exclude}
                    | ({"_id": d["_id"]} if "_id" not in exclude and include else {})
                    for d in docs]
        return _FakeCursor(docs)


def _mongo(rd, tmp):
    coll = _FakeCollection([{"_id": i, "x": i * i, "tag": "even" if i % 2 == 0 else "odd"}
                            for i in range(20)])
    source = _sub(rd, "datasource")
    return (len(source.MongoDatasource(lambda: coll).get_read_tasks(4)),
            sorted(rd.read_mongo(lambda: coll, parallelism=4).take_all(), key=lambda r: r["_id"]),
            rd.read_mongo(lambda: coll, filter={"tag": "even"}, projection=["x"],
                          parallelism=2).take_all(),
            rd.read_mongo(lambda: coll).select_columns(["tag"]).take_all())


@pytest.mark.parametrize("case", [_rules_fusion_and_pushdown, _rules_column_pruning, _lance, _mongo],
                         ids=lambda c: c.__name__.strip("_"))
def test_planner_and_sources_match_the_reference(clusters, case, tmp_path):
    want, got = _both(case, tmp_path)
    assert got == want


# ------------------------------- resources and sources (test_data_resources.py)

ROW_BYTES = 8 * 1024
ROWS_PER_BLOCK = 16


@pytest.mark.parametrize("runtime", sorted(RUNTIMES))
def test_memory_budget_bounds_the_peak(clusters, runtime):
    """The copied resource manager holds the port's executor to its budget
    as it holds the reference's; the peak counts each block's bytes (the
    blobs are object arrays in the port, arrow binary in the reference)."""
    rd = MODULES[runtime]
    executor, plan = _sub(rd, "_executor"), _sub(rd, "_plan")
    ds = rd.range(24 * ROWS_PER_BLOCK, parallelism=24).map_batches(
        lambda b: {"blob": [b"x" * ROW_BYTES for _ in b["id"]]}, batch_size=None)
    budget = 6 * ROWS_PER_BLOCK * ROW_BYTES
    peaks = []
    for kw in ({"max_in_flight": 16}, {"max_in_flight": 16, "memory_budget_bytes": budget}):
        ex = executor.StreamingExecutor(**kw)
        assert sum(m.num_rows for _, m in ex.execute(plan.optimize(ds._plan))) == 24 * ROWS_PER_BLOCK
        peaks.append(ex.resource_manager.peak_bytes)
    assert peaks[0] > budget * 1.5, peaks
    assert peaks[1] <= budget + 2 * ROWS_PER_BLOCK * ROW_BYTES, peaks


@pytest.mark.parametrize("runtime", sorted(RUNTIMES))
def test_an_op_runs_one_task_until_its_first_output_size_is_known(runtime):
    """The departure behind the bound above, pinned: under a budget the
    reference admits a second task on the input's size alone; the port
    waits for the first task's output, since a map that grows its blocks
    (8 KiB rows from 8-byte ids above) would otherwise overshoot the budget
    by every block that completes out of order."""
    manager = _sub(MODULES[runtime], "_resource_manager").ResourceManager(
        6 * ROWS_PER_BLOCK * ROW_BYTES, 1)
    guess = manager.estimate_output(0, 128.0)
    assert manager.can_launch(0, guess)
    manager.on_launch(0, guess)
    assert manager.can_launch(0, guess) == (runtime == "ray_tpu")
    manager.on_task_done(0, guess, float(ROWS_PER_BLOCK * ROW_BYTES))
    assert manager.can_launch(0, manager.estimate_output(0, 128.0))


def test_memory_budget_env_is_the_ports_own(clusters, monkeypatch):
    """A budget so tight that only the progress guarantee advances: the
    port reads RAY_TPU_TORCH_DATA_MEMORY_BUDGET, not the reference's name,
    and still yields every row in order."""
    executor = _sub(trd, "_executor")
    monkeypatch.setenv("RAY_TPU_DATA_MEMORY_BUDGET", "1")
    assert executor.StreamingExecutor().memory_budget_bytes is None
    monkeypatch.setenv("RAY_TPU_TORCH_DATA_MEMORY_BUDGET", "1")
    assert executor.StreamingExecutor().memory_budget_bytes == 1
    out = _ids(trd.range(200, parallelism=10).map(lambda r: {"v": r["id"] * 2}).iter_rows(), "v")
    assert out == [i * 2 for i in range(200)]


def _images(rd, tmp):
    from PIL import Image

    for i in range(4):
        Image.fromarray(np.full((8, 6, 3), i * 10, dtype=np.uint8)).save(tmp / f"img_{i}.png")
    Image.fromarray(np.ones((4, 2, 3), np.uint8)).save(tmp / "B.PNG")
    resized = sorted(rd.read_images(str(tmp), size=(4, 3), mode="RGB").take_all(),
                     key=lambda r: r["path"])
    mixed = sorted(rd.read_images(str(tmp), parallelism=1).take_all(), key=lambda r: r["path"])
    return ([(os.path.basename(r["path"]), np.asarray(r["image"])) for r in resized],
            [np.asarray(r["image"]).shape for r in mixed])


def _sql(rd, tmp):
    db = str(tmp / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE kv (k INTEGER, v TEXT, f REAL)")
    conn.executemany("INSERT INTO kv VALUES (?, ?, ?)",
                     [(i, f"row{i}", i / 3) for i in range(230)])
    conn.commit()
    conn.close()
    q = "SELECT k, v, f FROM kv ORDER BY k"
    return (rd.read_sql(q, lambda: sqlite3.connect(db)).take_all(),
            sorted(rd.read_sql(q, lambda: sqlite3.connect(db), shard_rows=50,
                               parallelism=4).take_all(), key=lambda r: r["k"]))


def _webdataset(rd, tmp):
    shard = tmp / "shard-0000.tar"
    with tarfile.open(shard, "w") as tf:
        for name, payload in (("0000.jpg", b"a"), ("0001.jpg", b"JPEG\x01"), ("0001.cls", b"7"),
                              ("0002.jpg", b""), ("0002.cls", b"2")):
            info = tarfile.TarInfo(name=name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    ds = rd.read_webdataset(str(shard))
    decoded = ds.filter(lambda r: r["cls"] is not None).map(
        lambda r: {"label": int(r["cls"].decode())})
    return sorted(ds.take_all(), key=lambda r: r["__key__"]), sorted(_ids(decoded.take_all(), "label"))


def _binary(rd, tmp):
    for i in range(3):
        (tmp / f"f{i}.bin").write_bytes(bytes(range(i, i + 5)) + b"\x00")
    return sorted(((os.path.basename(r["path"]), r["bytes"]) for r in
                   rd.read_binary_files(str(tmp)).take_all()))


@pytest.mark.parametrize("case", [_images, _sql, _webdataset, _binary],
                         ids=lambda c: c.__name__.strip("_"))
def test_sources_match_the_reference(clusters, case, tmp_path):
    want, got = _both(case, tmp_path)
    assert got == want


# ------------------------------------------------------------ the device edge


def _rows_of_ids(seed=0, rows=12, seq=16):
    x = np.random.RandomState(seed).randint(0, 512, (rows, seq))
    return [x[:5], x[5:]]


STORED = {"ids": torch.int64, "targets": torch.int64, "w": torch.float64}


def _with_targets(b):
    return {"ids": b["item"], "targets": np.roll(b["item"], -1, axis=1),
            "w": b["item"].astype(np.float64) / 3}


@pytest.mark.parametrize("dtypes", [None, torch.float32, {"ids": torch.int32}],
                         ids=["as-stored", "one-dtype", "per-column"])
def test_iter_torch_batches_equal_iter_jax_batches(clusters, dtypes):
    want = [{k: np.asarray(v) for k, v in b.items()} for b in
            jrd.from_numpy(_rows_of_ids()).map_batches(_with_targets)
            .iter_jax_batches(batch_size=4)]
    got = list(trd.from_numpy(_rows_of_ids()).map_batches(_with_targets)
               .iter_torch_batches(batch_size=4, device="cpu", dtypes=dtypes))
    assert len(got) == len(want) == 3  # 12 rows, drop_last
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["ids", "targets", "w"]
        for k, t in g.items():
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            asked = dtypes.get(k) if isinstance(dtypes, dict) else dtypes
            assert t.dtype == (asked or STORED[k]), (k, t.dtype)
            # jax holds 32 bits here (x64 off): the port's values in jax's
            # dtype are jax's, bit for bit.
            np.testing.assert_array_equal(t.numpy().astype(w[k].dtype), w[k])


def test_iter_torch_batches_through_a_streaming_split(clusters):
    """Each split's iterator travels to an actor, as a Train worker gets
    its shard, and yields its rows there as tensors. (Consumers that are
    tasks would hold the CPUs that the split's read tasks wait for.)"""
    @ray_tpu_torch.remote
    class Consumer:
        def consume(self, it):
            import torch

            got = [b["id"] for b in it.iter_torch_batches(batch_size=5, device="cpu",
                                                           drop_last=False)]
            return torch.cat(got), sorted({str(t.dtype) for t in got})

    its = trd.range(40, override_num_blocks=4).streaming_split(2)
    consumers = [Consumer.remote() for _ in its]
    got = ray_tpu_torch.get([c.consume.remote(it) for c, it in zip(consumers, its)], timeout=60)
    for c in consumers:
        ray_tpu_torch.kill(c)
    assert sorted(torch.cat([ids for ids, _ in got]).tolist()) == list(range(40))
    assert all(len(ids) == 20 and dtypes == ["torch.int64"] for ids, dtypes in got)


def test_to_device_needs_a_card_unless_asked_for_the_cpu():
    to_device = _sub(trd, "iterator").to_device
    batch = {"ids": np.arange(6).reshape(2, 3)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            to_device(batch)
    out = to_device(batch, device="cpu")
    assert torch.equal(out["ids"], torch.arange(6).view(2, 3))
    out["ids"] += 1  # a private copy, even of a read-only block
    assert batch["ids"][0, 0] == 0
    x = np.random.RandomState(11).randn(3, 5)
    got = to_device({"x": x}, device="cpu", dtypes=torch.bfloat16)["x"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, torch.from_numpy(x).to(torch.bfloat16))
    got = to_device({"x": x}, device="cpu", dtypes={"x": torch.int32})["x"]
    assert torch.equal(got, torch.from_numpy(x).to(torch.int32))
    with pytest.raises(TypeError, match="'s'"):
        to_device({"s": np.array(["a", "b"], dtype=object)}, device="cpu")


@pytest.mark.parametrize("rank", range(4))
def test_sharding_cuts_each_column_as_shard_batch(rank):
    """With a mesh, each [B, T] column lands as `parallel.step.shard_batch`
    cuts it: rows over data x fsdp, the sequence over seq (a fake process
    group of 4, data 2 x seq 2)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.step import shard_batch

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
    try:
        mesh = MeshSpec(data=2, seq=2).build("cpu")
        ids = np.random.RandomState(9).randint(0, 512, (4, 8))
        batch = {"ids": ids, "targets": np.roll(ids, -1, axis=1)}
        out = _sub(trd, "iterator").to_device(batch, device="cpu", sharding=mesh)
        want = shard_batch(torch.from_numpy(batch["ids"]), torch.from_numpy(batch["targets"]), mesh)
        assert torch.equal(out["ids"], want[0]) and torch.equal(out["targets"], want[1])
        assert out["ids"].shape == (2, 4)
        with pytest.raises(ValueError):
            _sub(trd, "iterator").to_device({"id": np.arange(4)}, device="cpu", sharding=mesh)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ numpy blocks against arrow


def test_public_names_are_the_references():
    assert trd.__all__ == jrd.__all__
    for cls in ("Dataset", "DataIterator"):
        assert hasattr(getattr(trd, cls), "iter_torch_batches")
        assert not hasattr(getattr(trd, cls), "iter_jax_batches")


def test_schema_holds_numpy_dtypes_and_row_shapes(clusters):
    """The reference's schema holds arrow types; the port's numpy dtypes
    and per-row shapes (strings and bytes as object)."""
    def make(rd):
        return rd.from_items([{"i": 1, "f": 0.5, "s": "a", "b": b"x", "t": [[1, 2], [3, 4]]}])

    ref = make(jrd).schema()
    port = make(trd).schema()
    assert port.names == ref.names == ["i", "f", "s", "b", "t"]
    assert [str(t) for t in ref.types] == [
        "int64", "double", "string", "binary",
        "fixed_size_list<item: fixed_size_list<item: int64>[2]>[2]"]
    assert port.types == [np.dtype("int64"), np.dtype("float64"), np.dtype(object),
                          np.dtype(object), np.dtype("int64")]
    assert port.shapes == [(), (), (), (), (2, 2)]


def test_nulls_nested_and_tensor_rows_diverge_as_pinned(clusters, tmp_path):
    """Rows agree, types differ: an integer column with a null is arrow
    int64 in the reference and an object column of ints and None in the
    port; ragged lists are arrow list<int64> and an object column of
    lists; a tensor column's row is a nested list in the reference and an
    array in the port."""
    def case(rd, tmp):
        nulls = rd.from_items([{"a": 1}, {"a": None}, {"a": 3}], parallelism=1)
        ragged = rd.from_items([{"a": [1, 2]}, {"a": [3]}], parallelism=1)
        return nulls.take_all(), ragged.take_all(), nulls.schema().types, ragged.schema().types

    want, got = _both(case, tmp_path)
    assert got[:2] == want[:2]
    assert [str(t) for t in want[2] + want[3]] == ["int64", "list<item: int64>"]
    assert got[2] + got[3] == [np.dtype(object), np.dtype(object)]
    ref_row = jrd.range_tensor(2, shape=(2,)).take(1)[0]["item"]
    port_row = trd.range_tensor(2, shape=(2,)).take(1)[0]["item"]
    assert ref_row == [0, 0] and isinstance(port_row, np.ndarray) and port_row.tolist() == [0, 0]


def test_to_arrow_round_trips_the_numpy_block():
    """`to_arrow` gives the table the reference builds from the same data
    (tensor columns as nested fixed-size lists), and back again."""
    block_mod, ref_block_mod = _sub(trd, "block"), _sub(jrd, "block")
    rng = np.random.RandomState(10)
    data = {"ids": rng.randint(0, 9, (3, 4)), "t": rng.randn(3, 2, 2),
            "f": rng.randn(3), "s": ["a", "bb", ""], "b": [b"\x01", b"xy", b""]}
    block = block_mod.build_block(data)
    table = block_mod.BlockAccessor(block).to_arrow()
    assert table.equals(ref_block_mod.build_block(data))
    back = block_mod.build_block(table)
    assert list(back) == list(block)
    for k in block:
        assert back[k].dtype == block[k].dtype and back[k].shape == block[k].shape
        assert back[k].tolist() == block[k].tolist()
    assert _plain(block_mod.BlockAccessor(block).to_pandas()["f"].tolist()) == block["f"].tolist()


# ----------------------------------------------- the card's path, without arrow

_NO_ARROW = textwrap.dedent("""
    import json, sys
    sys.modules["pyarrow"] = None
    sys.modules["pandas"] = None
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd, train
    from ray_tpu_torch.util import collective as col

    STEPS, BATCH, SEQ = 3, 2, 32
    out = {}
    rt.init(num_cpus=2)
    try:
        ids = np.random.RandomState(0).randint(0, 512, (BATCH, SEQ))
        ds = rd.from_numpy([ids] * STEPS).map_batches(
            lambda b: {"ids": b["item"], "targets": np.roll(b["item"], -1, axis=1)})

        def loop(config):
            import torch
            from ray_tpu_torch import train
            from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

            torch.set_num_threads(1)
            model = LlamaForCausalLM(CONFIGS["llama-tiny"], device="cpu")
            opt = train.make_optimizer(model)
            for b in config["__datasets__"]["train"].iter_torch_batches(
                    batch_size=BATCH, device="cpu", dtypes=torch.long):
                loss = train.train_step(model, opt, b["ids"], b["targets"])
                train.report({"loss": float(loss), "same": bool(
                    torch.equal(b["ids"], torch.from_numpy(config["ids"])))})

        result = train.TorchTrainer(
            loop, train_loop_config={"ids": ids},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(storage_path=sys.argv[1]),
            datasets={"train": ds}).fit()
        out["error"] = None if result.error is None else str(result.error)
        out["losses"] = [m["loss"] for m in result.metrics_history]
        out["same"] = [m["same"] for m in result.metrics_history]

        @rt.remote
        class Member:
            def reduce(self, rank):
                from ray_tpu_torch.util import collective as col

                col.init_collective_group(2, rank, group_name="noarrow")
                x = torch.full((4,), float(rank + 1), dtype=torch.bfloat16)
                return col.allreduce(x, group_name="noarrow").tolist()

        members = [Member.remote() for _ in range(2)]
        out["allreduce"] = rt.get([m.reduce.remote(r) for r, m in enumerate(members)],
                                  timeout=60)
        block = rd.BlockAccessor.for_block({"a": np.arange(3)})
        for name in ("to_arrow", "to_pandas"):
            try:
                getattr(block, name)()
                out[name] = "no error"
            except ImportError as e:
                out[name] = str(e)
    finally:
        rt.shutdown()
    out["modules"] = sorted(m for m in ("pyarrow", "pandas", "jax", "ray_tpu")
                            if sys.modules.get(m) is not None)
    print(json.dumps(out))
""")


def test_the_cards_path_needs_neither_pyarrow_nor_pandas(tmp_path):
    """Phase 19's pipeline at llama-tiny, and a bf16 allreduce, in a
    subprocess whose main process has both packages blocked in `sys.modules` and
    whose workers (started with a PYTHONPATH that shadows both with
    packages that raise ImportError) cannot import them either."""
    shadow = tmp_path / "shadow"
    for name in ("pyarrow", "pandas"):
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(f"raise ImportError('{name} is blocked')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(shadow), repo]))
    proc = subprocess.run([sys.executable, "-c", _NO_ARROW, str(tmp_path / "results")],
                          capture_output=True, text=True, env=env, cwd=str(tmp_path),
                          timeout=SUBPROCESS_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["error"] is None
    assert len(out["losses"]) == 3 and all(out["same"])
    assert out["losses"][-1] < out["losses"][0]
    assert out["allreduce"] == [[3.0] * 4] * 2
    assert "pyarrow" in out["to_arrow"] and "pandas" in out["to_pandas"]
    assert out["modules"] == []


def test_trailing_nul_bytes_the_reference_drops_and_the_port_keeps(clusters, tmp_path):
    """The reference builds a bytes column from Python values through
    numpy's fixed-width "S" dtype and arrow, which cut each value at its
    first NUL byte; the port keeps bytes as objects."""
    rows = [{"b": b"a\x00"}, {"b": b"\x00"}, {"b": b"x\x00y"}, {"b": b"c"}]

    def case(rd, tmp):
        return rd.from_items(rows, parallelism=1).take_all()

    want, got = _both(case, tmp_path)
    assert want == [{"b": b"a"}, {"b": b""}, {"b": b"x"}, {"b": b"c"}]
    assert got == rows
