"""Experimental utilities (reference: python/ray/experimental/)."""
