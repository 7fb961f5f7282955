"""The reference yardstick for the port's trainer tests (test side only).

``ref_device_trainer`` makes the JAX package's trainer encode its candidates
and its clustering probes on ``backend="device"``, whose frames the port's
equal, by patching two names the trainer looks up at call time
(``repro.training.trainer.CompressorSession`` and
``repro.training.cluster.compress``) for the length of one ``with`` block.
Nothing in the JAX package changes; ``clear_caches`` empties both packages'
resolve caches, so a pair of runs starts from the same cache state.
"""
import contextlib
import functools

import pytest

from repro.core import engine as ref_engine
from repro.training import cluster as ref_cluster
from repro.training import trainer as ref_trainer

import repro_torch


class DeviceSession(ref_engine.CompressorSession):
    """The reference's session with ``backend="device"`` by default."""

    def __init__(self, plan, **kw):
        kw.setdefault("backend", "device")
        super().__init__(plan, **kw)


def clear_caches() -> None:
    ref_engine.resolve_cache_clear()
    repro_torch.resolve_cache_clear()


@contextlib.contextmanager
def ref_device_trainer():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_trainer, "CompressorSession", DeviceSession)
        mp.setattr(ref_cluster, "compress", functools.partial(ref_engine.compress, backend="device"))
        clear_caches()
        yield


def genome_tree(g):
    """A genome of either package as nested tuples: codec, params, children."""
    if g is None:
        return None
    return (g.codec, sorted(g.params.items()), [genome_tree(c) for c in g.children])
