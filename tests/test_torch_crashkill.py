"""The port's crash-kill sweep (``repro_torch.reliability.crashkill``) on the CPU.

Spawns a real victim interpreter (``python -m
repro_torch.reliability._victim SCENARIO WORKDIR cpu``) per enumerated crash
point, SIGKILLs it there, and asserts the durability invariants over the
remains: the shard store's rename-aside rewrite, the checkpoint's publish and
the atomic sink each leave a byte-exact old or new version at every site.
The port's record runs enumerate the reference's sites, and its scenario
content is the reference's.  The sweep runs once for the module, at most
four victims at a time.
"""
import json
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.reliability import crashkill as ref_ck  # noqa: E402
from repro_torch.reliability import crashkill as ck  # noqa: E402

CPU = "cpu"
SITES = {"shard_rewrite": 19, "checkpoint": 18, "atomic_sink": 25}
WINDOWS = {
    "shard_rewrite": {"shard.aside.before", "shard.aside.after", "shard.swap.after"},
    "checkpoint": {"ckpt.leaf", "ckpt.manifest", "ckpt.publish.after"},
    "atomic_sink": {"io.sink.write", "io.src.read", "sink.replace.before",
                    "sink.replace.after"},
}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    base = tmp_path_factory.mktemp("sweep")
    t0 = time.perf_counter()
    summary = ck.kill_sweep(base, device=CPU, max_workers=4)
    print(f"port kill sweep: {summary} seconds={time.perf_counter() - t0}")
    return base, summary


def test_sweep_leaves_a_consistent_version_at_every_site(sweep):
    _base, summary = sweep
    assert summary["total_sites"] == sum(SITES.values())
    for name in ck.SCENARIOS:
        info = summary["scenarios"][name]
        assert info["sites"] == SITES[name]
        # every kill run left a byte-exact version behind, and both occur
        assert sum(info["survivor_versions"].values()) == info["sites"]
        assert set(info["survivor_versions"]) == {0, 1}


@pytest.mark.parametrize("scenario", ck.SCENARIOS)
def test_record_run_enumerates_the_references_sites(sweep, tmp_path, scenario):
    base, _summary = sweep
    port = [(n, int(o)) for n, o in json.loads(
        (base / scenario / "record" / ck.SITES_FILE).read_text())]
    assert port == ref_ck.enumerate_sites(scenario, tmp_path / "ref")
    assert len(port) == SITES[scenario]
    # the windows where torn state is most likely are each a kill site
    assert WINDOWS[scenario] <= {n for n, _ in port}


def test_scenario_content_is_the_references():
    for version in (0, 1):
        for mine, theirs in ((ck.shard_arrays(version), ref_ck.shard_arrays(version)),
                             (ck.ckpt_tree(version), ref_ck.ckpt_tree(version))):
            assert list(mine) == list(theirs)
            assert all(np.array_equal(mine[k].numpy(), theirs[k])
                       and mine[k].numpy().dtype == theirs[k].dtype for k in mine)
        assert ck.sink_payload(version) == ref_ck.sink_payload(version)


@pytest.mark.parametrize("scenario,point,occ,survivor", [
    ("atomic_sink", "io.sink.write", 1, 0),
    ("checkpoint", "ckpt.publish.after", 1, 1),
])
def test_single_kill_is_a_real_sigkill(tmp_path, scenario, point, occ, survivor):
    rc = ck.run_kill(scenario, tmp_path / "k", point, occ, CPU)
    assert rc == -signal.SIGKILL
    verdict = ck.check_invariants(scenario, tmp_path / "k", CPU)
    assert verdict["version"] == survivor


def test_victim_refuses_bad_arguments(tmp_path):
    from repro_torch.reliability import _victim

    assert _victim.main(["checkpoint"]) == 2
    with pytest.raises(SystemExit):
        ck.run_victim("no_such_scenario", tmp_path, CPU)
