"""The port's codec and selector signatures and its plan type-checker
(``repro_torch.analysis``) against the reference's (``repro.analysis``).

Every case runs the same inputs through both packages, on the CPU, tolerance
0: the signatures as data and their transfer functions over every input tuple
of atoms from stype {0, 1, 2, 3} x width {None, 1, 2, 3, 4, 8, 16};
``check_plan``'s report and edge types on the golden, ill-typed and profile
plans and on 500 seeded random plans (serialized by the reference, read by the
port); ``annotate_resolved_nodes`` on the golden frames and a fused frame; the
reference's signature/encode probe on the port's encoders (a refused atom is a
``ValueError`` raised before any kernel wrapper is called); the resolve check
(``set_resolve_check``) refusing before any encoder runs, seen through a
recording ``FaultPlan``; the registry's fail-closed check; ``lint`` and
``serve --register`` on the command line.
"""
import io
import itertools
import json
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_analysis import CONCRETE_ATOMS, _params_for, _sample  # noqa: E402

import repro_torch  # noqa: E402
from repro import analysis as RA  # noqa: E402
from repro import cli as ref_cli  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import numeric as ref_numeric  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core import strings as ref_strings  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro.core.codec import all_codecs as ref_codecs  # noqa: E402
from repro.core.graph import GraphBuilder as RefBuilder  # noqa: E402
from repro.core.graph import Plan as RefPlan  # noqa: E402
from repro.core.graph import PlanNode as RefNode  # noqa: E402
from repro.core.message import serial as ref_serial  # noqa: E402
from repro.core.selector import all_selectors as ref_selectors  # noqa: E402
from repro.core.serialize import deserialize_plan as ref_deserialize  # noqa: E402
from repro.core.serialize import serialize_plan as ref_serialize  # noqa: E402
from repro.service.registry import PlanRegistry as RefRegistry  # noqa: E402
from repro_torch import analysis as PA  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.core import set_resolve_check  # noqa: E402
from repro_torch.core import wire  # noqa: E402
from repro_torch.core.codec import all_codecs  # noqa: E402
from repro_torch.core.graph import KIND_CODEC, KIND_SELECTOR, GraphBuilder, Plan, PlanNode  # noqa: E402
from repro_torch.core.message import Stream, SType, from_numpy, serial  # noqa: E402
from repro_torch.core.selector import all_selectors  # noqa: E402
from repro_torch.core.serialize import deserialize_plan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.reliability import FaultPlan  # noqa: E402
from repro_torch.service import CompressionServer, PlanRegistry  # noqa: E402
from repro_torch.service import protocol as SP  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
ILLTYPED = REPO / "tests" / "illtyped"
MANIFEST = json.loads((ILLTYPED / "manifest.json").read_text())
ILL = sorted(MANIFEST)
GOLDEN_PLANS = sorted(p.name for p in GOLDEN.glob("*.ozp"))
GOLDEN_FRAMES = sorted(p.name for p in GOLDEN.glob("*.ozl"))
CODECS = sorted(all_codecs())
SELECTORS = sorted(all_selectors())
SINGLE = sorted(n for n, s in all_codecs().items() if s.n_inputs == 1)
ENUM_ATOMS = [(st, w) for st in (0, 1, 2, 3) for w in (None, 1, 2, 3, 4, 8, 16)]
PROFILE_SPECS = ["bfloat16", "float32", "float64", "generic", "graph", "numeric", "sao",
                 "text", "struct:2,4", "csv:3", "graph:bin:4"]
RANDOM_PLANS, RANDOM_BATCH = 500, 10
UNKNOWN_NAMES = ("no_such_codec", "delta2", "auto")


@pytest.fixture(autouse=True)
def _fresh_caches():
    ref_engine.resolve_cache_clear()
    repro_torch.resolve_cache_clear()
    yield
    set_resolve_check(False)
    ref_engine.set_resolve_check(False)


def _port_stream(s) -> Stream:
    """A reference stream's bytes and type as a port CPU stream."""
    if s.lengths is not None:
        return Stream(torch.from_numpy(s.data.copy()), SType.STRING, 1, s.lengths)
    return from_numpy(s.data, SType(int(s.stype)), s.width)


def _report(r) -> tuple:
    return r.to_dict(), {e: sorted(a, key=repr) for e, a in r.edge_types.items()}


def _outcome(fn):
    """``fn()``'s value, or the type and text of what it raised."""
    try:
        return "ok", fn()
    except Exception as err:  # noqa: BLE001 - both packages must agree
        return type(err).__name__, str(err)


# ----------------------------------------------------------- (a) coverage
@pytest.mark.parametrize("name", CODECS)
def test_every_codec_declares_a_signature_that_covers_its_arity(name):
    spec = all_codecs()[name]
    assert spec.sig is not None, f"{name} has no stream-type signature"
    assert spec.sig.inputs or spec.n_inputs == 0
    if spec.n_inputs > 1:
        assert len(spec.sig.inputs) in (1, spec.n_inputs)


@pytest.mark.parametrize("name", SELECTORS)
def test_every_selector_declares_the_references_signature(name):
    sig, ref = all_selectors()[name].sig, ref_selectors()[name]
    assert sig is not None, f"{name} has no signature"
    assert len(sig.inputs) in (1, ref.n_inputs)
    assert [(p.stypes, p.widths) for p in sig.inputs] == [
        (p.stypes, p.widths) for p in ref.sig.inputs]


def test_the_registries_name_the_same_codecs_and_selectors():
    assert CODECS == sorted(ref_codecs()) and SELECTORS == sorted(ref_selectors())
    assert {n: s.codec_id for n, s in all_codecs().items()} == {
        n: s.codec_id for n, s in ref_codecs().items()}


# -------------------------------------------- (b) signatures equal as data
class _N:
    n_elts = 16


def _param_samples(name, sig):
    out = [{}]
    for atom in CONCRETE_ATOMS:
        p = _params_for(name, _N, atom)
        if p not in out:
            out.append(p)
    for ps in sig.params:
        for c in ps.choices or ():
            if {ps.name: c} not in out:
                out.append({ps.name: c})
    return out


@pytest.mark.parametrize("name", CODECS)
def test_signature_equals_the_references(name):
    spec, ref = all_codecs()[name], ref_codecs()[name]
    sig, rsig = spec.sig, ref.sig
    assert [(p.stypes, p.widths) for p in sig.inputs] == [
        (p.stypes, p.widths) for p in rsig.inputs]
    fields = ("name", "kind", "required", "choices", "doc")
    assert [tuple(getattr(p, f) for f in fields) for p in sig.params] == [
        tuple(getattr(p, f) for f in fields) for p in rsig.params]
    assert (sig.expansion, sig.packed_outputs) == (rsig.expansion, rsig.packed_outputs)
    assert (spec.n_inputs, spec.n_outputs, spec.min_version) == (
        ref.n_inputs, ref.n_outputs, ref.min_version)
    arities = [spec.n_inputs] if spec.n_inputs >= 0 else [1, 2, 3]
    n_outs = [spec.n_outputs] if spec.n_outputs >= 0 else [1, 2, 3]
    cases = 0
    for params in _param_samples(name, rsig):
        for k in arities:
            for atoms in itertools.product(ENUM_ATOMS, repeat=k):
                for n_out in n_outs:
                    got = _outcome(lambda: sig.transfer(atoms, params, n_out))
                    want = _outcome(lambda: rsig.transfer(atoms, params, n_out))
                    assert got == want, (name, atoms, params, n_out)
                    cases += 1
    assert cases >= len(ENUM_ATOMS)


# ------------------------------------------------ (c) check_plan reports
def _both_blob(blob: bytes):
    """check_plan's report in each package on one plan file's bytes."""
    rplan, rmeta = ref_deserialize(blob)
    plan, meta = deserialize_plan(blob)
    assert meta == rmeta
    fv = meta.get("format_version")
    return (_report(PA.check_plan(plan, format_version=fv)),
            _report(RA.check_plan(rplan, format_version=fv)))


@pytest.mark.parametrize("fname", GOLDEN_PLANS)
def test_golden_plan_checks_as_in_the_reference(fname):
    got, want = _both_blob((GOLDEN / fname).read_bytes())
    assert got == want and got[0]["ok"]


@pytest.mark.parametrize("fname", ILL)
def test_illtyped_plan_checks_as_in_the_reference(fname):
    got, want = _both_blob((ILLTYPED / fname).read_bytes())
    assert got == want and not got[0]["ok"]
    assert MANIFEST[fname]["expect"] in {d["code"] for d in got[0]["diagnostics"]}


@pytest.mark.parametrize("spec", PROFILE_SPECS)
def test_profile_checks_as_in_the_reference(spec):
    from repro.codecs.profiles import resolve_profile_spec as ref_spec

    got = _report(PA.check_plan(repro_torch.resolve_profile_spec(spec)))
    want = _report(RA.check_plan(ref_spec(spec)))
    assert got == want and got[0]["ok"]


_NAMES = sorted(ref_codecs()) + sorted(ref_selectors()) + list(UNKNOWN_NAMES)


def _random_params(rng, sig, n_out):
    out = {}
    for ps in getattr(sig, "params", ()):
        if rng.random() < 0.4:
            continue
        if ps.choices and rng.random() < 0.8:
            out[ps.name] = rng.choice(ps.choices)
        elif ps.kind == "int":
            out[ps.name] = rng.randint(-1, 9)
        elif ps.kind == "int_list":
            k = n_out if rng.random() < 0.7 else rng.randint(0, 4)
            out[ps.name] = [rng.randint(-1, 5) for _ in range(k)]
        elif ps.kind == "str":
            out[ps.name] = rng.choice([",", "\t", ";", "auto", "::"])
        else:
            out[ps.name] = rng.random()
    return out


def _random_plan(seed: int):
    """A seeded random plan of the reference's vocabulary, unvalidated: codec
    and selector names (unknown ones among them), random wiring (mostly
    unconsumed edges, sometimes consumed or undefined ones), random output
    counts and params drawn from each ``ParamSpec``."""
    rng = random.Random(seed)
    n_inputs = rng.choice((1, 1, 1, 2, 3))
    edges, consumed, nodes = list(range(n_inputs)), set(), []
    for _ in range(rng.randint(1, 6)):
        name = rng.choice(_NAMES)
        is_sel = name in ref_selectors() or (name in UNKNOWN_NAMES and rng.random() < 0.3)
        spec = ref_selectors().get(name) if is_sel else ref_codecs().get(name)
        arity = getattr(spec, "n_inputs", 1)
        if arity < 0:
            arity = rng.randint(1, 3)
        free = [e for e in edges if e not in consumed] or edges
        ins = []
        for _ in range(arity):
            r = rng.random()
            e = rng.choice(free) if r < 0.85 else (rng.choice(edges) if r < 0.95 else len(edges) + 5)
            ins.append(e)
        if is_sel:
            n_out = 0 if rng.random() < 0.95 else 1
        else:
            n_out = getattr(spec, "n_outputs", 1)
            if n_out < 0 or rng.random() < 0.05:
                n_out = rng.randint(1, 4)
        params = _random_params(rng, getattr(spec, "sig", None), n_out)
        kind = KIND_SELECTOR if is_sel else KIND_CODEC
        nodes.append((kind, name, tuple(ins), n_out, params))
        consumed.update(ins)
        edges.extend(range(len(edges), len(edges) + n_out))
    fv = rng.choice((None, 1, 2, 3, 4))
    atoms = None
    if rng.random() < 0.5:
        atoms = [rng.choice(ENUM_ATOMS) for _ in range(n_inputs)]
    return n_inputs, nodes, fv, atoms


@pytest.mark.parametrize("batch", range(RANDOM_PLANS // RANDOM_BATCH))
def test_random_plans_check_as_in_the_reference(batch):
    from repro.core.graph import _freeze as ref_freeze
    from repro_torch.core.graph import _freeze

    for seed in range(batch * RANDOM_BATCH, (batch + 1) * RANDOM_BATCH):
        n_inputs, nodes, fv, atoms = _random_plan(seed)
        rplan = RefPlan(n_inputs, tuple(RefNode(k, n, i, o, ref_freeze(p))
                                        for k, n, i, o, p in nodes), f"r{seed}")
        plan = Plan(n_inputs, tuple(PlanNode(k, n, i, o, _freeze(p))
                                    for k, n, i, o, p in nodes), f"r{seed}")
        # the unvalidated plans, as the checker's E_STRUCT / E_UNKNOWN path sees them
        got = _report(PA.check_plan(plan, format_version=fv, input_atoms=atoms))
        want = _report(RA.check_plan(rplan, format_version=fv, input_atoms=atoms))
        assert got == want, seed
        # the plan file the reference writes, read by each package
        blob = ref_serialize(rplan, format_version=fv)
        got = _outcome(lambda: deserialize_plan(blob))
        want = _outcome(lambda: ref_deserialize(blob))
        assert got[0] == want[0], seed
        if got[0] != "ok":
            assert got == want, seed
            continue
        assert got[1][1] == want[1][1]
        assert (_report(PA.check_plan(got[1][0], format_version=fv, input_atoms=atoms))
                == _report(RA.check_plan(want[1][0], format_version=fv, input_atoms=atoms)))


# -------------------------------------- (d) typed nodes of wire frames
def _frames(blob: bytes, read_container):
    if blob[:4] == wire.CONTAINER_MAGIC:
        return list(read_container(blob)[1])
    return [blob]


def _annotations(frame: bytes):
    version, n_inputs, nodes, _stored = wire.read_frame(frame, "cpu")
    types, report = PA.annotate_resolved_nodes(n_inputs, nodes, format_version=version)
    rversion, rn_inputs, rnodes, _rstored = ref_wire.read_frame(frame)
    rtypes, rreport = RA.annotate_resolved_nodes(rn_inputs, rnodes, format_version=rversion)
    return (types, _report(report)), (rtypes, _report(rreport))


@pytest.mark.parametrize("fname", GOLDEN_FRAMES)
def test_golden_frame_nodes_annotate_as_in_the_reference(fname):
    blob = (GOLDEN / fname).read_bytes()
    frames = _frames(blob, wire.read_container)
    assert frames == _frames(blob, ref_wire.read_container)
    for frame in frames:
        got, want = _annotations(frame)
        assert got == want
        assert len(got[0]) == len(wire.read_frame(frame, "cpu")[2])


def test_a_fused_frame_annotates_as_in_the_reference():
    # string offsets whose largest gap needs exactly 8 bits: the pass fuses
    offsets = np.cumsum(np.random.default_rng(3).integers(128, 256, 4096)).astype(np.uint32)
    frame = repro_torch.compress(repro_torch.pipeline("delta", "bitpack"),
                                 repro_torch.numeric(offsets), device="cpu")
    (node,) = wire.read_frame(frame, "cpu")[2]
    assert all_codecs()["fused_delta_bitpack"].codec_id == node.codec_id
    got, want = _annotations(frame)
    assert got == want
    assert got[0] == [("any", "serial")]


# -------------------------------- (e) the reference's probe on the port
@pytest.fixture()
def wrapper_calls(monkeypatch):
    """Every kernel wrapper call by name (on the CPU a wrapper takes its plain
    version, so this stands for the card's launches)."""
    calls = []
    for name in ops.KERNELS:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("atom", CONCRETE_ATOMS, ids=str)
@pytest.mark.parametrize("name", SINGLE)
def test_signature_matches_encode_reality_on_the_port(name, atom, wrapper_calls):
    """An accepted atom encodes and decodes back; a refused one raises
    ``ValueError`` before any kernel wrapper is called, the checker flags the
    same wiring, and the reference refuses it too."""
    spec, ref = all_codecs()[name], ref_codecs()[name]
    rstrm = _sample(atom, name)
    params = _params_for(name, rstrm, atom)
    strm = _port_stream(rstrm)
    ref_ok = _outcome(lambda: ref.run_encode([rstrm], params))[0] == "ok"
    if spec.sig.inputs[0].accepts(atom):
        outs, header = spec.run_encode([strm], params)
        (back,) = spec.run_decode(outs, header, device="cpu")
        assert (back.stype, back.width) == (strm.stype, strm.width)
        assert back.content_bytes() == strm.content_bytes()
        assert ref_ok
        return
    with pytest.raises(ValueError):
        spec.run_encode([strm], params)
    assert wrapper_calls == [], f"{name} on {atom} reached {wrapper_calls}"
    assert not ref_ok
    g = GraphBuilder(1)
    n_out = spec.n_outputs if spec.n_outputs >= 0 else 2
    g.add(name, g.input(0), n_out=n_out, **params)
    assert not PA.check_plan(g.build(), input_atoms=[atom]).ok


# ----------------------------------------------- (f) the resolve check
def _bad_plan(builder):
    g = builder(1)
    lit, _lens = g.add("huffman", g.input(0), n_out=2)
    g.add("delta", lit)  # delta wants numeric, huffman emits serial
    return g.build("bad")


def test_the_resolve_check_refuses_before_any_encoder_runs():
    data = b"abcd" * 64
    set_resolve_check(True)
    with FaultPlan(record=True).arm(all_threads=True) as plan:
        with pytest.raises(PA.PlanTypeError) as ei:
            repro_torch.compress(_bad_plan(GraphBuilder), serial(data), device="cpu")
    assert not [s for s in plan.sites if s[0].startswith("device.encode.")]
    ref_engine.set_resolve_check(True)
    with pytest.raises(RA.PlanTypeError) as ri:
        ref_compress(_bad_plan(RefBuilder), ref_serial(data))
    assert str(ei.value) == str(ri.value) and ei.value.extra == ri.value.extra


def test_the_resolve_check_passes_a_well_typed_plan_and_frames_do_not_change():
    plan = repro_torch.pipeline("delta", "range_pack")
    x = repro_torch.numeric(np.arange(64, dtype=np.uint32))
    off = repro_torch.compress(plan, x, device="cpu")
    set_resolve_check(True)
    repro_torch.resolve_cache_clear()
    with FaultPlan(record=True).arm(all_threads=True) as rec:
        on = repro_torch.compress(plan, x, device="cpu")
    assert on == off
    assert [s[0] for s in rec.sites if s[0].startswith("device.encode.")] == [
        "device.encode.cpu.delta", "device.encode.cpu.range_pack"]


def test_the_resolve_check_runs_where_the_reference_does_on_a_cache_miss():
    """As in the reference, a resolve-cache hit is served unchecked (the
    entry was made with the check off) and a miss is checked."""
    seen = []
    for compress, pipeline, numeric, strings, info, errors in (
            (lambda p, s: repro_torch.compress(p, s, device="cpu"), repro_torch.pipeline,
             repro_torch.numeric, repro_torch.strings, repro_torch.resolve_cache_info,
             (PA.PlanTypeError, RA.PlanTypeError)),
            (ref_compress, ref_pipeline, ref_numeric, ref_strings, ref_engine.resolve_cache_info,
             (RA.PlanTypeError, PA.PlanTypeError))):
        set_resolve_check(False)
        ref_engine.set_resolve_check(False)
        plan = pipeline("delta")
        x = numeric(np.arange(64, dtype=np.uint32))
        compress(plan, x)  # cached with the check off
        hits = info()["hits"]
        set_resolve_check(True)
        ref_engine.set_resolve_check(True)
        compress(plan, x)
        with pytest.raises(errors[0]) as ei:
            compress(plan, strings([b"ab"] * 9))
        seen.append((info()["hits"] - hits, str(ei.value)))
    assert seen[0] == seen[1] and seen[0][0] == 1


def test_the_environment_switch_turns_the_resolve_check_on():
    code = ("import repro_torch as rt\n"
            "from repro_torch.analysis import PlanTypeError\n"
            "try:\n"
            "    rt.compress(rt.pipeline('delta'), rt.strings([b'ab']), device='cpu')\n"
            "except PlanTypeError as e:\n"
            "    print(e.extra['error_kind'], [d['code'] for d in e.extra['diagnostics']])\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "REPRO_RESOLVE_CHECK": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ill_typed_plan ['E_TYPE']"


# ----------------------------------------------------- (g) the registry
@pytest.mark.parametrize("fname", ILL)
def test_the_registry_refuses_an_illtyped_plan_as_the_reference_does(fname):
    reg, rreg = PlanRegistry(), RefRegistry()
    with pytest.raises(PA.PlanTypeError) as ei:
        reg.register_file(ILLTYPED / fname)
    with pytest.raises(RA.PlanTypeError) as ri:
        rreg.register_file(ILLTYPED / fname)
    assert str(ei.value) == str(ri.value)
    assert ei.value.extra == ri.value.extra
    assert ei.value.extra["error_kind"] == "ill_typed_plan"
    assert MANIFEST[fname]["expect"] in {d["code"] for d in ei.value.extra["diagnostics"]}
    assert len(reg) == 0 and reg.entries() == []


def test_the_registry_accepts_well_typed_plans():
    reg = PlanRegistry()
    assert reg.register_profile("numeric").plan_id == "numeric"
    reg.register_file(GOLDEN / "profile_sao.ozp")
    assert len(reg) == 2


def test_a_plan_type_error_reaches_the_error_header(tmp_path):
    """With the resolve check on, a request whose bytes the registered plan
    cannot take is answered with the error's ``extra`` in the header."""
    reg = PlanRegistry()
    reg.register_compressor(repro_torch.Compressor(repro_torch.pipeline("delta"), name="d"))
    set_resolve_check(True)
    with CompressionServer(reg, socket_path=str(tmp_path / "s.sock"), device="cpu",
                           request_timeout=5.0) as srv:
        buf = io.BytesIO()
        SP.write_request(buf, SP.VERB_COMPRESS, {"plan": "d", "size": 64, "chunk_bytes": 0},
                         [bytes(64)])
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(10.0)
        s.connect(srv.socket_path)
        try:
            s.sendall(buf.getvalue())
            status, header, body = SP.read_response(s.makefile("rb"))
            body.drain()
        finally:
            s.close()
    assert status == SP.STATUS_ERROR
    assert header["error_kind"] == "ill_typed_plan"
    assert [d["code"] for d in header["diagnostics"]] == ["E_TYPE"]
    assert header["error"].startswith("resolve check: plan 'delta' is ill-typed")


# ----------------------------------------- (h) lint on the command line
def _lint_both(argv, capsys):
    capsys.readouterr()
    rc = cli.main(["lint"] + argv)
    got = (rc,) + tuple(capsys.readouterr())
    want_rc = ref_cli.main(["lint"] + argv)
    want = (want_rc,) + tuple(capsys.readouterr())
    return got, want


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
@pytest.mark.parametrize("fname", ILL)
def test_lint_of_an_illtyped_plan_is_the_references(fname, as_json, capsys):
    got, want = _lint_both([str(ILLTYPED / fname)] + (["--json"] if as_json else []), capsys)
    assert got == want and got[0] == 1


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_lint_of_the_golden_plans_and_profiles_is_clean_as_in_the_reference(as_json, capsys):
    targets = [str(GOLDEN / f) for f in GOLDEN_PLANS] + ["generic", "text"]
    got, want = _lint_both(targets + (["--json"] if as_json else []), capsys)
    assert got == want and got[0] == 0


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_lint_of_a_missing_file_is_the_references(as_json, tmp_path, capsys):
    missing = str(tmp_path / "missing.ozp")
    got, want = _lint_both([missing, "generic"] + (["--json"] if as_json else []), capsys)
    assert got == want and got[0] == 2


def test_lint_children_of_both_packages_agree():
    argv = ["lint", "--json"] + [str(ILLTYPED / f) for f in ILL] + ["generic"]
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    port = subprocess.run([sys.executable, "-m", "repro_torch"] + argv, capture_output=True,
                          text=True, env=env, timeout=300)
    ref = subprocess.run([sys.executable, "-m", "repro.cli"] + argv, capture_output=True,
                         text=True, env=env, timeout=300)
    assert (port.returncode, port.stdout) == (ref.returncode, ref.stdout)
    assert port.returncode == 1
    out = json.loads(port.stdout)
    assert [t["target"] for t in out["targets"]] == argv[2:]
    for t, f in zip(out["targets"], ILL):
        assert MANIFEST[f]["expect"] in {d["code"] for d in t["diagnostics"]}


# ---------------------------------- (i) serve --register of an ill plan
@pytest.mark.parametrize("fname", ILL)
def test_serve_refuses_an_illtyped_plan_before_binding(fname, tmp_path):
    path = tmp_path / "s.sock"
    plan = str(ILLTYPED / fname)
    with pytest.raises(SystemExit) as ei:
        cli.main(["serve", "--socket", str(path), "--register", plan, "--device", "cpu"])
    assert not path.exists()
    with pytest.raises(SystemExit) as ri:
        ref_cli.main(["serve", "--socket", str(path), "--register", plan])
    assert str(ei.value) == str(ri.value)
    assert str(ei.value).startswith(f"serve: plan {Path(fname).stem}")
    assert " is ill-typed: " in str(ei.value)
