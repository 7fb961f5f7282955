"""The port stands alone: no ``jax``, no ``repro``, no ``msgpack``, no CPU default.

An AST scan of every module of ``src/repro_torch/``, ``chip_smoke.py`` and ``kernel_turns.py``
finds no import of the three, and a fresh interpreter that imports the port
has none of them in ``sys.modules`` and has not initialised CUDA.  Without a
card, an entry point called without ``device="cpu"`` raises instead of
running on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import _device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "repro", "msgpack")
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "kernel_turns.py"
]


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_forbidden(path):
    bad = sorted(set(_top_level_imports(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_scan_covers_the_container_slices_modules():
    port = REPO / "src" / "repro_torch"
    for rel in ("codecs/convert.py", "codecs/selectors.py", "codecs/profiles.py",
                "codecs/graph.py", "codecs/coder_cache.py", "core/wire.py", "core/engine.py",
                "core/stream_io.py"):
        assert port / rel in PORT_FILES


def test_the_scan_covers_the_checkpoint_slices_subpackages():
    port = REPO / "src" / "repro_torch"
    for rel in ("reliability/__init__.py", "reliability/faults.py",
                "reliability/crashkill.py", "reliability/_victim.py",
                "distributed/__init__.py", "distributed/checkpoint.py",
                "data/__init__.py", "data/shard_store.py"):
        assert port / rel in PORT_FILES


def test_the_scan_covers_the_cli_slices_modules():
    port = REPO / "src" / "repro_torch"
    for rel in ("core/serialize.py", "cli.py", "__main__.py"):
        assert port / rel in PORT_FILES


def test_the_scan_covers_the_service_slices_modules():
    port = REPO / "src" / "repro_torch"
    for rel in ("service/__init__.py", "service/protocol.py", "service/registry.py",
                "service/server.py", "service/client.py", "service/ratelimit.py",
                "service/metrics.py", "service/frontend.py", "reliability/failover.py"):
        assert port / rel in PORT_FILES


def test_the_scan_covers_the_lm_slices_modules():
    port = REPO / "src" / "repro_torch"
    for rel in ("configs/__init__.py", "configs/base.py", "configs/lm_common.py",
                "configs/llama3_2_1b.py", "configs/h2o_danube3_4b.py", "configs/yi_9b.py",
                "configs/olmoe_1b_7b.py", "configs/kimi_k2_1t_a32b.py",
                "models/__init__.py", "models/layers.py", "models/transformer.py",
                "models/convert.py", "launch/__init__.py", "launch/train.py",
                "launch/serve.py", "data/pipeline.py", "data/synthetic.py",
                "distributed/optimizer.py"):
        assert port / rel in PORT_FILES


def test_importing_the_lm_drivers_loads_nothing_forbidden_and_no_cuda():
    code = (
        "import sys, torch, repro_torch.launch.train, repro_torch.launch.serve,"
        " repro_torch.models, repro_torch.configs, repro_torch.distributed.optimizer\n"
        "from repro_torch.configs import all_archs\n"
        "archs = sorted(all_archs())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad, torch.cuda.is_initialized(), len(archs))\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False 5"


def test_importing_the_port_loads_nothing_forbidden_and_no_cuda():
    code = (
        "import sys, torch, repro_torch, repro_torch.codecs, repro_torch.kernels.ops,"
        " repro_torch.kernels._build, repro_torch.core.stream_io,"
        " repro_torch.reliability.crashkill, repro_torch.distributed.checkpoint,"
        " repro_torch.data, repro_torch.core.serialize, repro_torch.cli,"
        " repro_torch.service, repro_torch.service.frontend, repro_torch.reliability.failover\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad, torch.cuda.is_initialized())\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False"


def test_importing_the_frontend_alone_loads_nothing_forbidden_and_no_cuda():
    code = (
        "import sys, repro_torch.service.frontend as f, torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad, torch.cuda.is_initialized(), f.ServiceFrontend.__name__)\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False ServiceFrontend"


def test_entry_point_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ops.reset_launches()
    col = repro_torch.numeric(np.arange(1000, dtype=np.uint32))
    with pytest.raises(_device.NoCardError):
        repro_torch.compress(repro_torch.numeric_profile(), col)
    with pytest.raises(_device.NoCardError):
        repro_torch.compress(repro_torch.numeric_profile(), col, device="cuda")
    assert _device.resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ops.KernelError, match="cuda or cpu"):
        ops.delta_encode(meta)
