"""The port stands alone: nothing under ``src/repro_torch`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package, importing the port
loads neither, its CUDA sources include only the toolkit's headers, and
its entry points default to the card."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core.grid import RankGrid

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro"}
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
CUDA_SOURCES = sorted((REPO / "src" / "repro_torch").rglob("*.cu"))
#: the headers a kernel source may include: the CUDA toolkit's and libc's
CUDA_HEADERS = {"cuda_runtime.h", "cuda_fp16.h", "cuda_fp8.h", "cuda_bf16.h",
                "stdint.h"}


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.name} imports {sorted(bad)}"


@pytest.mark.parametrize("path", CUDA_SOURCES,
                         ids=[p.name for p in CUDA_SOURCES])
def test_cuda_sources_stand_alone(path):
    """A kernel source includes only the toolkit's headers (no PyTorch, no
    Python, nothing of the reference), names no JAX module, and has its
    ctypes signatures in ``_build.SIGNATURES``."""
    from repro_torch.kernels import _build
    text = path.read_text()
    includes = {line.split()[1].strip('<>"') for line in text.splitlines()
                if line.startswith("#include")}
    assert includes <= CUDA_HEADERS, includes - CUDA_HEADERS
    assert "jax" not in text.lower() and "import repro" not in text
    exported = set(_build.SIGNATURES[path.stem])
    for fn in exported:
        assert f" {fn}(" in text, fn


def test_importing_the_port_loads_no_jax():
    modules = [".".join(p.relative_to(REPO / "src").with_suffix("").parts)
               .replace(".__init__", "") for p in PORT_FILES[:-1]]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_rank_grid_defaults_to_the_card():
    assert RankGrid().device.type == "cuda"
    assert RankGrid(2, 4).device.type == "cuda"
    assert RankGrid(2, 4, device="cpu").device.type == "cpu"


def _model_entry_points():
    from repro_torch import interop
    from repro_torch.layers import attention, common, mamba, mlp, moe, rwkv
    from repro_torch.models import decoder, encdec
    return [decoder.DecoderLM, decoder.AttnBlock, decoder.MambaBlock,
            decoder.RwkvBlock, decoder.RMSNorm, encdec.EncDecLM,
            encdec.EncLayer, encdec.DecLayer, attention.Attention,
            attention.init_cache, mamba.Mamba, mamba.init_state, moe.MoE,
            mlp.MLP, rwkv.TimeMix, rwkv.ChannelMix, rwkv.init_state,
            common.init_rmsnorm, interop.params_from_reference]


@pytest.mark.parametrize("entry", _model_entry_points(),
                         ids=lambda f: f.__qualname__)
def test_model_entry_points_default_to_the_card(entry):
    import inspect
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_a_generator_off_the_requested_device_raises():
    """Weights go where ``device`` says; a CPU generator does not move a
    model that was not asked for the CPU."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.decoder import DecoderLM
    cfg = reduced_config("smollm-360m")
    with pytest.raises(ValueError, match="generator on cpu, weights "
                                         "requested on cuda"):
        DecoderLM(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="requested on meta"):
        DecoderLM(cfg, torch.Generator(), device="meta")
    model = DecoderLM(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {p.device for p in model.parameters()} == {torch.device("cpu")}


def test_a_default_grid_names_the_card_as_its_operands_do(monkeypatch):
    """On a machine with a card, ``RankGrid(2, 4)`` holds ``cuda:0``, the
    device a tensor made with ``device="cuda"`` reports, so its operands
    pass the grid's device checks. (The card is stood in for here; nothing
    is allocated.)"""
    from repro_torch.core.grid import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert RankGrid(2, 4).device == torch.device("cuda:0")
    assert RankGrid(2, 4) == RankGrid(2, 4, "cuda:0") != RankGrid(2, 4,
                                                                  "cuda:1")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or without CUDA, the smoke test exits non-zero
    and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((tmp_path, lone), (REPO, REPO / "chip_smoke.py")):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
