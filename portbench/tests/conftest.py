"""The portbench tests import ``portbench`` from the repository's root and
the program from ``src/``; the cells run here at small sizes on the CPU."""
import copy
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the widths the CPU runs use in place of each configuration's
SMALL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab": 512}
SMALL_MOE = {"n_experts": 8, "top_k": 2, "d_ff_expert": 32}
SMALL_SEQ = 16
#: warm-up steps of a small run at most
SMALL_WARM = 2


def small_config(name: str) -> dict:
    """A configuration's ``model`` at the test size (MoE: one layer)."""
    c = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                   .read_text())["model"]
    c = dict(c, **SMALL)
    if c.get("moe"):
        c["n_layers"] = 1
        c["moe"] = dict(c["moe"], **SMALL_MOE)
    return c


def small_traffic(traffic: dict) -> dict:
    t = copy.deepcopy(traffic)
    if "seq_len" in t:
        t["seq_len"] = SMALL_SEQ
    t["warm_steps"] = min(t.get("warm_steps", 0), SMALL_WARM)
    return t


@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided here, when
    the test runs, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark's card path)")
    return torch.device("cuda")
