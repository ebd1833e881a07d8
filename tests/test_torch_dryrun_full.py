"""Full-size cells of the port's dry run on the production grid
(``RankGrid(32, 8)`` on ``meta``), one of each kind: smollm-360m x
train_4k, yi-34b x prefill_32k (60 layers of streaming attention over
32768 positions, the layer loop weighted by its trip count), rwkv6-1.6b
x long_500k (a decode tick against a 524288-position state), each within
its counting budget; and long_500k skipped for a full-attention arch, as
the reference's ``shape_applicable`` decides.
"""
import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.roofline import terms as T

#: (arch, shape, counting budget in seconds)
FULL = [("smollm-360m", "train_4k", 60), ("yi-34b", "prefill_32k", 120),
        ("rwkv6-1.6b", "long_500k", 60)]


@pytest.mark.parametrize("arch,shape,budget", FULL)
def test_full_size_cell(arch, shape, budget):
    rec = dryrun.run_cell(arch, shape, False)
    cfg, sh = get_config(arch), SHAPES[shape]
    assert rec["status"] == "ok"
    assert rec["count_s"] < budget
    assert rec["mesh"] == {"shape": [32, 8], "axes": ["node", "local"]}
    ro, hlo = rec["roofline"], rec["hlo"]
    assert ro["model_flops"] == T.model_flops(cfg, sh)
    assert hlo["flops_per_dev"] > 0 and hlo["bytes_per_dev"] > 0
    assert ro["compute_s"] == hlo["flops_per_dev"] / T.H100_SXM.peak_flops
    assert ro["memory_s"] == hlo["bytes_per_dev"] / T.H100_SXM.hbm_bw
    assert ro["collective_s"] == \
        hlo["collective_bytes_per_dev"] / T.H100_SXM.net_bw
    assert 0 < ro["roofline_fraction"] <= 1
    cycles = dryrun.cycles(cfg)
    assert rec["counted_cycles"] == ([1, 2] if cycles > 2 else None)
    if sh.kind == "train":
        # FSDP gathers twice (remat) and reduce-scatters once a layer
        counts = hlo["collective_counts"]
        assert counts["all-gather"] == 2 * counts["reduce-scatter"]


def test_full_attention_skips_long_500k():
    rec = dryrun.run_cell("yi-34b", "long_500k", True)
    assert rec["status"] == "skipped" and rec["multi_pod"] is True
    assert "reason" in rec
