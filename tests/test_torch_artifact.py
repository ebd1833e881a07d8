"""The port's calibration-artifact schema against the reference's.

Every case of ``tests/test_artifact.py`` runs on both modules (they are
pure Python, so both load in this process): the same artifact validates in
both, and each mutation raises ``ArtifactError`` in both with the same
message. The calibrate sections the port builds from a CPU
``Communicator.calibrate`` validate too.
"""
import copy

import pytest

from repro_torch.core import artifact as tart

pytest.importorskip("jax")
from repro.core import artifact as jart  # noqa: E402


def _minimal():
    """The reference suite's smallest artifact the full schema accepts:
    every section, one row each."""
    per_plan = [{"plan": "pip_mcoll", "measured_us": 120.0,
                 "model_us": 80.0, "signed_rel_err": 0.5}]
    return {
        "topology": "4x2/host_cpu/host_cpu",
        "sizes": [256, 4096, 65536],
        "backend": "single",
        "process_count": 1,
        "table": {"version": 1, "entries": {}},
        "latency_rows": [{
            "collective": "allreduce", "algo": "pip_mcoll", "nbytes": 4096,
            "dtype": "float32", "seconds": 1.2e-4, "chunks": 1,
            "codec": "none", "group": ""}],
        "model_vs_measured": [{
            "collective": "allreduce", "nbytes": 4096,
            "measured_algo": "pip_mcoll", "measured_us": 120.0,
            "prior_algo": "pip_mcoll", "prior_us": 80.0, "agree": True,
            "per_plan": per_plan}],
        "pipeline_crossover": [{
            "collective": "allreduce", "algo": "pip_pipeline",
            "model_crossover_bytes": 1 << 20, "model_sweep": [],
            "measured_us_by_plan": {}}],
        "compression": [{
            "codec": "int8_block", "declared_ratio": 3.5,
            "achieved_ratio": 3.4, "stated_rel_bound": 7.9e-3,
            "achieved_abs_error": 1e-4, "bound_abs_tolerance": 2e-4,
            "model_crossover_vs_lossless_bytes": 1 << 16,
            "budget_selection_crossover_bytes": 1 << 16}],
        "overlap": {"devices": 8, "topology": "4x2/host_cpu/host_cpu",
                    "microbench": {}, "amortization": {}, "train_step": {}},
        "codec_kernels": {"devices": 8, "block": 256, "slices": 8,
                          "world": 8, "elems_per_slice": 4096,
                          "fused_codecs": [], "rows": [],
                          "traffic_halved": [], "zlib_sim": {}, "note": ""},
    }


def _same_verdict(data, match=None, sections="all"):
    """Validate ``data`` with both modules: both accept it (returning it),
    or both raise ``ArtifactError`` with the same message (containing
    ``match`` when given). Returns the message, or None."""
    kw = {} if sections == "all" else {"sections": sections}
    outcomes = []
    for mod in (tart, jart):
        mine = copy.deepcopy(data)
        try:
            assert mod.validate(mine, **kw) is mine
            outcomes.append(None)
        except mod.ArtifactError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1], outcomes
    if match is not None:
        assert outcomes[0] is not None and match in outcomes[0], outcomes
    return outcomes[0]


def test_schema_constants_equal_the_reference():
    assert tart.CALIBRATE_SECTIONS == jart.CALIBRATE_SECTIONS
    assert tart.ALL_SECTIONS == jart.ALL_SECTIONS
    assert tart.ROW_KEYS == jart.ROW_KEYS
    assert tart.PER_PLAN_KEYS == jart.PER_PLAN_KEYS
    assert tart.SECTION_KEYS == jart.SECTION_KEYS
    assert issubclass(tart.ArtifactError, ValueError)


def test_minimal_artifact_validates():
    data = _minimal()
    assert _same_verdict(data) is None
    base = {k: data[k] for k in tart.CALIBRATE_SECTIONS}
    assert _same_verdict(base, sections=tart.CALIBRATE_SECTIONS) is None


@pytest.mark.parametrize("section", tart.ALL_SECTIONS)
def test_every_section_drop_is_caught(section):
    broken = _minimal()
    del broken[section]
    _same_verdict(broken, match=section)


def test_row_key_drop_is_caught():
    for section, keys in tart.ROW_KEYS.items():
        for key in sorted(keys):
            broken = _minimal()
            del broken[section][0][key]
            _same_verdict(broken, match=key)


def test_per_plan_key_drop_and_emptiness_are_caught():
    for key in sorted(tart.PER_PLAN_KEYS):
        broken = _minimal()
        del broken["model_vs_measured"][0]["per_plan"][0][key]
        _same_verdict(broken, match=key)
    broken = _minimal()
    broken["model_vs_measured"][0]["per_plan"] = []
    _same_verdict(broken, match="per_plan")


def test_dict_section_key_drop_is_caught():
    for section, keys in tart.SECTION_KEYS.items():
        for key in sorted(keys):
            broken = _minimal()
            del broken[section][key]
            assert _same_verdict(broken) is not None, (section, key)


def test_calibrate_subset_validation():
    data = _minimal()
    base = {k: data[k] for k in tart.CALIBRATE_SECTIONS}
    _same_verdict(base, match="overlap")
    extra = dict(base)
    extra["overlap"] = {"devices": 8}  # missing the other overlap keys
    _same_verdict(extra, match="overlap", sections=tart.CALIBRATE_SECTIONS)


def test_malformed_scalars_and_rows_are_caught():
    cases = [("sizes", [], "sizes"), ("topology", {"nodes": 4}, "topology"),
             ("latency_rows", "not-a-list", "latency_rows"),
             ("latency_rows", [], "latency_rows")]
    cases += [("backend", b, "backend") for b in ("", 3, None)]
    cases += [("process_count", c, "process_count")
              for c in (0, -1, "2", 1.5, True)]
    for key, value, match in cases:
        broken = _minimal()
        broken[key] = value
        _same_verdict(broken, match=match)


def test_multiprocess_artifact_fields_validate():
    data = _minimal()
    data["backend"] = "multiprocess"
    data["process_count"] = 2
    data["topology"] = "2x4/host_ipc/host_cpu"
    assert _same_verdict(data) is None


def test_validate_file_round_trip(tmp_path):
    import json
    path = tmp_path / "artifact.json"
    path.write_text(json.dumps(_minimal()))
    assert tart.validate_file(path) == jart.validate_file(path)
    path.write_text(json.dumps({"topology": "x"}))
    with pytest.raises(tart.ArtifactError, match="sizes"):
        tart.validate_file(path, sections=("topology", "sizes"))


def test_cpu_calibration_sections_validate():
    """The sections the port builds from a CPU calibration over the split
    lattice validate under both schemas; every (group, collective, size)
    cell has a per-plan row for each measured plan, whose signed relative
    error is ``(measured - model) / model``."""
    from repro_torch.core import autotune
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid

    comm = Communicator(RankGrid(2, 4, device="cpu"),
                        selector=autotune.Selector())
    sizes = (8, 4096)
    rows = comm.calibrate(include_splits=True, names=("allreduce",
                                                      "broadcast"),
                          sizes=sizes, iters=2, codecs=())
    data = tart.calibration_sections(comm, rows)
    sections = tuple(s for s in tart.CALIBRATE_SECTIONS
                     if s not in ("pipeline_crossover", "compression"))
    assert set(data) == set(sections)
    assert _same_verdict(data, sections=sections) is None
    assert data["sizes"] == list(sizes) and data["process_count"] == 1
    assert data["topology"] == autotune.topo_key(comm.topo)
    assert len(data["latency_rows"]) == len(rows)
    cells = {(r["group"], r["collective"], r["nbytes"])
             for r in data["model_vs_measured"]}
    assert cells == {(r.group, r.collective, r.nbytes) for r in rows}
    for cell in data["model_vs_measured"]:
        plans = {p["plan"] for p in cell["per_plan"]}
        assert cell["measured_plan"] in plans
        for p in cell["per_plan"]:
            want = (p["measured_us"] - p["model_us"]) / p["model_us"]
            assert p["signed_rel_err"] == pytest.approx(want, rel=1e-12)
