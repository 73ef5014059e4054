"""Entry-point plumbing: the peak table, the compile-cache rule, the
device header, and chip_smoke.py's CPU rehearsal and result line."""

import json
import os

import jax
import pytest

from hnsw_tpu.utils import compile_cache, roofline


@pytest.mark.parametrize("kind", sorted(roofline.PEAKS))
def test_peak_table_resolves_h100_kinds(kind):
    for precision in ("bf16", "tf32", "fp32", "hbm_bytes_per_s"):
        assert roofline.peak(kind, precision) > 0
    assert (roofline.peak(kind, "bf16") > roofline.peak(kind, "tf32")
            > roofline.peak(kind, "fp32"))


def test_peak_table_unknown_device_raises():
    with pytest.raises(KeyError, match="no peak table entry"):
        roofline.peak("Some Unknown Card", "bf16")
    with pytest.raises(KeyError):
        roofline.roofline_fields(n_q=1, n=1, d=1, dt=1.0,
                                 device_kind="cpu", precision="bf16")


def test_roofline_fields_use_the_rows_precision():
    kind = "NVIDIA H100 80GB HBM3"
    f = roofline.roofline_fields(n_q=8192, n=1 << 20, d=128, dt=0.01,
                                 device_kind=kind, precision="bf16",
                                 floor_dt=0.005)
    flops = 2.0 * 8192 * (1 << 20) * 128
    assert f["mfu"] == pytest.approx(flops / 0.01 / 989e12)
    assert f["mfu_precision"] == "bf16"
    assert f["floor_frac"] == pytest.approx(0.5)


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_header_requires_gpu():
    from hnsw_tpu.utils.profiling import device_header
    with pytest.raises(RuntimeError, match="no GPU"):
        device_header(require_gpu=True)
    h = device_header(require_gpu=False)
    assert h["platform"] == "cpu" and h["card"] is None
    assert h["device_count"] == len(jax.devices())


def test_smoke_result_line_shape():
    import chip_smoke
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.dumps(line) == ('{"ok": true, "device": {"platform": '
                                '"gpu", "kind": "NVIDIA H100 80GB HBM3", '
                                '"count": 1}}')


def test_smoke_refuses_cpu_without_tiny(capsys):
    import chip_smoke
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_tiny_runs_every_phase(capsys, monkeypatch, tmp_path):
    import chip_smoke
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert chip_smoke.main(["--tiny", "--rows", "2048",
                            "--graph-rows", "2048"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    phases = {r.get("phase") for r in rows}
    assert {"exact_f32", "exact_fast", "exact_int8", "fused_check",
            "graph_build", "graph_search",
            "graph_single_query"} <= phases
    last = json.loads(lines[-1])
    assert last == {"ok": True,
                    "device": {"platform": "cpu", "kind": "cpu",
                               "count": len(jax.devices())}}
