"""The hybrid cell's files on the CPU: the driver end to end at a small size
(correct as the program is; each attention fault and the control fail it),
the counts against arithmetic done by hand, the new readers on synthetic
records, and the driver's refusal of a program without the model."""
from __future__ import annotations

import time

import pytest

from portbench import faults, faults_hybrid, harness
from portbench.counts import granite_hybrid as counts
from portbench.counts import peaks
from portbench.drivers import serving_hybrid

SEED = 2**31 + 29
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def tiny_granite(monkeypatch):
    """granite-4.0-h-micro at toy widths, a period of 3 holding both kinds,
    two periods, f32."""
    from repro_torch.configs import get_config

    program = get_config("granite-4.0-h-micro").replace(
        n_layers=6, layer_pattern=("ssm_mlp", "attn", "ssm_mlp"), d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=200, ssm_state=8, ssm_head_dim=16,
        ssm_chunk=8, dtype="float32")
    monkeypatch.setattr(serving_hybrid, "program_config", lambda cfg: program)
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
            "vocab_pad_to", "ssm_state", "ssm_conv", "ssm_expand", "ssm_head_dim", "ssm_chunk",
            "embedding_multiplier", "attention_multiplier", "residual_multiplier",
            "logits_scaling", "norm_eps", "dtype")
    sizes = {k: getattr(program, k) for k in keys}
    sizes["layer_pattern"] = list(program.layer_pattern)
    cfg = {"arch": "granite-4.0-h-micro", "sizes": sizes,
           "weight_draw": {"qk_gain": 6.0, "embed_std": 0.005},
           "driver": "serving_hybrid"}
    mix = {"batch": 2, "prompt_tokens": [40, 40], "new_tokens": [4, 4], "sizes": 1,
           "weight_sets": 1, "publish_every_s": None, "poll_interval_s": 0.05,
           "profile_from_s": 0.5, "profile_s": 0.5, "check_batches": 2,
           "limits": {"token_gap": 1e-4}}
    return cfg, mix


def _judged(out: dict) -> bool:
    return harness.judge(out["readings"], out["limits"])[0] and out["failed"] == 0


class _HostOnly(harness.Profiled):
    """The profiled sub-window's clock without a card: no operations."""

    def __init__(self):
        self.t0 = self.t1 = None

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()

    def result(self):
        return {"kernels": [], "busy_s": 0.0, "window_s": self.t1 - self.t0, "t0": self.t0,
                "t1": self.t1}


def test_hybrid_serving_run_is_correct(tiny_granite, monkeypatch):
    cfg, mix = tiny_granite
    monkeypatch.setattr(harness, "Profiled", _HostOnly)
    out = serving_hybrid.run(cfg, mix, seed=SEED, seconds=3.0, trace=True, device="cpu")
    assert _judged(out), out["readings"]
    assert out["metrics"]["serve_tokens_per_s"] > 0 and out["metrics"]["ttft_ms_p90"] > 0
    records = out["records"]
    inits = sum(1 for name, _, _ in records["spans"] if name == "serve.cache.init")
    assert inits >= out["attempted"] >= 2  # batches past the close run until the profile ends
    assert records["counters"]["serve.cache.kv_bytes"] > 0
    assert records["flash_shape"]["S"] == 40 and records["decode_shape"]["C"] == 41


@pytest.mark.parametrize("fault", ["attention_zeroed", "attention_scale_default", "altered",
                                   "frozen_state"])
def test_hybrid_faults_fail_the_check(tiny_granite, fault):
    cfg, mix = tiny_granite
    patch = {**faults.FAULTS, **faults_hybrid.FAULTS}[fault]
    out = serving_hybrid.run(cfg, mix, seed=SEED, seconds=2.0, trace=False, device="cpu",
                             patch=patch)
    assert not _judged(out), out["readings"]


def test_hybrid_control_fails_the_check(tiny_granite):
    cfg, mix = tiny_granite
    # fp8 flips a token only now and then at these widths: 4 × 12 tokens a batch
    mix = {**mix, "batch": 4, "new_tokens": [12, 12]}
    out = serving_hybrid.run(cfg, mix, seed=SEED, seconds=10.0, trace=False, device="cpu",
                             control=True)
    assert out["readings"].get("control_gap", 0) > mix["limits"]["token_gap"], \
        (out["readings"], out["attempted"])


def test_a_program_without_the_model_is_refused_before_any_weight():
    cfg = harness.load_json(harness.ROOT / "portbench/configs/granite-4.0-h-micro.json")
    program = serving_hybrid.program_config(cfg)
    assert (program.n_layers, program.pattern.count("attn")) == (10, 1)
    with pytest.raises(KeyError):
        serving_hybrid.program_config({**cfg, "arch": "no-such-model"})
    with pytest.raises(RuntimeError, match="d_ff"):
        serving_hybrid.program_config({**cfg, "sizes": {**cfg["sizes"], "d_ff": 4096}})


# -- the counts, by hand ----------------------------------------------------------------------

SMALL = {"n_layers": 4, "layer_pattern": ["ssm_mlp", "attn"], "d_model": 8, "d_ff": 16,
         "n_heads": 4, "n_kv_heads": 2, "head_dim": 4, "ssm_expand": 2, "ssm_head_dim": 4,
         "ssm_state": 2, "ssm_conv": 4, "ssm_chunk": 4, "vocab_size": 10, "vocab_pad_to": 8}


def test_flash_and_decode_attention_counts():
    # B=1, S=3, KV=2, G=2, hd=4, bf16: q, o 1·3·2·2·4 = 48 elements each, k, v 24
    # each: 144 elements, 288 bytes; 6 visible pairs × 4 heads × 4·4 flops = 384
    assert counts.flash_bytes_flops(B=1, S=3, KV=2, G=2, hd=4, itemsize=2) == (288, 384)
    # C=5: q, o 16 each, k, v 40 each, 112 elements = 224 bytes + 5 mask bytes;
    # 5 entries × 4 heads × 16 flops = 320
    assert counts.decode_attention_bytes_flops(B=1, C=5, KV=2, G=2, hd=4,
                                               itemsize=2) == (229, 320)
    bw, peak = peaks.rate(peaks.BANDWIDTH, H100), peaks.rate(peaks.BF16_FLOPS, H100)
    shape = {"B": 4, "S": 32768, "KV": 8, "G": 4, "hd": 64, "itemsize": 2}
    nbytes, flops = counts.flash_bytes_flops(**shape)
    assert counts.flash_bound_s(H100, **shape) == max(nbytes / bw, flops / peak) == flops / peak
    assert flops == pytest.approx(17.6e12, rel=0.01)  # the cell's causal attention
    dshape = {"B": 4, "C": 32769, "KV": 8, "G": 4, "hd": 64, "itemsize": 2}
    nbytes = counts.decode_attention_bytes_flops(**dshape)[0]
    assert nbytes == pytest.approx(268.5e6, rel=1e-3)  # the cell's ring, read once a step
    assert counts.decode_attention_bound_s(H100, **dshape) == nbytes / bw
    assert counts.flash_bound_s("no such card", **shape) is None


def test_prefill_and_decode_flops():
    # per token: Mamba2 2·8·(32+4+4) + 2·16·8 + 2·4·(16+4) = 640 + 256 + 160 = 1056,
    # attention 2·8·(16+16) + 2·16·8 = 768, MLP 3·2·8·16 = 768
    mamba, attn, mlp = 1056, 768, 768
    # the scan at B=1, S=2, chunk 4 (H=4, P=4, N=2): 3 pairs · 2·(2+4) + 4·2·4·2 = 100,
    # × 4 heads
    scan = 400
    flash = counts.flash_bytes_flops(B=1, S=2, KV=2, G=2, hd=4, itemsize=2)[1]
    unembed = 2 * 8 * 16
    assert counts.prefill_flops(SMALL, 1, 2) == 2 * (2 * (mamba + mlp) + scan) \
        + 2 * (2 * (attn + mlp) + flash) + unembed
    # decode at 3 valid entries: the state 4·4·4·2 = 128 a Mamba2 layer, 3·4·16 = 192
    assert counts.decode_flops(SMALL, 1, 3) == 2 * (mamba + mlp + 128) + 2 * (attn + mlp + 192) \
        + unembed


def test_the_cells_prefill_is_what_the_issue_estimates():
    cfg = harness.load_json(harness.ROOT / "portbench/configs/granite-4.0-h-micro.json")
    flops = counts.prefill_flops(cfg["sizes"], 4, 32768)
    # 195.3e12 in projections and MLPs, 17.6e12 in attention, 6.2e12 in the scans
    assert 219e12 < flops < 220e12


# -- the readers ----------------------------------------------------------------------------

PROFILED = {"t0": 100.0, "t1": 101.0, "window_s": 1.0, "busy_s": 0.25}


def _read(metric: str, records: dict):
    return harness.load_by_name("metrics", metric).read(records)


@pytest.mark.parametrize("metric, shape, bound", [
    ("flash_attention_roofline", "flash_shape", counts.flash_bound_s),
    ("decode_attention_roofline", "decode_shape", counts.decode_attention_bound_s)])
def test_attention_rooflines(metric, shape, bound):
    dims = {"B": 4, "KV": 8, "G": 4, "hd": 64, "itemsize": 2}
    dims.update({"S": 32768} if shape == "flash_shape" else {"C": 32769})
    least = bound(H100, **dims)
    rng = "kernel." + metric[:-len("_roofline")]
    kernels = [(100.0, 100.0 + 2 * least, rng), (100.5, 100.5 + 2 * least, rng),
               (100.1, 100.1 + least, "other_kernel")]
    records = {"card": H100, shape: dims, "trace": {**PROFILED, "kernels": kernels}}
    assert _read(metric, records) == pytest.approx(50.0)
    assert _read(metric, {**records, "trace": None}) is None
    assert _read(metric, {**records, shape: None}) is None
    no_range = {**records, "trace": {**PROFILED, "kernels": kernels[2:]}}
    assert _read(metric, no_range) is None  # a program without the range


def test_ssd_roofline_at_the_hybrids_shape():
    from portbench.counts import roofline

    shape = {"B": 4, "S": 32768, "H": 64, "P": 64, "N": 128, "chunk": 256, "itemsize": 2}
    least = roofline.ssd_bound_s(H100, **shape)
    kernels = [(100.0 + i, 100.0 + i + 4 * least, "kernel.ssd_scan") for i in range(3)]
    records = {"card": H100, "ssd_shape": shape, "trace": {**PROFILED, "kernels": kernels}}
    assert _read("ssd_scan_roofline.granite", records) == pytest.approx(25.0)
    assert _read("ssd_scan_roofline.granite", {**records, "trace": None}) is None


def test_cache_mb_reads_both_counters_over_the_inits():
    spans = [("serve.cache.init", float(i), 0.001) for i in range(4)]
    spans.append(("serve.prefill", 0.0, 1.0))
    counters = {"serve.cache.kv_bytes": 4 * 268e6, "serve.cache.state_bytes": 4 * 1e6}
    assert _read("cache_mb.granite", {"spans": spans, "counters": counters}) == \
        pytest.approx(269.0)
    assert _read("cache_mb.granite", {"spans": spans, "counters": {}}) is None
    assert _read("cache_mb.granite", {"spans": spans}) is None  # a program without the counters
    assert _read("cache_mb.granite", {"spans": [], "counters": counters}) is None


@pytest.mark.parametrize("metric, span", [("prefill_ms.granite", "serve.prefill"),
                                          ("decode_step_ms.granite", "serve.decode")])
def test_step_readers(metric, span):
    spans = [(span, float(i), 0.020) for i in range(3)] + [(span, 100.5, 0.9)]
    assert _read(metric, {"spans": spans, "trace": PROFILED}) == pytest.approx(20.0)
    assert _read(metric, {"spans": [("other", 0.0, 1.0)], "trace": PROFILED}) is None


def test_idle_and_mfu_readers():
    assert _read("device_idle_share.granite", {"trace": PROFILED}) == pytest.approx(75.0)
    assert _read("device_idle_share.granite", {"trace": None}) is None
    peak = peaks.rate(peaks.BF16_FLOPS, H100)
    records = {"card": H100, "window_s": 11.0, "trace": PROFILED,
               "flop_events": [(1.0, peak), (100.5, 5 * peak), (105.0, 9 * peak)]}
    assert _read("serve_mfu.granite", records) == pytest.approx(100.0)
    assert _read("serve_mfu.granite", {**records, "card": "no such card"}) is None


def test_the_hybrids_files_load_no_jax_and_its_reference_nothing_of_the_program():
    from portbench.tests.test_portbench_imports import _loaded

    top = _loaded("import portbench.run as r\nr._environment()\n"
                  "import portbench.drivers.serving_hybrid, portbench.faults_hybrid\n"
                  "from repro_torch.serving import ServingNode")
    assert "repro_torch" in top and not top & set(harness.FORBIDDEN_MODULES)
    top = _loaded("import portbench.reference.granite_hybrid, portbench.counts.granite_hybrid")
    assert not top & {"repro_torch", *harness.FORBIDDEN_MODULES}
