"""The port's roofline (``repro_torch.roofline``) on the CPU: every
registry op's work function, the Bound column of PERF.md's kernel table
reproduced from the work functions and ``H100``, ``analyze`` counting a
registry op by its work and a matmul as ``FlopCounterMode`` does, and
``model_flops`` against the JAX package's."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as J_ARCHS, SHAPES as J_SHAPES
from repro.roofline.analysis import model_flops as j_model_flops
from repro_torch import roofline
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.kernels import registry
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.roofline import H100

BF, F32 = torch.bfloat16, torch.float32


def _t(*shape, dtype=F32):
    """A tensor of this shape and dtype that holds no memory."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _gather(k, r, m, n, distinct):
    rows = _t(n, -(-r // 4) * 4)
    return ("gram_gather", (rows, _t(k, m, dtype=torch.int64), r, 1.0 / m),
            dict(distinct=distinct))


def _prox_block(op, k, d, **kw):
    vecs = {"prox_step_block": 2, "prox_loop_block": 1}[op]
    return (op, (_t(k, d, d), _t(k, d), *[_t(d)] * vecs, _t(5)), kw)


def _pdhg(k, d):
    return ("pdhg_block", (_t(k, d, d), _t(k, d), _t(d), _t(d), _t(5),
                           _t(1)), {})


def _attn(op, B, Hq, Hkv, Sq, Skv, D, causal, **kw):
    q, kv = _t(B, Sq, Hq, D, dtype=BF), _t(B, Skv, Hkv, D, dtype=BF)
    rows = _t(B, Hq, Sq)
    args = (q, kv, kv) if op == "flash_attention" else \
        (q, kv, kv, q, rows, rows)
    return (op, args, dict(causal=causal, **kw))


def _paged(Hq, Hkv, D, lens=None, int8=False):
    B, P, npages = 8, 16, 64
    valid = (np.linspace(1, min(npages * P, 1024), B) if lens is None
             else np.asarray(lens)).astype(np.int32)
    pool = _t(1 + B * npages, P, Hkv, D, dtype=torch.int8 if int8 else BF)
    kw = dict(k_scale=_t(1 + B * npages, P, Hkv),
              v_scale=_t(1 + B * npages, P, Hkv)) if int8 else {}
    return ("paged_attention", (_t(B, 1, Hq, D, dtype=BF), pool, pool,
                                _t(B, npages, dtype=torch.int32),
                                torch.from_numpy(valid)), kw)


def _ssd(op, Bt, S, H, P, N, **kw):
    x, bc = _t(Bt, S, H, P, dtype=BF), _t(Bt, S, N, dtype=BF)
    args = (x, _t(Bt, S, H), _t(H), bc, bc)
    if op == "ssd_bwd":
        args += (x, _t(Bt, H, -(-S // 64), P, N), _t(Bt, H, P, N))
    return (op, args, dict(chunk=64, **kw))


#: (PERF.md row: the # column and the shape, the call, the Bound column's
#: value as printed, what bounds it; with ``f32`` the bracketed float32
#: CUDA-core floor)
BOUNDS = [
    ("1 gram covtype CA block", ("gram", (_t(32, 55, 58_101),), {}),
     "0.1222", "bytes"),
    ("1 gram susy CA block", ("gram", (_t(32, 19, 500_000),), {}),
     "0.3630", "bytes"),
    ("1 gram covtype draw", ("gram", (_t(1, 55, 58_101),), {}),
     "0.0038", "bytes"),
    ("1 gram susy draw", ("gram", (_t(1, 19, 500_000),), {}),
     "0.0113", "bytes"),
    ("1 gram_gather covtype CA block",
     _gather(32, 55, 58_101, 581_010, 557_444), "0.0855", "operations"),
    ("1 gram_gather covtype, every drawn row",
     _gather(32, 55, 58_101, 581_010, 32 * 58_101), "0.1267", "bytes"),
    ("1 gram_gather susy CA block",
     _gather(32, 19, 500_000, 5_000_000, 4_796_219), "0.1470", "bytes"),
    ("1 gram_gather susy, every drawn row",
     _gather(32, 19, 500_000, 5_000_000, 16_000_000), "0.4012", "bytes"),
    # the classical draws: the distinct counts of the smoke's draws
    ("1 gram_gather covtype draw", _gather(1, 55, 58_101, 581_010, 55_283),
     "0.0038", "bytes"),
    ("1 gram_gather susy draw",
     _gather(1, 19, 500_000, 5_000_000, 475_803), "0.0120", "bytes"),
    ("1 gram BCD cross-Gram", ("gram", (_t(1, 160, 581_010),), {}),
     "0.2234", "operations"),
    ("1 gram dual SVM", ("gram", (_t(2, 4096, 5),), {}), "0.0401", "bytes"),
    ("2 prox_step_block covtype", _prox_block("prox_step_block", 32, 54,
                                              j0=1), "0.0001157", "bytes"),
    ("2 prox_step d=54", ("prox_step", (_t(54, 54), _t(54), _t(54), _t(5)),
                          {}), "0.0000037", "bytes"),
    ("2 rows route FISTA d=4096", _prox_block("prox_step_block", 1, 4096,
                                              j0=5), "0.0201", "bytes"),
    ("2 rows route FISTA d=20480", _prox_block("prox_step_block", 1, 20_480,
                                               j0=5), "0.5009", "bytes"),
    ("3 prox_loop_block susy", _prox_block("prox_loop_block", 32, 18, Q=5),
     "0.00001378", "bytes"),
    ("3 prox_loop d=18", ("prox_loop", (_t(18, 18), _t(18), _t(18), _t(5)),
                          dict(Q=5)), "0.0000005", "bytes"),
    ("3 rows route PNM d=4096", _prox_block("prox_loop_block", 1, 4096, Q=5),
     "0.1002", "bytes"),
    ("3 rows route PNM d=20480", _prox_block("prox_loop_block", 1, 20_480,
                                             Q=5), "2.5041", "bytes"),
    ("2 pdhg_block covtype", _pdhg(32, 54), "0.0001157", "bytes"),
    ("2 pdhg rows d=4096", _pdhg(1, 4096), "0.0201", "bytes"),
    ("2 pdhg rows d=20480", _pdhg(1, 20_480), "0.5009", "bytes"),
    ("4 flash_attention S=512", _attn("flash_attention", 2, 16, 8, 512, 512,
                                      128, True), "0.0038", "bytes"),
    ("4 flash_attention S=512 float32 floor",
     _attn("flash_attention", 2, 16, 8, 512, 512, 128, True, f32=True),
     "0.0321", "operations"),
    ("4 flash_attention S=1024", _attn("flash_attention", 2, 16, 8, 1024,
                                       1024, 128, True), "0.0087",
     "operations"),
    ("4 flash_attention S=1024 float32 floor",
     _attn("flash_attention", 2, 16, 8, 1024, 1024, 128, True, f32=True),
     "0.1283", "operations"),
    ("4 lse forward", _attn("flash_attention", 8, 16, 8, 1024, 1024, 128,
                            True, return_lse=True), "0.0348", "operations"),
    ("4 lse forward float32 floor",
     _attn("flash_attention", 8, 16, 8, 1024, 1024, 128, True,
           return_lse=True, f32=True), "0.5133", "operations"),
    ("4 whisper encoder", _attn("flash_attention", 2, 16, 16, 1500, 1500,
                                64, False), "0.01864", "operations"),
    ("4 whisper encoder float32 floor",
     _attn("flash_attention", 2, 16, 16, 1500, 1500, 64, False, f32=True),
     "0.2751", "operations"),
    ("4 whisper cross", _attn("flash_attention", 2, 16, 16, 448, 1500, 64,
                              False), "0.00557", "operations"),
    ("4 whisper cross decode", _attn("flash_attention", 2, 16, 16, 1, 1500,
                                     64, False), "0.00367", "bytes"),
    ("4 qwen2-vl", _attn("flash_attention", 2, 12, 2, 1536, 1536, 128, True),
     "0.01467", "operations"),
    ("4 granite", _attn("flash_attention", 2, 16, 8, 512, 512, 64, True),
     "0.00188", "bytes"),
    ("4 zamba2 D=80", _attn("flash_attention", 2, 32, 32, 512, 512, 80,
                            True), "0.00626", "bytes"),
    ("5 flash_dq", _attn("flash_dq", 8, 16, 8, 1024, 1024, 128, True),
     "0.0522", "operations"),
    ("5 flash_dq float32 floor", _attn("flash_dq", 8, 16, 8, 1024, 1024,
                                       128, True, f32=True), "0.7700",
     "operations"),
    ("6 flash_dkv", _attn("flash_dkv", 8, 16, 8, 1024, 1024, 128, True),
     "0.0696", "operations"),
    ("6 flash_dkv float32 floor", _attn("flash_dkv", 8, 16, 8, 1024, 1024,
                                        128, True, f32=True), "1.0267",
     "operations"),
    ("5 whisper encoder dq", _attn("flash_dq", 2, 16, 16, 1500, 1500, 64,
                                   False), "0.02796", "operations"),
    ("6 whisper encoder dkv", _attn("flash_dkv", 2, 16, 16, 1500, 1500, 64,
                                    False), "0.03727", "operations"),
    ("5 whisper cross dq", _attn("flash_dq", 2, 16, 16, 448, 1500, 64,
                                 False), "0.00835", "operations"),
    ("6 whisper cross dkv", _attn("flash_dkv", 2, 16, 16, 448, 1500, 64,
                                  False), "0.01113", "operations"),
    ("4 granite train lse", _attn("flash_attention", 8, 16, 8, 1024, 1024,
                                  64, True, return_lse=True), "0.01739",
     "operations"),
    ("5 granite train dq", _attn("flash_dq", 8, 16, 8, 1024, 1024, 64, True),
     "0.02608", "operations"),
    ("6 granite train dkv", _attn("flash_dkv", 8, 16, 8, 1024, 1024, 64,
                                  True), "0.03478", "operations"),
    ("5 qwen2-vl dq", _attn("flash_dq", 2, 12, 2, 1536, 1536, 128, True),
     "0.02200", "operations"),
    ("6 qwen2-vl dkv", _attn("flash_dkv", 2, 12, 2, 1536, 1536, 128, True),
     "0.02933", "operations"),
    ("4 llama3-8b tp lse", _attn("flash_attention", 8, 8, 2, 1024, 1024,
                                 128, True, return_lse=True), "0.01739",
     "operations"),
    ("6 llama3-8b tp dkv", _attn("flash_dkv", 4, 16, 4, 1024, 1024, 128,
                                 True), "0.03478", "operations"),
    ("7 paged_decode bf16", _paged(16, 8, 128), "0.0050", "bytes"),
    ("7 paged_decode int8", _paged(16, 8, 128, int8=True), "0.0026",
     "bytes"),
    ("7 granite engine", _paged(16, 8, 64), "0.00252", "bytes"),
    ("7 qwen2-vl engine", _paged(12, 2, 128), "0.00127", "bytes"),
    ("7 whisper engine", _paged(16, 16, 64), "0.00502", "bytes"),
    ("7 deepseek engine", _paged(16, 16, 128), "0.01004", "bytes"),
    ("7 zamba2 engine D=80", _paged(32, 32, 80), "0.01255", "bytes"),
    ("8 ssd", _ssd("ssd", 8, 1024, 48, 64, 128), "0.0355", "bytes"),
    ("8 ssd with the states", _ssd("ssd", 8, 1024, 48, 64, 128,
                                   return_states=True), "0.0956", "bytes"),
    ("8 ssd float32 floor, with the states",
     _ssd("ssd", 8, 1024, 48, 64, 128, return_states=True, f32=True),
     "0.2656", "operations"),
    ("9 ssd_bwd", _ssd("ssd_bwd", 8, 1024, 48, 64, 128), "0.2463", "bytes"),
    ("9 ssd_bwd float32 floor", _ssd("ssd_bwd", 8, 1024, 48, 64, 128,
                                     f32=True), "0.6761", "operations"),
    ("8 ssd zamba2", _ssd("ssd", 2, 512, 80, 64, 64), "0.00722", "bytes"),
]


@pytest.mark.parametrize("row", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_bound_column_from_work_functions(row):
    _, (op, args, kw), printed, by = row
    kw = dict(kw)
    f32 = kw.pop("f32", False)
    w = registry.work(op, *args, **kw)
    if f32:
        w = registry.Work(w.flops, w.bytes, torch.float32)
    ms, got_by = roofline.bound_ms(w, H100)
    decimals = len(printed.split(".")[1])
    assert f"{ms:.{decimals}f}" == printed
    assert got_by == by


def test_every_registered_op_has_a_work_function():
    assert sorted(registry.work_functions()) == registry.ops()


def test_paged_work_counts_the_engine_lengths():
    """Lengths that sum to the engine's 2,420 valid positions: PERF.md
    row 7 (the bytes depend on the sum alone)."""
    lens = [302, 301, 302, 303, 302, 302, 305, 303]
    op, args, kw = _paged(16, 8, 128, lens=lens)
    w = registry.work(op, *args, **kw)
    assert w.flops == 4.0 * sum(lens) * 16 * 128
    ms, by = roofline.bound_ms(w)
    assert (f"{ms:.4f}", by) == ("0.0030", "bytes")


def test_analyze_counts_a_registry_op_by_its_work():
    """Under use("torch") the gram op runs its float64 plain version; the
    analysis counts the op's Work once and none of those aten ops, and
    the matmul after it as FlopCounterMode counts it."""
    gen = torch.Generator().manual_seed(0)
    Xs = torch.randn(2, 8, 100, generator=gen)
    A = torch.randn(8, 8, generator=gen)

    def fn():
        G = registry.dispatch("gram", Xs)
        return G @ A

    with registry.use("torch"):
        r = roofline.analyze(fn)
        with FlopCounterMode(display=False) as fc:
            Xs.new_zeros(2, 8, 8) @ A
    w = registry.work("gram", Xs)
    mm = fc.get_total_flops()
    assert r.registry_ops == {"gram": 1}
    assert r.flops == w.flops + mm
    # the bmm: (2, 8, 8) @ (8, 8) at float32: inputs read, output written
    assert r.bytes_hbm == w.bytes + 4 * (2 * 64 + 64 + 2 * 64)
    assert r.t_compute == pytest.approx((w.flops + mm) / H100.peak_flops_f32)
    assert r.t_memory == pytest.approx(r.bytes_hbm / H100.hbm_bw)
    assert r.bottleneck == "memory" and r.t_collective == 0.0
    # the plain version alone, outside the analysis: its aten ops are many
    with registry.use("torch"), FlopCounterMode(display=False) as fc2:
        gram_ref.gram(Xs)
    assert fc2.get_total_flops() > 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_match_jax(arch):
    for name, shape in SHAPES.items():
        for kind in ("train", "prefill", "decode"):
            assert roofline.model_flops(ARCHS[arch], shape, 1_234_567,
                                        kind) == j_model_flops(
                J_ARCHS[arch], J_SHAPES[name], 1_234_567, kind)


def test_mfu_is_model_flops_over_seconds_at_the_bf16_peak():
    assert roofline.mfu(H100.peak_flops_bf16, 2.0) == pytest.approx(0.5)


def test_storage_tracker_splits_by_the_open_tag():
    """Live storage is split at its peak by the ``roofline.category`` tag
    open where it was allocated (untagged: activations), freed storage
    leaves the count, and large allocations are listed with the live
    bytes before each."""
    x = torch.ones(256)                                   # 1 KiB

    def fn():
        with roofline.category("compute_copy"):
            a = x * 2                                     # 1 KiB
        with roofline.category("accumulator_staging"):
            b = torch.zeros(512)                          # 2 KiB
            with roofline.category("compute_copy"):       # innermost
                c = torch.zeros(128)                      # 512 B
        t = a + b[:256]                                   # 1 KiB, freed
        del t
        return a, b, c, x + 1                             # + 1 KiB

    tracker = roofline.StorageTracker(large_bytes=2048)
    tracker.add(x, "state")
    r = roofline.analyze(fn, tracker=tracker)
    mem = r.per_device_memory
    assert mem["peak_live_bytes"] == 1024 + 1024 + 2048 + 512 + 1024
    assert mem["at_peak"] == {"state": 1024, "compute_copy": 1536,
                              "accumulator_staging": 2048,
                              "activations_temporaries": 1024}
    assert mem["large_allocations"] == [(2048, 2048, "accumulator_staging")]
    assert roofline.analysis.current_category() == "activations_temporaries"
