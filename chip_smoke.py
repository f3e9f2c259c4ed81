"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one NVIDIA GPU and checks it:

1. card     — print ``nvidia-smi`` name and power limit; fail without CUDA;
2. build    — build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels  — K1 (paged decode attention) and K2 (flash attention) against
              their plain PyTorch versions at the main path's shapes, in
              bf16, then timed with CUDA events beside the plain version and
              a library yardstick the port never calls;
4. serve    — stablelm-1.6b at full width (24 layers, random weights from a
              seeded ``torch.Generator``) through ``ServeEngine``: 8
              staggered requests of mixed prompt lengths, 32 new tokens
              each, with every kernel's launch count read around the run;
5. steps    — one ``decode_step_paged`` on a frozen copy of the engine's
              pool and tables with K1 and with the gather oracle, and one
              ``prefill`` with K2 and with the plain path; logits compared;
6. k4       — K4 (the LSDNN layer) against its plain version at the HPEC
              shape T=60000, F=G=1024 (fp32 and bf16, random and HPEC
              data), at ragged shapes and at a cap-saturating case, then
              timed beside its bound, the plain version and
              ``torch.addmm`` + ``clamp_``;
7. lsdnn    — the paper's sparse-DNN workload (``bench/fig13_lsdnn.py``,
              HPEC configuration: 60,000 rows x 1024 neurons x 120 layers,
              2 chained passes) through its sequential, unrolled and
              taskflow paths (the taskflow path: the condition-task cycle
              on the port's Executor, one CUDA-graph replay per pass), with
              K4's launches read around the run; outputs and categories
              checked across the paths and against the plain version;
8. device   — a DEVICE task (saxpy) through the Executor on the card,
              checked against numpy;
9. report   — one JSON line of per-kernel numbers, the card line, and the
              final ``{"ok": true, ...}`` line.

    python3 chip_smoke.py

Exits non-zero, without the final line, when a phase fails or CUDA is
unavailable. Imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, bf16 tensor rate
# (K1, K2) and fp32 rate outside the tensor cores (K4, whose fp32 products
# are exact)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

# tolerances (absolute, bf16 outputs of magnitude <~ 2; one bf16 ulp there
# is 2**-7 ~ 7.8e-3, and the plain flash version rounds its probabilities
# to bf16 before p @ v where the kernel keeps them fp32)
KERNEL_TOL = 2e-2
# decode_step_paged K1 vs gather and prefill K2 vs plain, max |d logits|
# relative to the logits' spread. In bf16 the two paths round at different
# places (the gather oracle rounds its probabilities to bf16 before p @ v,
# the kernels keep fp32) and 24 layers of bf16 activations amplify a one-ulp
# difference; the same step in fp32 compute (the bf16 weights and pool are
# exact in fp32) leaves only the summation order, so its bound is tight.
STEP_REL_TOL = {"bfloat16": 0.25, "float32": 1e-3}

PROMPT_LENS = (16, 24, 32, 57, 90, 128, 200, 300)
MAX_NEW = 32

# the LSDNN phase: the HPEC challenge's 1024-neuron, 120-layer network on
# its 60,000 input rows (bench/fig13_lsdnn.py), 2 chained passes, 8 layers
# per captured DeviceFlow op
LSDNN_ROWS = 60000
LSDNN_PASSES = 2
LSDNN_BLOCK = 8
LSDNN_CAP = 32.0
F32, BF16 = torch.float32, torch.bfloat16
# K4 vs its plain version, max abs error: fp32 1e-4 x cap (the same exact
# fp32 products, summed in another order); bf16 0.3 as the reference's own
# test (one bf16 ulp of an output near the cap is 0.125)
K4_TOL = {F32: 1e-4 * LSDNN_CAP, BF16: 0.3}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS_PER_S):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ------------------------------------------------------------------ phase 1
def phase_card() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    return smi


# ------------------------------------------------------------------ phase 2
def phase_build() -> None:
    from repro_torch.kernels._build import build_info, ensure_built
    ensure_built()
    info = build_info()
    regs = [ln.strip() for ln in info["ptxas"].splitlines()
            if "registers" in ln]
    log(f"[build] {info['seconds']:.2f}s (compiled={info['built']}) -> "
        f"{info['path']}; ptxas: {sorted(set(regs))}")


# ------------------------------------------------------------------ phase 3
def _paged_case(B, H, KV, hd, bs, N, mb, lengths, dev, seed):
    """bf16 pool and disjoint block tables covering ``lengths``; a negative
    length parks the row on the sink block (table of zeros, pos 0)."""
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device=dev).bfloat16()
    pool = torch.randn((2, N, KV, bs, hd), generator=g,
                       device=dev).bfloat16()
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, mb), np.int32)
    for b, ln in enumerate(lengths):
        if ln >= 0:
            for j in range(ln // bs + 1):
                tables[b, j] = free.pop()
    ln = np.maximum(np.asarray(lengths, np.int32), 0)
    return (q, pool, torch.from_numpy(tables).to(dev),
            torch.from_numpy(ln).to(dev))


def phase_kernels(dev):
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         paged_attention_ref)
    report = {}
    # ---- K1 at the serve path's shapes: one layer's pool (2, 128, KV, 16,
    # 64), tables (8, 32); ragged lengths with a sink row (-1) and
    # positions where bs does not divide pos + 1
    bs, N, mb = 16, 128, 32
    lengths = [-1, 15, 16, 47, 100, 200, 331, 255]
    errs = []
    for (H, KV) in ((32, 32), (32, 8)):
        q, pool, tables, ln = _paged_case(8, H, KV, 64, bs, N, mb, lengths,
                                          dev, seed=H + KV)
        out = paged_mod.paged_attention_cuda(q, pool, tables, ln)
        ref = paged_attention_ref(q, pool, tables, ln)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.isfinite(out.float()).all().item()
        log(f"[kernels] K1 paged_attention B=8 H={H} KV={KV} hd=64 bs={bs}"
            f" lengths={lengths}: max|kernel-plain|={err:.3e} "
            f"(tol {KERNEL_TOL})")
        if not ok or err > KERNEL_TOL:
            raise SystemExit(f"K1 disagrees with its plain version: {err}")
        errs.append(err)
    # timing at the MHA serve shape (stablelm: H = KV = 32)
    q, pool, tables, ln = _paged_case(8, 32, 32, 64, bs, N, mb, lengths,
                                      dev, seed=64)
    ms = time_ms(lambda: paged_mod.paged_attention_cuda(q, pool, tables, ln))
    plain_ms = time_ms(lambda: paged_attention_ref(q, pool, tables, ln),
                       iters=10)
    # library yardstick: SDPA over the equivalent CONTIGUOUS cache; the
    # gather that builds it is done once here and excluded from the time
    T = mb * bs
    pages = pool[:, tables.long()]                # (2, B, mb, KV, bs, hd)
    kc, vc = pages.permute(0, 1, 3, 2, 4, 5).reshape(2, 8, 32, T, 64)
    mask = (torch.arange(T, device=dev)[None, :]
            <= ln.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask))
    nb = (ln.long() // bs + 1).clamp(max=mb)
    keys = int(nb.sum()) * bs
    nbytes = 2 * q.numel() * 2 + keys * 32 * 64 * 2 * 2 \
        + int(nb.sum()) * 4 + 8 * 4
    flops = 4.0 * keys * 32 * 64
    b_ms, b_by = bound_ms(nbytes, flops)
    report["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:56",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    log(f"[kernels] K1 timing B=8 H=KV=32: kernel {ms:.4f} ms | plain "
        f"{plain_ms:.4f} ms | SDPA on contiguous cache {lib_ms:.4f} ms "
        f"(gather excluded) | bound {b_ms:.5f} ms ({b_by}; {nbytes} B, "
        f"{flops:.3e} flop)")

    # ---- K2 at the window-0 prefill shape (max_admit=4, C0=128, H=32,
    # hd=64), plus a ragged S and a GQA case
    errs = []
    g = torch.Generator(dev).manual_seed(1)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    cases = [(4, 128, 32, 32, True), (4, 100, 32, 32, True),
             (4, 128, 32, 8, True), (2, 77, 32, 32, False)]
    main = None
    for (B, S, H, KV, causal) in cases:
        q, k, v = mk(B, S, H, 64), mk(B, S, KV, 64), mk(B, S, KV, 64)
        out = flash_mod.flash_attention_cuda(q, k, v, causal=causal)
        ref = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        log(f"[kernels] K2 flash_attention B={B} S=T={S} H={H} KV={KV} "
            f"hd=64 causal={causal}: max|kernel-plain|={err:.3e} "
            f"(tol {KERNEL_TOL})")
        if not torch.isfinite(out.float()).all().item() or err > KERNEL_TOL:
            raise SystemExit(f"K2 disagrees with its plain version: {err}")
        errs.append(err)
        if main is None:
            main = (q, k, v)
    q, k, v = main
    B, S, H, hd = q.shape
    ms = time_ms(lambda: flash_mod.flash_attention_cuda(q, k, v))
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v), iters=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    nbytes = 4 * q.numel() * 2
    flops = 4.0 * B * H * hd * (S * (S + 1) // 2)
    b_ms, b_by = bound_ms(nbytes, flops)
    report["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:39",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    log(f"[kernels] K2 timing B=4 S=T=128 H=32 causal: kernel {ms:.4f} ms "
        f"| plain {plain_ms:.4f} ms | SDPA(is_causal) {lib_ms:.4f} ms | "
        f"bound {b_ms:.5f} ms ({b_by}; {nbytes} B, {flops:.3e} flop)")
    return report


# ------------------------------------------------------------------ phase 4
def phase_serve(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.params import init_params, param_bytes
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("stablelm-1.6b")             # full width and depth
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: L={cfg.num_layers} D={cfg.d_model} "
        f"H={cfg.num_heads} KV={cfg.num_kv_heads} hd={cfg.hd} "
        f"F={cfg.d_ff} V={cfg.vocab_size}; weights "
        f"{param_bytes(params) / 1e9:.3f} GB bf16 in "
        f"{time.perf_counter() - t0:.1f}s")

    # freeze one mid-run decode chunk's inputs for phase 5: the engine
    # calls lm.decode_chunk_paged through the module, so a wrapper sees the
    # exact pool/tables/carry (copied before the chunk writes to the pool)
    frozen = {}
    real_chunk = lm.decode_chunk_paged

    def spy(cfg_, params_, pool, tables, carry, n, **kw):
        if "pool" not in frozen and int((carry[2] > 0).sum()) \
                >= len(PROMPT_LENS) // 2:
            frozen.update(pool=pool.clone(), tables=tables.clone(),
                          carry=tuple(c.clone() for c in carry))
        return real_chunk(cfg_, params_, pool, tables, carry, n, **kw)

    lm.decode_chunk_paged = spy
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    eng = ServeEngine(cfg, params, decode_chunk=8, max_batch=8,
                      kv_blocks=128, block_size=16, device=dev)
    try:
        mem0 = torch.cuda.memory_allocated()
        log(f"[serve] engine: pool {tuple(eng._pkv.shape)} "
            f"{eng._pkv.numel() * 2 / 1e6:.1f} MB, paged_impl="
            f"{eng.paged_impl}, "
            f"prefill_chunk={eng.prefill_chunk}")
        # warm-up request (cuBLAS handles, allocator), outside the counts
        eng.result(eng.submit(prompts[0][:8], max_new=2))
        torch.cuda.synchronize()
        stats0 = dict(eng.stats)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = []
        for p in prompts:
            reqs.append(eng.submit(p, max_new=MAX_NEW))
            time.sleep(0.02)
        outs = [eng.result(r, timeout=600.0) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        lm.decode_chunk_paged = real_chunk
        eng.close()
    stats = {k: v - stats0.get(k, 0) for k, v in eng.stats.items()}
    for p, o in zip(prompts, outs):
        if o.shape != (MAX_NEW,) or not ((o >= 0) & (o < cfg.vocab_size)
                                         ).all():
            raise SystemExit(f"bad output for prompt len {len(p)}: {o}")
    if eng._pool.num_free != eng._pool.num_blocks - 1:
        raise SystemExit(f"blocks leaked: {eng._pool.num_free} free of "
                         f"{eng._pool.num_blocks - 1}")
    steps = stats["decode_cycles"] * eng.decode_chunk
    L = cfg.num_layers
    if counts["paged_attention"] < L * steps or steps == 0:
        raise SystemExit(f"K1 launches {counts['paged_attention']} < "
                         f"{L} x {steps} decode steps")
    if counts["flash_attention"] < L * stats["prefills"] \
            or stats["prefills"] == 0:
        raise SystemExit(f"K2 launches {counts['flash_attention']} < "
                         f"{L} x {stats['prefills']} window-0 prefills")
    ttft = sorted(r.ttft for r in reqs)
    tok = len(prompts) * MAX_NEW
    log(f"[serve] {len(prompts)} requests, prompts {list(PROMPT_LENS)}, "
        f"max_new {MAX_NEW}: {tok} tokens in {wall:.3f}s = "
        f"{tok / wall:.1f} tok/s | TTFT p50 {ttft[len(ttft) // 2]:.4f}s "
        f"max {ttft[-1]:.4f}s | stats {stats}")
    log(f"[serve] launches {counts} over {steps} decode steps and "
        f"{stats['prefills']} window-0 prefills; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(resident before run {mem0 / 1e9:.2f} GB); all "
        f"{eng._pool.num_blocks - 1} non-sink blocks free")
    log(f"[serve] sample: {outs[0][:16].tolist()}")
    if "pool" not in frozen:
        raise SystemExit("no decode chunk with a full batch was seen")
    return cfg, params, prompts, frozen, counts


# ------------------------------------------------------------------ phase 5
def _compare(name, a, b, tol):
    """Logit agreement of two (B, V) fp32 tensors: relative max error, top-1
    agreement, and at the first disagreeing row its top-2 margin."""
    spread = b.std().item()
    rel = (a - b).abs().max().item() / spread
    ta, tb = a.argmax(-1), b.argmax(-1)
    agree = (ta == tb).float().mean().item()
    msg = f"[steps] {name}: max|d|/std = {rel:.3e} (tol {tol}), " \
          f"top-1 agreement {agree:.3f} over {len(ta)} rows"
    bad = (ta != tb).nonzero()
    if len(bad):
        r = int(bad[0])
        top2 = b[r].topk(2).values
        msg += f"; first flip row {r}, top-2 margin " \
               f"{(top2[0] - top2[1]).item():.4e}"
    log(msg)
    if not (rel <= tol and torch.isfinite(a).all()):
        raise SystemExit(f"{name}: logits disagree ({rel} > {tol})")


def phase_steps(cfg, params, prompts, frozen, dev):
    import dataclasses

    from repro_torch.models import lm
    ln, last, rem = frozen["carry"]
    active = rem > 0
    rows = active.nonzero()[:, 0]
    # the window-0 shape: max_admit=4 rows of C0=128 tokens
    toks = torch.from_numpy(np.stack([np.resize(p, 128)
                                      for p in prompts[4:]])).to(dev)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = {k: ({kk: vv.float() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in params.items()}
    with torch.inference_mode():
        for dt, c, p in (("bfloat16", cfg, params),
                         ("float32", cfg32, params32)):
            pool = frozen["pool"].to(getattr(torch, dt))
            out = {}
            for impl in ("kernel", "gather"):
                out[impl], _ = lm.decode_step_paged(
                    c, p, pool.clone(), frozen["tables"], ln, last, active,
                    impl=impl)
            _compare(f"{dt} decode_step_paged K1 vs gather",
                     out["kernel"][rows], out["gather"][rows],
                     STEP_REL_TOL[dt])
            lf, cf = lm.prefill(c, p, toks, impl="flash")
            lp, cp = lm.prefill(c, p, toks, impl="chunked")
            _compare(f"{dt} prefill K2 vs plain", lf, lp, STEP_REL_TOL[dt])
            kd = (cf["k"].float() - cp["k"].float()).abs().max().item()
            log(f"[steps] {dt} prefill cache k max|flash-plain| = {kd:.3e}")
            del pool, out


# ------------------------------------------------------------------ phase 6
def phase_k4(dev):
    from repro_torch.bench.fig13_lsdnn import make_hpec
    from repro_torch.kernels import lsdnn_layer as lsdnn_mod
    from repro_torch.kernels.ref import lsdnn_layer_ref
    g = torch.Generator(dev).manual_seed(4)

    def normal(T, F, G, dtype):
        y = torch.randn((T, F), generator=g, device=dev)
        w = torch.randn((F, G), generator=g, device=dev) * 0.05
        b = torch.randn((G,), generator=g, device=dev)
        return y.to(dtype), w.to(dtype), b.to(dtype)

    net = make_hpec(layers=1, rows=LSDNN_ROWS, seed=1)
    hpec = tuple(torch.from_numpy(a).to(dev)
                 for a in (net.y0, net.ws[0], net.b))
    ones = (torch.full((64, 64), 10.0, device=dev),
            torch.ones((64, 64), device=dev), torch.zeros(64, device=dev))
    cases = [("HPEC shape, normal", normal(LSDNN_ROWS, 1024, 1024, F32)),
             ("HPEC shape, normal", normal(LSDNN_ROWS, 1024, 1024, BF16)),
             ("HPEC layer 0, binary rows", hpec),
             ("ragged T and G", normal(1000, 1024, 1000, F32)),
             ("ragged T and G", normal(1000, 1024, 1000, BF16)),
             ("F, G not multiples of 4", normal(999, 130, 257, F32)),
             ("cap-saturating", ones),
             ("cap-saturating", tuple(t.to(BF16) for t in ones))]
    errs = []
    for what, (y, w, b) in cases:
        out = lsdnn_mod.lsdnn_layer_cuda(y, w, b, cap=LSDNN_CAP)
        ref = lsdnn_layer_ref(y, w, b, cap=LSDNN_CAP)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = K4_TOL[y.dtype]
        log(f"[k4] {what} T={y.shape[0]} F={y.shape[1]} G={w.shape[1]} "
            f"{str(y.dtype)[6:]}: max|kernel-plain|={err:.3e} (tol {tol}), "
            f"max {out.float().max().item():.4g}")
        if not torch.isfinite(out.float()).all().item() or err > tol:
            raise SystemExit(f"K4 disagrees with its plain version: {err}")
        if what == "cap-saturating" and out.float().max().item() != LSDNN_CAP:
            raise SystemExit("K4 did not clamp at the cap")
        errs.append(err)
    # timing at the HPEC shape on dense normal data (the kernel's work does
    # not depend on the data: it multiplies the dense form)
    y, w, b = cases[0][1]
    T, Fd = y.shape
    G = w.shape[1]
    ms = time_ms(lambda: lsdnn_mod.lsdnn_layer_cuda(y, w, b), iters=20)
    plain_ms = time_ms(lambda: lsdnn_layer_ref(y, w, b), iters=10)
    lib_ms = time_ms(lambda: torch.addmm(b, y, w).clamp_(0.0, LSDNN_CAP),
                     iters=20)
    nbytes = 4 * (T * Fd + Fd * G + G + T * G)
    flops = 2.0 * T * Fd * G
    b_ms, b_by = bound_ms(nbytes, flops, FP32_FLOPS_PER_S)
    hy, hw, hb = hpec
    hpec_ms = time_ms(lambda: lsdnn_mod.lsdnn_layer_cuda(hy, hw, hb),
                      iters=20)
    log(f"[k4] timing T={T} F=G={Fd} fp32: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s) | plain {plain_ms:.4f} ms | "
        f"torch.addmm + clamp_ (two calls, TF32 off) {lib_ms:.4f} ms | "
        f"bound {b_ms:.4f} ms ({b_by}; fp32 non-tensor peak "
        f"{FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; {nbytes} B, {flops:.3e} "
        f"flop) | on the HPEC layer (binary rows, 3% of W nonzero) "
        f"{hpec_ms:.4f} ms")
    return dict(name="lsdnn_layer", route="cuda",
                source="src/repro_torch/kernels/csrc/lsdnn_layer.cu",
                replaces="src/repro/kernels/lsdnn_layer.py:24",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


# ------------------------------------------------------------------ phase 7
def phase_lsdnn(dev) -> int:
    from repro_torch.bench import fig13_lsdnn as fb
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    net = fb.make_hpec(rows=LSDNN_ROWS, seed=0)
    layers, rows = len(net.ws), net.y0.shape[0]
    log(f"[lsdnn] HPEC network: {layers} layers x {net.y0.shape[1]} neurons,"
        f" {rows} rows, {fb.HPEC_NNZ} weights of 1/16 per neuron, bias "
        f"{fb.HPEC_BIAS}, cap {net.cap}; {LSDNN_PASSES} chained passes, "
        f"{LSDNN_BLOCK} layers per captured op; made in "
        f"{time.perf_counter() - t0:.1f}s")
    ops.reset_launch_counts()
    res = fb.run_paths(net, LSDNN_PASSES, LSDNN_BLOCK, dev)
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    plain = fb.plain_output(net, LSDNN_PASSES, dev)
    plain_s = time.perf_counter() - t0
    for name, r in res.items():
        log(f"[lsdnn] {name}: {r.ms:.1f} ms, {r.calls} host launches, "
            f"{r.kernel_launches} K4 launches on the device, tasks "
            f"{r.tasks}, peak device {r.peak_device_mb:.0f} MiB above the "
            f"path's start, process peak RSS {r.peak_rss_mb:.0f} MiB "
            f"{r.graph or ''}")
    ref = res["sequential"]
    cats = fb.categories(ref.y)
    for name, r in res.items():
        err = float(np.abs(r.y - ref.y).max())
        if not np.isfinite(r.y).all() or err > K4_TOL[F32]:
            raise SystemExit(f"lsdnn {name} disagrees with sequential: {err}")
        if not np.array_equal(fb.categories(r.y), cats):
            raise SystemExit(f"lsdnn {name}: categories differ")
    plain_cats = fb.categories(plain)
    diff = np.abs(plain - ref.y)
    log(f"[lsdnn] categories: {len(cats)} of {rows} rows active, identical "
        f"across the three paths; plain version ({plain_s:.1f}s): "
        f"{len(plain_cats)} rows, identical={np.array_equal(plain_cats, cats)}"
        f"; max|kernel-plain| {diff.max():.3e} over {int((diff > 0).sum())} "
        f"differing outputs; output max {ref.y.max():.4g}")
    if not np.array_equal(plain_cats, cats):
        raise SystemExit("lsdnn: categories differ from the plain version")
    if not 0 < len(cats) < rows:
        raise SystemExit(f"lsdnn: {len(cats)} of {rows} rows active")
    if res["taskflow"].calls != LSDNN_PASSES:
        raise SystemExit(f"taskflow launches {res['taskflow'].calls} != "
                         f"{LSDNN_PASSES} passes")
    k4 = sum(r.kernel_launches for r in res.values())
    wrapper = res["sequential"].kernel_launches \
        + res["unrolled"].kernel_launches + res["taskflow"].graph["wrapper_k4"]
    if counts["lsdnn_layer"] != wrapper:
        raise SystemExit(f"K4 wrapper count {counts['lsdnn_layer']} != the "
                         f"paths' {wrapper}")
    if k4 < 3 * layers * LSDNN_PASSES:
        raise SystemExit(f"K4 device launches {k4} < 3 x {layers} x "
                         f"{LSDNN_PASSES}")
    log(f"[lsdnn] K4 launches: {counts['lsdnn_layer']} wrapper calls, {k4} "
        f"on the device (eager calls + {res['taskflow'].graph['captured_k4']}"
        f" captured x {res['taskflow'].graph['replays']} replays)")
    print(json.dumps({"lsdnn": {n: v for n, v, _ in fb.rows_of(res)}}),
          flush=True)
    return k4


# ------------------------------------------------------------------ phase 8
def phase_device_task(dev) -> None:
    from repro_torch.core import ACCEL, HOST, DeviceFlow, Executor, Taskflow
    n = 1 << 16
    x = np.ones(n, np.float32)
    y = np.full(n, 2.0, np.float32)
    got = {}

    def saxpy(df: DeviceFlow):
        df.copy("x", x).copy("y", y)
        df.kernel(lambda x, y: 2.0 * x + y, ["x", "y"], ["z"])
        df.fetch("z")
        got["df"] = df

    ex = Executor(domains={HOST: 1, ACCEL: 1}, devices={ACCEL: [dev]})
    try:
        tf = Taskflow("saxpy")
        t = tf.device(saxpy)
        check = tf.static(lambda: got.__setitem__("z", got["df"].result("z")))
        t.precede(check)
        ex.run(tf).wait()
    finally:
        ex.shutdown()
    df = got["df"]
    ok = np.array_equal(got["z"], 2.0 * x + y)
    log(f"[device] DEVICE task saxpy n={n} on {df.device}: one CUDA-graph "
        f"replay (num_launches={df.num_launches}), equal to numpy: {ok}")
    if not ok or df.num_launches != 1:
        raise SystemExit("DEVICE task saxpy failed")


# ------------------------------------------------------------------ main
def main() -> None:
    t_start = time.perf_counter()
    smi = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    report = phase_kernels(dev)
    cfg, params, prompts, frozen, counts = phase_serve(dev)
    phase_steps(cfg, params, prompts, frozen, dev)
    del params, frozen
    gc.collect()              # free the serve phase's weights and pool
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False   # K4's plain version
    report["lsdnn_layer"] = phase_k4(dev)
    report["lsdnn_layer"]["launches"] = phase_lsdnn(dev)
    phase_device_task(dev)
    report["paged_attention"]["launches"] = counts["paged_attention"]
    report["flash_attention"]["launches"] = counts["flash_attention"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{k: report[n][k] for k in keys}
               for n in ("paged_attention", "flash_attention", "lsdnn_layer")]
    if "jax" in sys.modules:
        raise SystemExit("jax was imported")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
