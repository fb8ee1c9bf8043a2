#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (fl4health_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. Require CUDA; print the card's name and power limit (nvidia-smi).
  2. Build the flash-attention extension from kernels/csrc (sm_90a).
  3. Hold the forward, dQ and dK/dV kernels against their plain PyTorch
     versions at the main path's shapes (B=32, T=2048, H=8, D=64, ragged pad
     masks, one batch element with no real key) in f32 and bf16, and at a T
     that is not a multiple of the 64-row tile; time each kernel, its plain
     version and F.scaled_dot_product_attention (a yardstick the port never
     calls) with CUDA events.
  4. A tiny federated run on the card (kernels) against the same run on the
     CPU (plain version): per-round losses and final params within 5e-4.
  5. The main path: federated training of the transformer_long configuration
     at full width (vocab 8192, d_model 512, 8 heads, 4 layers, d_ff 2048,
     T 2048, remat, bf16 compute / f32 params) for 2 FedAvg rounds of
     2 clients x 5 local SGD steps of batch 32, with the launch counts set to 0
     just before and read just after.
Then one JSON line per kernel set, the card line again, and the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

B, T, H, D = 32, 2048, 8, 64
RAGGED_T = 2000  # not a multiple of the kernels' 64-row tile
N_CLIENTS, BATCH, LOCAL_STEPS, ROUNDS = 2, 32, 5, 2

# (atol, rtol) per output. f32 are the JAX kernel tests' bounds
# (tests/kernels/test_flash_attention.py). bf16 hold the kernel (bf16 in and
# out, f32 inside) against the plain version in f32 on the same bf16-rounded
# inputs: both compute in f32, so they differ by the one bf16 rounding of
# out, dq, dk and dv (at most 2^-8 relative; rtol is twice that) plus f32
# summation noise (about 1e-6 here; atol is 100 times that). lse stays f32 in
# the kernel, so it keeps the f32 bound.
TOL = {
    torch.float32: {"out": (2e-5, 1e-4), "lse": (2e-5, 1e-4), "grad": (5e-4, 1e-4)},
    torch.bfloat16: {"out": (1e-4, 2**-7), "lse": (2e-5, 1e-4), "grad": (1e-4, 2**-7)},
}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores; f32 on the
# CUDA cores (f32 here must not use TF32); HBM3 bandwidth
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
SOURCE = "fl4health_tpu_torch/kernels/csrc/flash_attention.cu"


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
          rtol: float) -> float:
    """max |got - want|; fails where |got - want| > atol + rtol |want|."""
    return check_stats(name, got, want, atol, rtol)["max_abs_err"]


def check_stats(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
                rtol: float) -> dict:
    """As ``check``, with the size of the values held and the largest share
    of the bound that an element used."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    bound = atol + rtol * want.abs()
    bad = diff > bound
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements beyond atol={atol} rtol={rtol}, "
             f"max abs err {float(diff.max()):.3e}")
    return {"max_abs_err": float(diff.max()), "mean_abs_ref": float(want.abs().mean()),
            "max_abs_ref": float(want.abs().max()),
            "bound_used": float((diff / bound).max())}


def attention_inputs(b: int, t: int, dtype: torch.dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, t, H, D), generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    dlse = torch.randn((b, H, t), generator=g, device="cuda")
    lengths = np.random.default_rng(seed).integers(t // 2, t + 1, size=b)
    lengths[-1] = 0  # one batch element with no real key
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]).float().cuda()
    return q, k, v, mask, do, dlse


def plain_grads(fa, q, k, v, mask, do, dlse) -> list[torch.Tensor]:
    """dq, dk, dv of (out, lse) under cotangents (do, dlse), by the plain
    version in f32. f32: autograd through it. bf16: the kernels' contract
    hands out O in bf16 and the backward reads delta = rowsum(dO O) - dlse
    from that O (as the JAX ``_bwd_call`` does), which moves dq and dk by up
    to ~1e-3 against autograd's f32 O; so the plain backward is run on the
    plain forward's bf16 O, in f32 otherwise."""
    if q.dtype == torch.float32:
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o, lse = fa.flash_attention_reference(*leaves, mask)
        torch.autograd.backward([o, lse], [do, dlse])
        return [x.grad for x in leaves]
    with torch.no_grad():
        o, lse = fa.flash_attention_reference(q, k, v, mask)  # o in q.dtype
        delta = fa.backward_delta(do, o, dlse)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        return [fa.flash_bwd_dq_reference(qf, kf, vf, mask, dof, lse, delta),
                *fa.flash_bwd_dkv_reference(qf, kf, vf, mask, dof, lse, delta)]


def kernel_checks(fa, b: int, t: int, dtype: torch.dtype, seed: int,
                  autograd_check: bool) -> dict:
    """Each kernel against its plain version on the same inputs; returns the
    max abs errors and prints them with the size of the values held."""
    tol = TOL[dtype]
    g_atol, g_rtol = tol["grad"]
    q, k, v, mask, do, dlse = attention_inputs(b, t, dtype, seed)
    tag = f"{str(dtype).split('.')[-1]} B={b} T={t}"
    with torch.no_grad():
        out, lse = fa.flash_fwd(q, k, v, mask)
        ref_out, ref_lse = fa.flash_attention_reference(q.float(), k.float(),
                                                        v.float(), mask)
        if not torch.all(out[-1] == 0):
            fail(f"{tag}: a row with no real key must give out = 0")
        stats = {"out": check_stats(f"fwd out {tag}", out, ref_out, *tol["out"]),
                 "lse": check_stats(f"fwd lse {tag}", lse, ref_lse, *tol["lse"])}
        del ref_out, ref_lse
        delta = fa.backward_delta(do, out, dlse)
        dq = fa.flash_bwd_dq(q, k, v, mask, do, lse, delta)
        ref = fa.flash_bwd_dq_reference(q.float(), k.float(), v.float(), mask,
                                        do.float(), lse, delta)
        stats["dq"] = check_stats(f"dq {tag}", dq, ref, g_atol, g_rtol)
        del ref
        dk, dv = fa.flash_bwd_dkv(q, k, v, mask, do, lse, delta)
        ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q.float(), k.float(), v.float(),
                                                    mask, do.float(), lse, delta)
        stats["dk"] = check_stats(f"dk {tag}", dk, ref_dk, g_atol, g_rtol)
        stats["dv"] = check_stats(f"dv {tag}", dv, ref_dv, g_atol, g_rtol)
        del ref_dk, ref_dv, dq, dk, dv
    if autograd_check:
        # the autograd.Function end to end (forward kernel, delta, both
        # backward kernels) against the plain version's gradients
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o, l_ = fa._FlashAttention.apply(*leaves, mask)
        torch.autograd.backward([o.float(), l_], [do.float(), dlse])
        grads = [[x.grad for x in leaves], plain_grads(fa, q, k, v, mask, do, dlse)]
        del o, l_, leaves
        for name, g, w in zip(("dq", "dk", "dv"), *grads):
            stats[f"autograd_{name}"] = check_stats(f"autograd {name} {tag}", g, w,
                                                    g_atol, g_rtol)
        del grads
    worst = lambda *names: max(stats[n]["max_abs_err"] for n in names)  # noqa: E731
    err = {"flash_fwd": worst("out", "lse"), "flash_bwd_dq": worst("dq"),
           "flash_bwd_dkv": worst("dk", "dv")}
    print(json.dumps({"check": tag, "max_abs_err": err, "stats": stats,
                      "tolerance": {name: list(b) for name, b in tol.items()}}))
    torch.cuda.empty_cache()
    return err


def bound_ms(ops: float, nbytes: float, dtype: torch.dtype) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_timings(fa, dtype: torch.dtype) -> dict:
    """Kernel, plain version and SDPA times at the main path's shapes."""
    q, k, v, mask, do, dlse = attention_inputs(B, T, dtype, seed=11)
    es = q.element_size()
    n, rows = q.numel(), B * H * T
    # query rows x real keys, over batch and heads: the work this data needs
    pairs = float(T * H * mask.sum())
    small = mask.numel() * 4 + rows * 4  # mask + one [B,H,T] f32 vector
    with torch.no_grad():
        out, lse = fa.flash_fwd(q, k, v, mask)
        delta = fa.backward_delta(do, out, dlse)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        key_ok = (mask > 0)[:, None, None, :]
        res = {
            "flash_fwd": dict(
                ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, mask)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_reference(q, k, v, mask), reps=3),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=key_ok)),
                bound=bound_ms(4 * D * pairs, 4 * n * es + small, dtype)),
            "flash_bwd_dq": dict(
                ms=cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, mask, do, lse, delta)),
                plain_ms=cuda_ms(lambda: fa.flash_bwd_dq_reference(
                    q, k, v, mask, do, lse, delta), reps=3),
                library_ms=None,  # no library call computes dQ alone
                bound=bound_ms(6 * D * pairs, 5 * n * es + small + rows * 4, dtype)),
            "flash_bwd_dkv": dict(
                ms=cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, mask, do, lse, delta)),
                plain_ms=cuda_ms(lambda: fa.flash_bwd_dkv_reference(
                    q, k, v, mask, do, lse, delta), reps=3),
                library_ms=None,  # nor dK and dV alone
                bound=bound_ms(8 * D * pairs, 6 * n * es + small + rows * 4, dtype)),
        }
    # SDPA's backward computes dQ, dK and dV in one call: a yardstick for
    # flash_bwd_dq + flash_bwd_dkv together
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=key_ok)
    doh = do.transpose(1, 2).contiguous()
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o, leaves, doh, retain_graph=True))
    print(json.dumps({"timing": str(dtype).split(".")[-1], "shape": [B, T, H, D],
                      **{k: {kk: vv for kk, vv in r.items() if kk != "bound"}
                         for k, r in res.items()},
                      "sdpa_backward_ms": sdpa_bwd,
                      "kernels_backward_ms": res["flash_bwd_dq"]["ms"]
                      + res["flash_bwd_dkv"]["ms"]}))
    del o, leaves
    torch.cuda.empty_cache()
    res["flash_bwd_dq"]["library_dqkv_ms"] = sdpa_bwd
    res["flash_bwd_dkv"]["library_dqkv_ms"] = sdpa_bwd
    return res


def build_sim(modules, datasets, dtype, device, seed):
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.kernels.flash_attention import flash_attention
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.transformer import TransformerClassifier
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    module = TransformerClassifier(
        **modules, dtype=dtype, remat=True,
        attention_fn=flash_attention)
    return FederatedSimulation(
        logic=engine.ClientLogic(engine.from_module(module), engine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=FedAvg(), datasets=datasets, batch_size=BATCH,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=LOCAL_STEPS,
        seed=seed, device=device)


def text_datasets(vocab: int, seq: int, n_rows: int, n_train: int):
    from fl4health_tpu_torch.datasets.synthetic import synthetic_text_classification
    from fl4health_tpu_torch.server.simulation import ClientDataset

    out = []
    for i in range(N_CLIENTS):
        x, y = synthetic_text_classification(torch.Generator().manual_seed(i), n_rows,
                                             vocab, seq, 4)
        out.append(ClientDataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:]))
    return out


def tiny_parity() -> None:
    """The same tiny federated run on the card (kernels) and on the CPU
    (plain version), from the same params."""
    cfg = dict(vocab_size=64, n_classes=4, d_model=64, n_heads=2, n_layers=2,
               d_ff=128, max_len=80)
    data = text_datasets(64, 80, 48, 40)
    runs = []
    for device in ("cuda", "cpu"):
        sim = build_sim(cfg, data, torch.float32, device, seed=3)
        if runs:
            sim.set_global_params({k: v.cpu() for k, v in runs[0][2].items()})
        init = {k: v.clone() for k, v in sim.global_params.items()}
        runs.append((sim.fit(2), sim.global_params, init))
    (gpu_hist, gpu_params, _), (cpu_hist, cpu_params, _) = runs
    for gr, cr in zip(gpu_hist, cpu_hist):
        for key in ("backward",):
            check(f"tiny fit loss r{gr.round}", torch.tensor(gr.fit_losses[key]),
                  torch.tensor(cr.fit_losses[key]), 5e-4, 0)
        check(f"tiny eval loss r{gr.round}", torch.tensor(gr.eval_losses["checkpoint"]),
              torch.tensor(cr.eval_losses["checkpoint"]), 5e-4, 0)
    err = max(check(f"tiny param {k}", gpu_params[k].cpu(), cpu_params[k], 5e-4, 0)
              for k in cpu_params)
    print(json.dumps({"tiny_parity": "cuda kernels vs cpu plain", "rounds": 2,
                      "fit_losses": [r.fit_losses["backward"] for r in gpu_hist],
                      "max_param_abs_err": err}))


def main_path(fa) -> dict:
    """Full-width transformer_long federated training, bf16 compute."""
    cfg = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=4,
               d_ff=2048, max_len=T)
    data = text_datasets(8192, T, BATCH * LOCAL_STEPS + 16, BATCH * LOCAL_STEPS)
    sim = build_sim(cfg, data, torch.bfloat16, "cuda", seed=0)
    init = {k: v.clone() for k, v in sim.global_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.time()
    hist = sim.fit(ROUNDS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(fa.LAUNCHES)
    positions = N_CLIENTS * LOCAL_STEPS * BATCH * T
    real = sum(int((d.x_train > 0).sum()) for d in data)  # one pass over each client's rows
    for r in hist:
        if not all(np.isfinite(v) for v in (*r.fit_losses.values(),
                                              *r.eval_losses.values())):
            fail(f"round {r.round}: non-finite losses {r.fit_losses} {r.eval_losses}")
        print(json.dumps({
            "round": r.round, "fit_loss": r.fit_losses["backward"],
            "eval_loss": r.eval_losses["checkpoint"],
            "eval_accuracy": r.eval_metrics["accuracy"],
            "fit_s": r.fit_elapsed_s, "eval_s": r.eval_elapsed_s,
            "round_wall_s": r.fit_elapsed_s + r.eval_elapsed_s,
            "train_token_positions_per_s": positions / r.fit_elapsed_s,
            "train_real_tokens_per_s": real / r.fit_elapsed_s}))
    moved = max(float((sim.global_params[k] - init[k]).abs().max()) for k in init)
    finite = all(torch.isfinite(v).all() for v in sim.global_params.values())
    if not finite or moved <= 0:
        fail(f"global params after training: finite={finite}, max change {moved}")
    expected = {  # per round: 2 clients x 5 steps x 4 layers (x2 for remat) + eval
        "flash_fwd": ROUNDS * (N_CLIENTS * LOCAL_STEPS * 4 * 2 + N_CLIENTS * 4),
        "flash_bwd_dq": ROUNDS * N_CLIENTS * LOCAL_STEPS * 4,
        "flash_bwd_dkv": ROUNDS * N_CLIENTS * LOCAL_STEPS * 4,
    }
    print(json.dumps({"main_path": "transformer_long", "rounds": ROUNDS, "wall_s": wall,
                      "n_params": sum(v.numel() for v in init.values()),
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "max_param_change": moved, "launches": launches,
                      "expected_launches": expected}))
    if launches != expected:
        fail(f"main-path launches {launches}, expected {expected}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: needs an NVIDIA card; torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fl4health_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)

    t0 = time.time()
    fa.build_extension()
    print(json.dumps({"build_s": time.time() - t0}))

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype] = kernel_checks(fa, B, T, dtype, seed=1,
                                    autograd_check=dtype == torch.float32)
        kernel_checks(fa, 4, RAGGED_T, dtype, seed=2, autograd_check=True)
    timings = kernel_timings(fa, torch.bfloat16)
    tiny_parity()
    launches = main_path(fa)

    replaces = {"flash_fwd": "fl4health_tpu/kernels/flash_attention.py:71",
                "flash_bwd_dq": "fl4health_tpu/kernels/flash_attention.py:141",
                "flash_bwd_dkv": "fl4health_tpu/kernels/flash_attention.py:175"}
    kernels = []
    for name, rep in replaces.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": errs[torch.bfloat16][name],
            "max_abs_err_f32": errs[torch.float32][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            # one SDPA backward call, which computes dQ, dK and dV together
            **({"library_dqkv_ms": t["library_dqkv_ms"]} if "library_dqkv_ms" in t else {}),
            "dtype": "bfloat16", "shape": [B, T, H, D]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
