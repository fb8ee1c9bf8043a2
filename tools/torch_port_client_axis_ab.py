#!/usr/bin/env python3
"""One port path's rounds with its clients vmapped and looped, in turns, on
the card: what the client axis costs or saves, round by round and kernel by
kernel.

Builds one of ``chip_smoke.py``'s full-width federated runs twice: with the
simulation's ``vmap_clients`` (the main path: one ``torch.func.vmap`` of
``client_fit`` and ``client_eval`` a round) and with ``loop_clients`` (its
plain version, one call a client). Runs them in turns (vmap, loop, loop,
vmap): each run warms up one round, times ``--rounds`` rounds with the host
clock around work that ends in ``torch.cuda.synchronize()``, then profiles
one more round with ``torch.profiler`` (CPU and CUDA activity). Prints one
JSON line a run (walls, device busy time, peak memory) and a last one with
the device time under each axis (the first run of each) of every kernel
name and of every aten op by the kernels it launched itself, each sorted by
how much more the vmap spends on it.

Run on the card from the repository root:
    python3 tools/torch_port_client_axis_ab.py [--config dp_cifar_cnn]

``--layer-norm`` (transformer_long) measures the layer norm's client-vmap
rule instead: the vmapped round under four layer norms, and the loop, in
turns (decomposed, affine, per_client, fold_rows, loop, loop, fold_rows,
per_client, affine, decomposed). With grad mode on, ``per_client`` (the
model's rule) runs each client's fused ``native_layer_norm`` and its
backward with its own weights, and ``fold_rows`` folds the clients into the
rows (one weight-less ``native_layer_norm`` over all rows and the
per-client affine as one ``addcmul``; the backward one weight-less
``native_layer_norm_backward`` of ``dy * scale``, with ``dscale``/``dbias``
summed per client); both take the model's plain ops without grad mode.
``affine`` is those plain ops (weight-less ``F.layer_norm`` and
``addcmul``) everywhere, differentiated by autograd; ``decomposed`` calls
``F.layer_norm`` with the weights, which vmap decomposes for batched
weights (the model before the rule). The loop runs ``decomposed``: for one
client that is ``F.layer_norm``'s own fused op, the loop of the model
before the rule. The last line gives, for each vmapped variant, the kernels
and aten ops whose device time differs most from the loop's.

Every run starts from the same params and data; how far the two axes'
losses part over the rounds is ``tools/torch_port_client_axis_drift.py``'s
to measure.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build(config: str, dtype: torch.dtype):
    """A maker of fresh simulations of ``config`` in compute dtype ``dtype``
    (params stay f32), all from the same params and data."""
    import chip_smoke as cs
    from fl4health_tpu_torch.models.cnn import CifarNet

    if config == "transformer_long":
        cfg = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=4,
                   d_ff=2048, max_len=cs.T)
        data = cs.text_datasets(8192, cs.T, cs.BATCH * cs.LOCAL_STEPS + 16,
                                cs.BATCH * cs.LOCAL_STEPS)
        return lambda: cs.build_sim(cfg, data, dtype, "cuda", seed=0)
    if config == "dp_cifar_cnn":
        data = cs.image_datasets(cs.DP_CLIENTS, cs.DP_TRAIN, cs.DP_VAL, (32, 32, 3))
        return lambda: cs.build_dp_sim(data, dtype, "cuda", cs.DP_SIGMA, seed=0)
    data = cs.hospital_datasets(cs.CDP_CLIENTS, cs.CDP_POOL, (32, 32, 3))
    return lambda: cs.build_client_dp_sim(data, CifarNet(10, dtype=dtype), "cuda",
                                          cs.CDP_FRACTION, seed=0)


def fold_rows_forward(x, scale, bias, eps):
    """The ``fold_rows`` design of ``layer_norm_clients_forward``."""
    n, d = x.shape[0], x.shape[-1]
    xhat, mean, rstd = torch.native_layer_norm(x.reshape(-1, d), (d,), None, None, eps)
    y = torch.addcmul(bias[:, None], xhat.view(n, -1, d), scale[:, None])
    stats = (*x.shape[:-1], 1)
    return y.view(x.shape), mean.view(stats), rstd.view(stats)


def fold_rows_backward(dy, x, mean, rstd, scale, bias):
    """The ``fold_rows`` design of ``layer_norm_clients_backward``."""
    n, d = x.shape[0], x.shape[-1]
    dy3, x2 = dy.reshape(n, -1, d), x.reshape(-1, d)
    m2, r2 = mean.reshape(-1, 1), rstd.reshape(-1, 1)
    dx = torch.ops.aten.native_layer_norm_backward(
        (dy3 * scale[:, None]).view(-1, d), x2, (d,), m2, r2, None, None,
        [True, False, False])[0]
    xhat = ((x2 - m2) * r2).view(n, -1, d)
    return dx.view(x.shape), (dy3 * xhat).sum(1), dy3.sum(1)


@contextlib.contextmanager
def layer_norm_design(name: str):
    """Run the model's layer norm as ``name``: ``per_client`` (the model's
    own), ``fold_rows`` or ``decomposed``."""
    from fl4health_tpu_torch.models import transformer as trm

    saved = (trm.layer_norm, trm.layer_norm_clients_forward,
             trm.layer_norm_clients_backward)
    if name == "fold_rows":
        trm.layer_norm_clients_forward = fold_rows_forward
        trm.layer_norm_clients_backward = fold_rows_backward
    elif name == "decomposed":
        trm.layer_norm = lambda x, scale, bias, eps=1e-6: F.layer_norm(  # noqa: E731
            x, scale.shape, scale, bias, eps)
    elif name == "affine":
        trm.layer_norm = lambda x, scale, bias, eps=1e-6: torch.addcmul(  # noqa: E731
            bias, F.layer_norm(x, scale.shape, None, None, eps), scale)
    try:
        yield
    finally:
        (trm.layer_norm, trm.layer_norm_clients_forward,
         trm.layer_norm_clients_backward) = saved


def run(make_sim, axis, rounds: int) -> tuple[dict, collections.Counter,
                                              collections.Counter]:
    sim = make_sim()
    sim._fit_round, sim._eval_round = sim._build_round_fns(axis)
    sim.fit(1)  # warm-up: kernel build, cuBLAS/cuDNN handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(rounds):
        t0 = time.time()
        sim.fit(1)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sim.fit(1)
        torch.cuda.synchronize()
    by_kernel: collections.Counter = collections.Counter()
    by_op: collections.Counter = collections.Counter()
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key[:100]] += evt.self_device_time_total / 1e6
        elif evt.self_device_time_total > 0:  # an op that launched kernels itself
            by_op[evt.key[:100]] += evt.self_device_time_total / 1e6
    rec = {"axis": axis.__name__, "round_walls_s": walls,
           "profiled_device_busy_s": sum(by_kernel.values()),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "final_fit_loss": sim.history[-1].fit_losses["backward"]}
    return rec, by_kernel, by_op


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", choices=("transformer_long", "dp_cifar_cnn",
                                             "client_dp_cifar_cnn"),
                        default="transformer_long")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--layer-norm", action="store_true",
                        help="compare the layer norm's vmap designs (transformer_long)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    from fl4health_tpu_torch.server import simulation as tsim

    make_sim = build(args.config, torch.bfloat16)
    if args.layer_norm:
        return layer_norm_ab(make_sim, args, tsim)
    profiles = {}
    for axis in (tsim.vmap_clients, tsim.loop_clients, tsim.loop_clients,
                 tsim.vmap_clients):
        rec, *counters = run(make_sim, axis, args.rounds)
        profiles.setdefault(axis.__name__, counters)
        print(json.dumps({"config": args.config, **rec}), flush=True)

    def by_name(i):
        v, lp = profiles["vmap_clients"][i], profiles["loop_clients"][i]
        return [{"name": n, "vmap_s": v[n], "loop_s": lp[n]}
                for n in sorted(set(v) | set(lp), key=lambda n: lp[n] - v[n])]
    print(json.dumps({"config": args.config, "device_s_by_kernel": by_name(0),
                      "device_s_by_aten_op": by_name(1)}))
    return 0


def layer_norm_ab(make_sim, args, tsim) -> int:
    order = ["decomposed", "affine", "per_client", "fold_rows", "loop", "loop",
             "fold_rows", "per_client", "affine", "decomposed"]
    profiles = {}
    for name in order:
        axis = tsim.loop_clients if name == "loop" else tsim.vmap_clients
        with layer_norm_design("decomposed" if name == "loop" else name):
            rec, *counters = run(make_sim, axis, args.rounds)
        profiles.setdefault(name, counters)
        print(json.dumps({"config": args.config, "layer_norm": name, **rec}), flush=True)

    def top(name, i, n=12):
        v, lp = profiles[name][i], profiles["loop"][i]
        keys = sorted(set(v) | set(lp), key=lambda k: -abs(v[k] - lp[k]))[:n]
        return [{"name": k, "vmap_s": v[k], "loop_s": lp[k]} for k in keys]

    print(json.dumps({"config": args.config, "against_loop": {
        name: {"device_s": sum(profiles[name][0].values()),
               "loop_device_s": sum(profiles["loop"][0].values()),
               "by_kernel": top(name, 0), "by_aten_op": top(name, 1)}
        for name in ("decomposed", "affine", "per_client", "fold_rows")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
