#!/usr/bin/env python3
"""How far the vmapped and the looped client axis drift apart over a
path's rounds at full width, beside how far the loop drifts from itself
when its start moves by one f32 unit in the last place.

Runs one of ``chip_smoke.py``'s full-width federated runs three times from
the same params and data: through ``vmap_clients`` (the main path),
through ``loop_clients`` (its plain version), and through the loop again
from params each moved by one ulp, up or down at random (seeded). Prints
one JSON line a round with each run's fit and eval losses and each run's
distance from the loop's global params, relative to how far the loop's
params have moved from the start, and a last line with the first round's
distances. The vmap computes the same function as the loop in another
summation order; if a one-ulp start moves the loop as far as the vmap
does, the runs' later gap is the training's sensitivity to rounding, not
a difference between the two axes. Each round line also carries
``same_state_gap_rel``: the loop's round run again through the vmap from
the loop's own state at that round, the distance between the two rounds'
global params relative to the loop round's update. It stays at rounding
size at every state the training visits if the two axes compute one
function; it grows with the rounds if they do not.

Run on the card from the repository root:
    python3 tools/torch_port_client_axis_drift.py [--config dp_cifar_cnn]
        [--dtype float32] [--rounds 5]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_port_client_axis_ab import build  # noqa: E402


def one_ulp_away(params: dict, seed: int) -> dict:
    """Each element moved to its next float up or down, at random."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = {}
    for k, v in params.items():
        up = torch.rand(v.shape, generator=g).to(v.device) < 0.5
        out[k] = torch.where(up, torch.nextafter(v, torch.full_like(v, float("inf"))),
                             torch.nextafter(v, torch.full_like(v, float("-inf"))))
    return out


def flat(params: dict) -> torch.Tensor:
    return torch.cat([params[k].flatten() for k in sorted(params)])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", choices=("transformer_long", "dp_cifar_cnn",
                                             "client_dp_cifar_cnn"),
                        default="transformer_long")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fl4health_tpu_torch.server import simulation as tsim

    make_sim = build(args.config, getattr(torch, args.dtype))
    runs = {"vmap": (tsim.vmap_clients, False), "loop": (tsim.loop_clients, False),
            "loop_one_ulp": (tsim.loop_clients, True)}
    sims, init = {}, None
    for name, (axis, perturb) in runs.items():
        sim = make_sim()
        sim._fit_round, sim._eval_round = sim._build_round_fns(axis)
        if init is None:
            init = {k: v.clone() for k, v in sim.global_params.items()}
        sim.set_global_params(one_ulp_away(init, 0) if perturb else init)
        sims[name] = sim
    start, first = flat(init), None
    loop = sims["loop"]
    loop_fns, vmap_fns = (loop._fit_round, loop._eval_round), loop._build_round_fns(
        tsim.vmap_clients)
    for rnd in range(1, args.rounds + 1):
        params = {}
        # the loop's state, run through the vmap's round first, then restored
        before = (loop.server_state, loop.client_states, flat(loop.global_params))
        loop._fit_round, loop._eval_round = vmap_fns
        loop.fit(1)
        same_state = flat(loop.global_params)
        loop.history.pop()
        loop.server_state, loop.client_states = before[:2]
        loop._fit_round, loop._eval_round = loop_fns
        for name, sim in sims.items():
            sim.fit(1)
            params[name] = flat(sim.global_params)
        moved = float((params["loop"] - start).norm())
        rec = {"config": args.config, "dtype": args.dtype, "round": rnd,
               "same_state_gap_rel": float((same_state - params["loop"]).norm()
                                           / (params["loop"] - before[2]).norm()),
               "loop_moved_l2": moved,
               "distance_from_loop_rel": {n: float((p - params["loop"]).norm()) / moved
                                          for n, p in params.items() if n != "loop"},
               "fit_loss": {n: s.history[-1].fit_losses["backward"] for n, s in sims.items()},
               "eval_loss": {n: s.history[-1].eval_losses["checkpoint"]
                             for n, s in sims.items()}}
        first = first or rec["distance_from_loop_rel"]
        print(json.dumps(rec), flush=True)
    print(json.dumps({"config": args.config, "dtype": args.dtype,
                      "first_round_distance_from_loop_rel": first}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
