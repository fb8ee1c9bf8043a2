"""Deterministic, seeded fault injection (counterpart of
``fl4health_tpu/resilience/faults.py``, its client faults): the chaos
layer that robustness claims are tested against.

- **Simulation faults**: client dropout and update corruption (NaN
  poison, scaling, sign flip), applied inside the round programs. Every
  draw comes from the threefry key ``fold_in(fold_in(PRNGKey(seed), 7919 *
  fault_index + 13), round)`` (``rng.py``, JAX's stream word for word), so
  the same :class:`FaultPlan` injects the same faults on the pipelined and
  chunked routes, and in both packages. Dropout multiplies the mask and
  corruption rewrites the packets: shapes never change.
- **Compute-time faults** (``kind="slow"``): stragglers as a per-(client,
  round) compute-time multiplier on the buffered-async mode's virtual
  clock. They never enter the round programs: ``server/async_schedule.py``
  reads them on the host through :meth:`FaultPlan.compute_time_factors`.
  A plan with only ``slow`` faults leaves a synchronous run as it was.

A round program draws on the simulation's device; the host-side views
(``compute_time_factors``, ``summarize_round``) draw from a CPU key, the
same words.

Corruption semantics: a corrupted packet is ``payload + s * (packet -
payload)`` relative to the round's broadcast payload (``s = -1`` the
sign-flip attack, ``s = k`` the scaling attack, ``s = NaN`` the poison).
When the packet tree is not params-shaped the factor multiplies each float
leaf instead.

- **Wire faults**: :func:`chaos_handler` wraps a cross-silo silo's request
  handler (``transport/loopback.py``) with the plan's
  ``TransportFaultPolicy``: delays, dropped replies and flipped bytes, drawn
  from ``random.Random(f"{seed}:{silo_idx}")`` in JAX's order, so a plan
  gives the same faults in both packages.
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.utils._pytree as torch_pytree

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.core.pytree import tree_map
from fl4health_tpu_torch.parallel.compat import client_block

CLIENT_FAULT_KINDS = ("dropout", "nan", "scale", "sign_flip", "slow")

# kinds that transform the wire packet (everything except mask math and
# the host-side virtual-clock straggler model)
_CORRUPTION_KINDS = ("nan", "scale", "sign_flip")


@dataclasses.dataclass(frozen=True)
class ClientFault:
    """One fault spec over a static set of clients.

    ``probability`` is per (client, round); 1.0 means every round in the
    active window ``[start_round, end_round]`` (inclusive; ``end_round=None``
    is forever)."""

    clients: tuple[int, ...]
    kind: str
    scale: float = 10.0
    probability: float = 1.0
    start_round: int = 1
    end_round: int | None = None

    def __post_init__(self):
        if self.kind not in CLIENT_FAULT_KINDS:
            raise ValueError(
                f"ClientFault.kind must be one of {CLIENT_FAULT_KINDS}; "
                f"got {self.kind!r}")
        if self.kind == "slow" and not self.scale > 0:
            raise ValueError(
                "ClientFault(kind='slow') uses scale as a compute-time "
                f"multiplier; it must be > 0 (got {self.scale})")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError("probability must be in [0, 1]")
        if not self.clients:
            raise ValueError("ClientFault.clients must name at least one client")
        object.__setattr__(self, "clients", tuple(int(c) for c in self.clients))


@dataclasses.dataclass(frozen=True)
class TransportFaultPolicy:
    """Host-side wire chaos for one silo handler (all probabilities are per
    request, drawn deterministically from the plan seed)."""

    drop_probability: float = 0.0
    corrupt_probability: float = 0.0
    delay_s: float = 0.0
    delay_probability: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, declarative chaos schedule, passed to
    ``FederatedSimulation(fault_plan=...)``. An empty plan is a no-op: the
    round programs are those of ``fault_plan=None``."""

    seed: int = 0
    client_faults: tuple[ClientFault, ...] = ()
    transport: TransportFaultPolicy | None = None

    def __post_init__(self):
        object.__setattr__(self, "client_faults", tuple(self.client_faults))

    # -- static views ---------------------------------------------------
    @property
    def dropout_faults(self) -> tuple[ClientFault, ...]:
        return tuple(f for f in self.client_faults if f.kind == "dropout")

    @property
    def corruption_faults(self) -> tuple[ClientFault, ...]:
        return tuple(f for f in self.client_faults if f.kind in _CORRUPTION_KINDS)

    @property
    def slow_faults(self) -> tuple[ClientFault, ...]:
        return tuple(f for f in self.client_faults if f.kind == "slow")

    @property
    def has_client_faults(self) -> bool:
        return bool(self.client_faults)

    def _check_clients(self, n_clients: int) -> None:
        """Every named client must exist: a typo'd id would inject no fault
        anywhere and the robustness experiment would pass vacuously."""
        for f in self.client_faults:
            bad = [c for c in f.clients if not 0 <= c < n_clients]
            if bad:
                raise ValueError(
                    f"FaultPlan: ClientFault({f.kind!r}) names clients "
                    f"{bad} but the cohort has {n_clients} clients "
                    f"(valid ids: 0..{n_clients - 1})")

    # -- the round programs' draws --------------------------------------
    def _fired(self, fault: ClientFault, fault_idx: int, round_idx: int,
               n_clients: int, device: str | torch.device = "cpu") -> torch.Tensor:
        """[C] f32, 1.0 where this fault fires this round."""
        r = int(round_idx)
        active = r >= fault.start_round and (fault.end_round is None
                                             or r <= fault.end_round)
        fired = torch.zeros((n_clients,), dtype=torch.float32, device=device)
        if not active:
            return fired
        fired[list(fault.clients)] = 1.0
        if fault.probability < 1.0:
            # a stream per (seed, fault index, round)
            key = rng.fold_in(rng.fold_in(rng.PRNGKey(self.seed, device),
                                          7919 * fault_idx + 13), r)
            u = rng.uniform(key, (n_clients,))
            fired = fired * (u < float(np.float32(fault.probability))).to(torch.float32)
        return fired

    def participation_factor(self, round_idx: int, n_clients: int,
                             device: str | torch.device = "cpu") -> torch.Tensor:
        """[C] keep-mask (1.0 = client reachable) from the dropout specs,
        multiplied into the round's participation mask."""
        self._check_clients(n_clients)
        keep = torch.ones((n_clients,), dtype=torch.float32, device=device)
        for i, f in enumerate(self.client_faults):
            if f.kind == "dropout":
                keep = keep * (1.0 - self._fired(f, i, round_idx, n_clients, device))
        return keep

    def corruption_factors(self, round_idx: int, n_clients: int,
                           device: str | torch.device = "cpu") -> torch.Tensor:
        """[C] per-client update multiplier ``s`` (1.0 = honest, -1 =
        sign-flip, k = scale, NaN = poison). Later specs win on overlap."""
        self._check_clients(n_clients)
        factors = torch.ones((n_clients,), dtype=torch.float32, device=device)
        for i, f in enumerate(self.client_faults):
            if f.kind not in _CORRUPTION_KINDS:
                continue
            value = {"nan": float("nan"), "sign_flip": -1.0,
                     "scale": float(np.float32(f.scale))}[f.kind]
            fired = self._fired(f, i, round_idx, n_clients, device)
            factors = torch.where(fired > 0, torch.full_like(factors, value), factors)
        return factors

    def corrupt_packets(self, packets: Any, payload_params: Any, round_idx: int,
                        n_clients: int) -> Any:
        """This round's corruption applied to the client-stacked packets
        (identity when no corruption spec exists)."""
        if not self.corruption_faults:
            return packets
        device = next(x for x in torch_pytree.tree_leaves(packets)
                      if isinstance(x, torch.Tensor)).device
        # under a mesh, this rank's block of the [C] draws
        factors = client_block(self.corruption_factors(round_idx, n_clients, device))

        def expand(leaf):
            return factors.reshape((-1,) + (1,) * (leaf.ndim - 1))

        if (torch_pytree.tree_structure(packets)
                == torch_pytree.tree_structure(payload_params)):
            # attack the update relative to the broadcast payload
            def attack(leaf, ref):
                if not leaf.is_floating_point():
                    return leaf
                ref = ref.to(leaf.dtype)[None]
                return (ref + expand(leaf) * (leaf - ref)).to(leaf.dtype)

            return tree_map(attack, packets, payload_params)
        # another packet layout: multiplicative on the float leaves
        return tree_map(lambda leaf: (expand(leaf) * leaf).to(leaf.dtype)
                        if leaf.is_floating_point() else leaf, packets)

    # -- the virtual clock's straggler model (host) ----------------------
    def compute_time_factors(self, round_idx: int, n_clients: int) -> np.ndarray:
        """[C] f64 compute-time multiplier for the training attempt whose
        data plan is ``round_idx`` (1.0 = nominal), from the ``kind="slow"``
        specs, drawn from the same seeded streams as the round programs'
        faults. Overlapping slow specs compound multiplicatively."""
        self._check_clients(n_clients)
        factors = np.ones((n_clients,), np.float64)
        for i, f in enumerate(self.client_faults):
            if f.kind != "slow":
                continue
            fired = self._fired(f, i, round_idx, n_clients).numpy()
            factors = np.where(fired > 0, factors * float(f.scale), factors)
        return factors

    # -- host mirror (the round's record) --------------------------------
    def summarize_round(self, round_idx: int, n_clients: int) -> dict | None:
        """The round's draws, evaluated on the host from the same seeded
        streams: what the round program injected (JAX logs it as its
        ``fault`` event)."""
        if not self.client_faults:
            return None
        keep = self.participation_factor(round_idx, n_clients).numpy()
        factors = self.corruption_factors(round_idx, n_clients).numpy()
        dropped = [int(c) for c in np.nonzero(keep < 1.0)[0]]
        kinds: dict[str, list[int]] = {}
        for c in range(n_clients):
            f = factors[c]
            if np.isnan(f):
                kinds.setdefault("nan", []).append(c)
            elif f == -1.0:
                kinds.setdefault("sign_flip", []).append(c)
            elif f != 1.0:
                kinds.setdefault("scale", []).append(c)
        corrupted = sorted({c for cs in kinds.values() for c in cs})
        slow: list[int] = []
        if self.slow_faults:
            ct = self.compute_time_factors(round_idx, n_clients)
            slow = [int(c) for c in np.nonzero(ct != 1.0)[0]]
            if slow:
                kinds["slow"] = slow
        if not dropped and not corrupted and not slow:
            return None
        return {"round": int(round_idx), "dropped": dropped,
                "corrupted": corrupted, "kinds": kinds}


class _InjectedDrop(RuntimeError):
    """Raised inside a chaos-wrapped handler to kill the reply: the loopback
    server logs it and closes the connection, which the caller sees as a
    connection failure (a crashed silo)."""


def chaos_handler(
    handler: Callable[[bytes], bytes],
    policy: TransportFaultPolicy,
    seed: int = 0,
    silo_idx: int = 0,
    sleep: Callable[[float], None] = time.sleep,
) -> Callable[[bytes], bytes]:
    """Wrap a silo request handler with deterministic wire chaos.

    Draws come from ``random.Random(f"{seed}:{silo_idx}")`` in a fixed
    order a request (delay, drop, corrupt), so a plan gives the same fault
    sequence every run and in both packages. ``sleep`` is injectable, so a
    test records the delays instead of paying them; the draw order is the
    same either way."""
    rng = _pyrandom.Random(f"{seed}:{silo_idx}")

    def wrapped(frame: bytes) -> bytes:
        r_delay, r_drop, r_corrupt = rng.random(), rng.random(), rng.random()
        if policy.delay_s > 0 and r_delay < policy.delay_probability:
            sleep(policy.delay_s)
        if r_drop < policy.drop_probability:
            raise _InjectedDrop(f"chaos: dropped request at silo {silo_idx}")
        reply = handler(frame)
        if r_corrupt < policy.corrupt_probability and reply:
            # flip one mid-frame byte: the framing's CRC catches it and the
            # caller sees a decode failure, not silent corruption
            buf = bytearray(reply)
            buf[len(buf) // 2] ^= 0xFF
            reply = bytes(buf)
        return reply

    return wrapped
