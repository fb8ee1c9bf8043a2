"""CompressingStrategy, the lossy exchange as a strategy wrapper (counterpart
of ``fl4health_tpu/compression/strategy.py``): every client's update goes
through the configured channel (``compression/codecs.py``) inside
``aggregate``, before the inner strategy aggregates, so the inner strategy
(``FedAvg``, ``Scaffold``, ...) sees what a wire's receiver would
reconstruct, on both routes.

The error-feedback residuals are per-client ``[C, ...]`` rows of the server
state (``CompressedExchangeState``), exposed through ``state_rows`` so a
cohort run moves them through the client registry. A residual row changes
only where the round's aggregation mask has the client. The channel runs
once for all clients under ``torch.func.vmap`` (JAX's ``jax.vmap``), each
client's key ``fold_in(fold_in(PRNGKey(seed), round), client)``.

DP: the instance-level DP client clips and noises inside local training,
before the packet exists, so compressing the packet is post-processing and
leaves the guarantee as it was.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.compression.codecs import compress_update
from fl4health_tpu_torch.compression.config import CompressionConfig
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.parallel.compat import client_offset
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class CompressedExchangeState:
    """The wrapper's server state: the inner strategy's state and the
    per-client error-feedback residuals (None without error feedback)."""

    inner: Any
    residual: Any


class CompressingStrategy(Strategy):
    """Wrap a strategy with the lossy exchange. The main update (the packet,
    or its ``params`` field) is compressed against what the clients pulled
    this round, with per-client residuals where configured; a
    ``control_variates`` field (SCAFFOLD) is compressed too, without
    residual, against zero. Masked partial-exchange packets are refused.
    ``n_clients`` comes from ``bind_client_manager`` (the simulation calls
    it before ``init``), or is passed for direct use."""

    def __init__(self, inner: Strategy, config: CompressionConfig,
                 n_clients: int | None = None):
        if not isinstance(config, CompressionConfig):
            raise TypeError(f"config must be a CompressionConfig; got {type(config).__name__}")
        if not config.enabled:
            raise ValueError(
                "CompressionConfig has no lossy stage enabled; drop the "
                "wrapper instead of compiling an identity channel")
        self.inner = inner
        self.config = config
        self._n_clients = n_clients
        if config.topk_schedule is not None:
            _, f0, f1, over = config.topk_schedule
            self.topk_f_start, self.topk_f_end = float(f0), float(f1)
            self.topk_over_rounds = int(over)
        else:
            self.topk_f_start = self.topk_f_end = self.topk_over_rounds = None
        self.weighted_aggregation = getattr(inner, "weighted_aggregation", True)
        # the chunked route's eligibility reads this: only an inner
        # update_after_eval that consumes eval on the host counts
        inner_overrides = getattr(inner, "overrides_update_after_eval", None)
        if inner_overrides is None:
            inner_overrides = (type(inner).update_after_eval
                               is not Strategy.update_after_eval)
        self.overrides_update_after_eval = inner_overrides

    @property
    def evaluate_after_fit(self) -> bool:
        return bool(getattr(self.inner, "evaluate_after_fit", False))

    def bind_client_manager(self, client_manager: Any) -> None:
        self._n_clients = client_manager.n_clients
        self.inner.bind_client_manager(client_manager)

    def init(self, params) -> CompressedExchangeState:
        residual = None
        if self.config.uses_error_feedback:
            if self._n_clients is None:
                raise ValueError(
                    "CompressingStrategy with error feedback needs "
                    "n_clients: pass it to the constructor or let "
                    "FederatedSimulation bind its client manager first")
            n = self._n_clients
            residual = {k: torch.zeros((n, *p.shape), dtype=torch.float32, device=p.device)
                        for k, p in params.items()}
        return CompressedExchangeState(inner=self.inner.init(params), residual=residual)

    def state_sharding_spec(self, server_state: CompressedExchangeState,
                            clients_axis: str):
        """On a client mesh the per-client ``[C, ...]`` EF residual stack
        shards over the clients axis; the inner strategy's state follows
        its own spec."""
        from fl4health_tpu_torch.parallel.mesh import P
        from fl4health_tpu_torch.strategies.base import inner_state_sharding_spec

        return CompressedExchangeState(
            inner=inner_state_sharding_spec(self.inner, server_state.inner, clients_axis),
            residual=P(clients_axis) if server_state.residual is not None else None)

    def global_params(self, server_state: CompressedExchangeState):
        return self.inner.global_params(server_state.inner)

    def divergence_reference(self, server_state: CompressedExchangeState):
        return self.inner.divergence_reference(server_state.inner)

    def state_rows(self, server_state: CompressedExchangeState):
        """The residual rows (None without error feedback) and the inner
        strategy's rows: a client's residual follows it in and out of the
        sampled cohort."""
        return {"residual": server_state.residual,
                "inner": self.inner.state_rows(server_state.inner)}

    def scatter_state_rows(self, server_state: CompressedExchangeState, rows):
        return CompressedExchangeState(
            inner=self.inner.scatter_state_rows(server_state.inner, rows["inner"]),
            residual=rows["residual"])

    def client_payload(self, server_state: CompressedExchangeState, round_idx):
        return self.inner.client_payload(server_state.inner, round_idx)

    # -- the channel ----------------------------------------------------

    def _round_key(self, round_idx: int, device) -> torch.Tensor:
        return rng.fold_in(rng.PRNGKey(self.config.seed, device), int(round_idx))

    def effective_topk_fraction(self, round_idx: int):
        """The round's kept fraction under ``config.topk_schedule``:
        ``f_start -> f_end`` linearly over the first ``over_rounds`` rounds
        (from round 1; ``f_end`` after), clamped into ``(0,
        topk_fraction]``, in f32 as XLA compiles JAX's: the division by the
        constant a multiply by its f32 reciprocal, the interpolation one
        fused multiply-add; None without a schedule. Where an endpoint is a
        0-d tensor (a sweep cell's hoisted scalar) the fraction is a 0-d f32
        tensor on its device, computed there as JAX's traced path computes
        it; else an ``np.float32``."""
        if self.topk_f_start is None:
            return None
        if self.topk_over_rounds <= 1:
            t = np.float32(1.0)
        else:
            inv = np.float32(1.0) / np.float32(self.topk_over_rounds - 1.0)
            t = np.clip((np.float32(round_idx) - np.float32(1.0)) * inv,
                        np.float32(0.0), np.float32(1.0))
        ends = (self.topk_f_start, self.topk_f_end)
        tensors = [e for e in ends if isinstance(e, torch.Tensor)]
        if tensors:
            f0, f1 = (torch.as_tensor(e, dtype=torch.float32, device=tensors[0].device)
                      for e in ends)
            f = rng._fma(f1 - f0, float(t), f0)
            return torch.clamp(f, float(np.float32(1e-9)),
                               float(np.float32(self.config.topk_fraction)))
        delta = np.float32(self.topk_f_end - self.topk_f_start)
        # one rounding of the f64 multiply-add (the f32 product is exact)
        f = np.float32(float(delta) * float(t) + float(np.float32(self.topk_f_start)))
        return np.clip(f, np.float32(1e-9), np.float32(self.config.topk_fraction))

    def _compress_stacked(self, stacked: dict, reference: dict, residuals: dict | None,
                          round_key: torch.Tensor, mask: torch.Tensor,
                          topk_fraction_eff=None):
        """The per-client channel over the ``[C, ...]`` packet stack, under
        ``torch.func.vmap``; ``reference`` is what every client pulled.
        Residual rows change only where ``mask`` participates."""
        n = ptu.tree_leaves(stacked)[0].shape[0]
        # client i's key by its global index (under a mesh, this rank's block)
        keys = rng.fold_in_many(round_key, torch.arange(n, device=round_key.device)
                                + client_offset())
        config = self.config

        def cast_back(r, d):
            v = r.to(torch.float32) + d
            if not r.is_floating_point():
                v = torch.round(v)  # round, as the decoder does
            return v.to(r.dtype)

        def one(packet_c, key_c, residual_c=None):
            update = {k: packet_c[k].to(torch.float32) - reference[k].to(torch.float32)
                      for k in packet_c}
            decoded, new_res = compress_update(update, residual_c, key_c, config,
                                               topk_fraction_eff=topk_fraction_eff)
            lossy = {k: cast_back(reference[k], decoded[k]) for k in reference}
            return (lossy, new_res) if residual_c is not None else lossy

        if residuals is None:
            lossy = torch.func.vmap(one, randomness="error")(stacked, keys)
            return lossy, None
        lossy, new_res = torch.func.vmap(one, randomness="error")(stacked, keys, residuals)
        keep = mask > 0
        new_res = {k: torch.where(keep.reshape((-1,) + (1,) * (v.ndim - 1)), v, residuals[k])
                   for k, v in new_res.items()}
        return lossy, new_res

    def aggregate(self, server_state: CompressedExchangeState, results: FitResults,
                  round_idx) -> CompressedExchangeState:
        packets = results.packets
        for bad in ("leaf_mask", "element_mask"):
            if hasattr(packets, bad):
                raise ValueError(
                    f"CompressingStrategy cannot compress {type(packets).__name__} "
                    "packets (masked partial exchange): zeroed non-selected "
                    "entries would read as real deltas. Use full-model "
                    "exchange with compression.")
        payload = self.inner.client_payload(server_state.inner, round_idx)
        reference = payload.params if hasattr(payload, "params") else payload
        main = packets.params if hasattr(packets, "params") else packets
        if not isinstance(main, dict) or list(main) != list(reference):
            raise ValueError(
                "CompressingStrategy: packet params structure "
                f"{sorted(main) if isinstance(main, dict) else type(main).__name__} does "
                f"not match the broadcast payload structure {sorted(reference)}; "
                "compression needs param-shaped packets (full-model exchange).")
        device = results.mask.device
        round_key = self._round_key(round_idx, device)
        eff = self.effective_topk_fraction(round_idx)
        lossy_main, new_residual = self._compress_stacked(
            main, reference, server_state.residual, round_key, results.mask, eff)
        new_packets = (dataclasses.replace(packets, params=lossy_main)
                       if hasattr(packets, "params") else lossy_main)
        if hasattr(packets, "control_variates"):
            # SCAFFOLD's auxiliary packet: the same channel, a zero
            # reference (it is already a delta), no residual
            cv = packets.control_variates
            cv_ref = {k: torch.zeros(v.shape[1:], dtype=torch.float32, device=v.device)
                      for k, v in cv.items()}
            lossy_cv, _ = self._compress_stacked(
                cv, cv_ref, None, rng.fold_in(round_key, 0x5CAF), results.mask, eff)
            new_packets = dataclasses.replace(new_packets, control_variates=lossy_cv)
        new_inner = self.inner.aggregate(
            server_state.inner, dataclasses.replace(results, packets=new_packets), round_idx)
        return CompressedExchangeState(inner=new_inner, residual=new_residual)

    def update_after_eval(self, server_state: CompressedExchangeState, eval_losses,
                          eval_metrics, mask) -> CompressedExchangeState:
        return dataclasses.replace(server_state, inner=self.inner.update_after_eval(
            server_state.inner, eval_losses, eval_metrics, mask))
