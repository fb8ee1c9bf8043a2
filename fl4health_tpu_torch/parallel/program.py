"""Round-program builder: the mesh and the placement of every round
program (counterpart of ``fl4health_tpu/parallel/program.py``).

``mesh=None`` (the default): every helper returns None, :meth:`put` and
:meth:`gather` are identities and :meth:`RoundProgramBuilder.jit` returns
the function itself, so the single-device programs are unchanged bit for
bit. With a :class:`MeshConfig` each rank of a ``torch.distributed``
world (one process per device) builds the same simulation from the same
seed and holds its block of every ``[C, ...]`` client-stacked tree: the
rows that JAX's ``P("clients")`` gives its device. The helpers return the
``NamedSharding`` trees JAX's builder jits with (compared to JAX's
``PartitionSpec``s by the tests), :meth:`put` keeps a rank's block of a
global tree by such a tree and :meth:`gather` assembles the global tree
back (the inverse, for checkpoint frames and the user's view). Eager torch
compiles nothing, so :meth:`jit` is placement only: the returned function
runs with the mesh's clients axis active (``parallel/compat.py``
``client_axis``), under which every sum over clients is the rank's partial
sum all-reduced over the axis, as XLA's sharded sum is.

Axis semantics follow ``parallel/mesh.py``: ``"clients"`` federated data
parallelism, ``"model"`` tensor parallelism within each client slice
(``tp_rules``: the Megatron rules of ``parallel/tp.py``). ``zero1`` wires
``parallel/zero.py`` into a FedOpt-family strategy: each replica keeps
1/N of the server optimizer state and the update gathers once a round.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.parallel import compat
from fl4health_tpu_torch.parallel import mesh as meshlib
from fl4health_tpu_torch.parallel import tp as tplib
from fl4health_tpu_torch.parallel.mesh import Mesh, NamedSharding, P, PartitionSpec

CLIENTS_AXIS = "clients"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh request for :class:`FederatedSimulation`.

    ``clients``: ranks along the ``"clients"`` axis (None: the world's
    ranks after the model axis is carved out). ``model`` > 1 builds the
    hybrid ``(clients, model)`` mesh for tensor-parallel transformer
    configs. ``zero1`` shards the SERVER optimizer state (FedOpt-family
    strategies) over the clients replicas, ZeRO stage 1 applied to the
    server update. ``tp_rules`` applies ``parallel/tp.py``'s Megatron
    column/row rules per param leaf (transformer models; everything
    unmatched replicates over ``"model"``). ``validate_zero1`` runs the
    construction-time sharded-vs-unsharded parity probe of
    ``parallel/zero.py`` against THIS mesh, the one ``fit()`` dispatches
    on."""

    clients: int | None = None
    model: int = 1
    zero1: bool = False
    tp_rules: bool = False
    validate_zero1: bool = True

    def __post_init__(self):
        if self.model < 1:
            raise ValueError(f"MeshConfig.model must be >= 1, got {self.model}")
        if self.clients is not None and self.clients < 1:
            raise ValueError(
                f"MeshConfig.clients must be >= 1, got {self.clients}"
            )
        if self.tp_rules and self.model < 2:
            raise ValueError(
                "MeshConfig.tp_rules needs a model axis (model >= 2): the "
                "TP rules would silently no-op on a 1-wide axis"
            )

    def build(self, devices: Sequence[Any] | int | None = None) -> Mesh:
        """The mesh over the world's ranks (``devices``: how many are
        visible, for the check alone; default the world's size)."""
        visible = (meshlib.world_size() if devices is None
                   else devices if isinstance(devices, int) else len(devices))
        n_clients_axis = self.clients or max(visible // self.model, 1)
        needed = n_clients_axis * self.model
        if needed > visible:
            raise ValueError(
                f"MeshConfig needs {n_clients_axis}x{self.model} = {needed} "
                f"devices but only {visible} are visible"
            )
        if self.model > 1:
            return meshlib.hybrid_mesh(n_clients_axis, self.model)
        return meshlib.client_mesh(n_clients_axis)


def _is_sharding(x: Any) -> bool:
    return x is None or isinstance(x, (NamedSharding, PartitionSpec))


def _map_placed(fn, tree: Any, sharding: Any) -> Any:
    """``fn(leaf, spec)`` over ``tree`` with ``sharding`` a tree or a prefix
    of it whose leaves are ``NamedSharding``s, ``PartitionSpec``s or None."""
    if _is_sharding(sharding):
        spec = sharding.spec if isinstance(sharding, NamedSharding) else sharding
        return ptu.tree_map(lambda leaf: fn(leaf, spec), tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_placed(fn, tree[k], sharding[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_placed(fn, t, s) for t, s in zip(tree, sharding))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_placed(fn, getattr(tree, f.name), getattr(sharding, f.name))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"no sharding for a {type(tree).__name__} leaf")


class RoundProgramBuilder:
    """Single construction point for the round programs' placement.

    With ``config=None`` every helper returns None and :meth:`jit` returns
    the function itself: the single-device program, bit-identical. With a
    mesh, the helpers hand back the ``NamedSharding`` trees of the round
    programs' inputs and outputs."""

    def __init__(self, config: MeshConfig | None = None, *,
                 n_clients: int | None = None,
                 devices: Sequence[Any] | int | None = None):
        self.config = config
        self.mesh: Mesh | None = None
        self.n_clients = n_clients
        if config is not None:
            self.mesh = config.build(devices)
            n_axis = self.client_axis_size
            if n_clients is not None and n_clients % n_axis != 0:
                raise ValueError(
                    f"n_clients={n_clients} must be divisible by the "
                    f"clients mesh axis ({n_axis} devices): XLA shards the "
                    "leading [C] axis evenly — pad the cohort or shrink the "
                    "axis (MeshConfig(clients=...))"
                )

    # -- facts -----------------------------------------------------------
    @property
    def n_devices(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    @property
    def client_axis_size(self) -> int:
        if self.mesh is None:
            return 1
        return int(self.mesh.shape[CLIENTS_AXIS])

    @property
    def clients_axis(self):
        """The mesh's clients ``Axis`` (None without a mesh)."""
        return self.mesh.axis(CLIENTS_AXIS) if self.mesh is not None else None

    @property
    def model_axis(self):
        """The mesh's model ``Axis`` (None without one)."""
        if self.mesh is None or MODEL_AXIS not in self.mesh.shape:
            return None
        return self.mesh.axis(MODEL_AXIS)

    def client_block(self, n_clients: int | None = None) -> tuple[int, int]:
        """``[lo, hi)``: the global client rows this rank holds."""
        n = self.n_clients if n_clients is None else n_clients
        if self.mesh is None:
            return 0, n
        axis = self.clients_axis
        b = n // axis.size
        return axis.index * b, (axis.index + 1) * b

    def descriptor(self) -> dict | None:
        """JSON-able mesh + sharding-policy descriptor (manifest,
        ``program`` events)."""
        if self.mesh is None:
            return None
        desc = meshlib.mesh_descriptor(self.mesh)
        desc["zero1"] = bool(self.config.zero1)
        desc["tp_rules"] = bool(self.config.tp_rules)
        return desc

    @staticmethod
    def donate(*argnums: int) -> tuple[int, ...]:
        """JAX gates buffer donation off its CPU backend; the port's eager
        programs donate nothing on either device."""
        del argnums
        return ()

    # -- sharding trees --------------------------------------------------
    def named(self, spec: PartitionSpec) -> NamedSharding | None:
        return NamedSharding(self.mesh, spec) if self.mesh is not None else None

    def client_sharding(self) -> NamedSharding | None:
        """Leading-[C]-axis sharding for client-stacked trees (states,
        batches, masks, per-client counts)."""
        return self.named(P(CLIENTS_AXIS))

    def stacked_client_sharding(self) -> NamedSharding | None:
        """[rounds, C, ...] chunk inputs: clients on axis 1. The cohort
        chunk's window trees get none (JAX's reason: W is not a multiple of
        the device count in general)."""
        return self.named(P(None, CLIENTS_AXIS))

    def replicated(self) -> NamedSharding | None:
        return self.named(P())

    def client_state_shardings(self, template: Any) -> Any:
        """Sharding (tree) for the client-stacked ``TrainState``: one
        ``P("clients")`` prefix, or with ``tp_rules`` per-leaf hybrid specs
        (``P("clients", <tp dims>)``) on the params and optimizer state."""
        if self.mesh is None:
            return None
        cs = self.client_sharding()
        if not self.config.tp_rules:
            return cs
        params_t = template.params

        def place(subtree):
            specs = tplib.spec_like_params(
                subtree, params_t, axis=MODEL_AXIS, client_axis=CLIENTS_AXIS,
                default=P(CLIENTS_AXIS))
            return _specs_to_named(specs, self)

        return dataclasses.replace(
            template,
            params=place(params_t),
            opt_state=place(template.opt_state),
            model_state=cs if ptu.tree_leaves(template.model_state) else {},
            rng=cs,
            step=cs,
            extra=cs if ptu.tree_leaves(template.extra) else None,
            loss_scale=cs if ptu.tree_leaves(template.loss_scale) else None,
        )

    def server_state_shardings(self, strategy: Any, template: Any) -> Any:
        """Sharding (tree) for the server state: replicated unless the
        strategy declares per-leaf specs through ``state_sharding_spec``
        (the ZeRO-1 server optimizer, wrapper strategies' per-client
        bookkeeping)."""
        if self.mesh is None:
            return None
        spec_tree = None
        hook = getattr(strategy, "state_sharding_spec", None)
        if hook is not None:
            spec_tree = hook(template, CLIENTS_AXIS)
        if spec_tree is None:
            return self.replicated()
        return _specs_to_named(spec_tree, self)

    def put(self, tree: Any, sharding: Any) -> Any:
        """This rank's block of a global tree placed by ``sharding`` (a tree
        or a prefix); the tree itself without a mesh."""
        if self.mesh is None or sharding is None:
            return tree
        return _map_placed(lambda x, spec: meshlib._blocked(x, spec, self.mesh),
                           tree, sharding)

    def gather(self, tree: Any, sharding: Any) -> Any:
        """The global tree from every rank's block (an all-gather a sharded
        dimension): :meth:`put`'s inverse."""
        if self.mesh is None or sharding is None:
            return tree
        return _map_placed(lambda x, spec: meshlib._gathered(x, spec, self.mesh),
                           tree, sharding)

    # -- the one "jit" ---------------------------------------------------
    def jit(self, fn, *, donate: tuple[int, ...] = (),
            in_shardings: Any = None, out_shardings: Any = None):
        """The round program: ``fn`` itself without a mesh; with one, ``fn``
        run with the mesh's clients axis active, so its reductions over
        clients span every rank. Its inputs are already this rank's blocks
        (``in_shardings`` and ``out_shardings`` describe them)."""
        del donate, in_shardings, out_shardings
        if self.mesh is None:
            return fn
        axis = self.clients_axis

        def program(*args, **kwargs):
            with compat.client_axis(axis, self.client_block()[0]):
                return fn(*args, **kwargs)

        program.__wrapped__ = fn
        return program


def _specs_to_named(spec_tree: Any, builder: RoundProgramBuilder) -> Any:
    """A spec tree with each ``PartitionSpec`` leaf a ``NamedSharding``."""
    if isinstance(spec_tree, PartitionSpec):
        return builder.named(spec_tree)
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: _specs_to_named(v, builder) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_specs_to_named(v, builder) for v in spec_tree)
    if dataclasses.is_dataclass(spec_tree) and not isinstance(spec_tree, type):
        return dataclasses.replace(spec_tree, **{
            f.name: _specs_to_named(getattr(spec_tree, f.name), builder)
            for f in dataclasses.fields(spec_tree)})
    return spec_tree
