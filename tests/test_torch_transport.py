"""The port's cross-silo wire against the JAX package's on the CPU: dense,
COO, compressed (with top-k ties, int8 and int4) and traced frames byte for
byte equal in both directions for trees that mix f32, f64, bf16 and int32
leaves, nested dicts and a list; each package decoding the other's frames
to the same values; the native framing against its Python twin; a flipped
byte raising ``FrameError`` in both; the trace context's flow ids; the
loopback server.

Tolerance: none. A frame is bytes, and decoded values are equal."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import ml_dtypes
import numpy as np
import pytest
import torch

from fl4health_tpu.compression.config import CompressionConfig as JComp
from fl4health_tpu.exchange.packer import SparseMaskPacket as JSparse
from fl4health_tpu.observability import tracectx as jtrace
from fl4health_tpu.transport import codec as jcodec
from fl4health_tpu.transport import native as jnative
from fl4health_tpu_torch.compression.config import CompressionConfig as TComp
from fl4health_tpu_torch.exchange.packer import SparseMaskPacket as TSparse
from fl4health_tpu_torch.observability import tracectx as ttrace
from fl4health_tpu_torch.transport import LoopbackServer, call
from fl4health_tpu_torch.transport import codec as tcodec
from fl4health_tpu_torch.transport import native as tnative


def _arrays(seed=0):
    r = np.random.default_rng(seed)
    return {
        "k": r.standard_normal((5, 7)).astype(np.float32),
        "b": r.standard_normal((7,)).astype(np.float32),
        "h": r.standard_normal((3, 4)).astype(ml_dtypes.bfloat16),
        "d": r.standard_normal((2, 3)),
        "i": r.integers(-50, 50, (6,)).astype(np.int32),
    }


def _trees(seed=0):
    """The same tree in both packages' layouts: JAX's nested flax dict, the
    port's flat ``Params`` of tensors."""
    a = _arrays(seed)
    jax_tree = {"params": {"Dense_0": {"kernel": a["k"], "bias": a["b"]},
                           "Embed_0": {"embedding": a["h"]}},
                "stats": [a["d"], a["i"]], "n": np.float32(12.0), "loss": np.float64(0.25)}
    port_tree = {"params": {"Dense_0/kernel": torch.tensor(a["k"]),
                            "Dense_0/bias": torch.tensor(a["b"]),
                            "Embed_0/embedding": torch.tensor(a["h"].astype(np.float32))
                            .to(torch.bfloat16)},
                 "stats": [torch.tensor(a["d"]), torch.tensor(a["i"])],
                 "n": torch.tensor(12.0), "loss": 0.25}
    return jax_tree, port_tree


def _flat_np(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_np(v, f"{prefix}.{k}".replace("/", ".").lstrip(".")))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_np(v, f"{prefix}.[{i}]"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = (tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy(),
                       str(tree.dtype).replace("torch.", ""))
    else:
        arr = np.asarray(tree)
        out[prefix] = (arr.astype(np.float32) if arr.dtype == ml_dtypes.bfloat16 else arr,
                       str(arr.dtype))
    return out


def _assert_same_values(port_tree, jax_tree):
    got, want = _flat_np(port_tree), _flat_np(jax_tree)
    assert set(got) == set(want)
    for k in want:
        assert got[k][1] == want[k][1], k
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_frames_are_byte_identical_both_ways(seed):
    jt, tt = _trees(seed)
    frame = tcodec.encode(tt)
    assert frame == jcodec.encode(jt)
    _assert_same_values(tcodec.decode(jcodec.encode(jt), like=tt), jt)
    _assert_same_values(tcodec.decode(frame, like=tt), jcodec.decode(frame, like=jt))
    # without a template both give nested dicts of the same values
    _assert_same_values(tcodec.decode(frame), jcodec.decode(frame))
    # the port's template layout survives: flat Params keys, a list, dtypes
    back = tcodec.decode(frame, like=tt)
    assert list(back["params"]) == list(tt["params"])
    assert back["params"]["Embed_0/embedding"].dtype == torch.bfloat16
    assert back["stats"][1].dtype == torch.int32 and back["loss"].dtype == torch.float64


def test_dataclass_and_namedtuple_nodes_take_jax_attribute_paths():
    """A packet dataclass and a namedtuple cross under JAX's ``GetAttrKey``
    paths (``p..params.w``, ``nt..b``) and rebuild as themselves."""
    import collections

    from fl4health_tpu.exchange.packer import AdaptiveConstraintPacket as JPacket
    from fl4health_tpu_torch.exchange.packer import AdaptiveConstraintPacket as TPacket

    pair = collections.namedtuple("Pair", ["b", "a"])
    jt = {"p": JPacket(params={"w": np.ones(2, np.float32)},
                       loss_for_adaptation=np.float32(0.5)),
          "nt": pair(np.float32(1), np.float32(2))}
    tt = {"p": TPacket(params={"w": torch.ones(2)}, loss_for_adaptation=torch.tensor(0.5)),
          "nt": pair(torch.tensor(1.0), torch.tensor(2.0))}
    frame = tcodec.encode(tt)
    assert frame == jcodec.encode(jt)
    back = tcodec.decode(frame, like=tt)
    assert isinstance(back["p"], TPacket) and isinstance(back["nt"], pair)
    assert float(back["nt"].a) == 2.0 and back["p"].params["w"].tolist() == [1.0, 1.0]


def test_card_layout_tensors_encode_as_their_values():
    """Non-contiguous and transposed tensors encode their C-order values."""
    jt, tt = _trees()
    tt["params"]["Dense_0/kernel"] = torch.tensor(_arrays()["k"].T.copy()).T
    assert tcodec.encode(tt) == jcodec.encode(jt)


def test_template_mismatch_names_the_path_in_both():
    jt, tt = _trees()
    frame = tcodec.encode(tt)
    bad_t = {**tt, "params": {**tt["params"], "Dense_1/kernel": torch.zeros(1)}}
    bad_j = {**jt, "params": {**jt["params"], "Dense_1": {"kernel": np.zeros(1)}}}
    with pytest.raises(ValueError) as te:
        tcodec.decode(frame, like=bad_t)
    with pytest.raises(ValueError) as je:
        jcodec.decode(frame, like=bad_j)
    assert str(te.value) == str(je.value) and "params.Dense_1.kernel" in str(te.value)


def _sparse(seed=0):
    a = _arrays(seed)
    r = np.random.default_rng(seed + 10)
    mk = (r.random(a["k"].shape) < 0.3).astype(np.float32)
    mb = (r.random(a["b"].shape) < 0.5).astype(np.float32)
    jp = JSparse(params={"Dense_0": {"kernel": a["k"], "bias": a["b"]}},
                 element_mask={"Dense_0": {"kernel": mk, "bias": mb}})
    tp = TSparse(params={"Dense_0/kernel": torch.tensor(a["k"]),
                         "Dense_0/bias": torch.tensor(a["b"])},
                 element_mask={"Dense_0/kernel": torch.tensor(mk),
                               "Dense_0/bias": torch.tensor(mb)})
    return jp, tp


def test_coo_frames_are_byte_identical_both_ways():
    jp, tp = _sparse()
    frame = tcodec.encode_sparse(tp)
    assert frame == jcodec.encode_sparse(jp)
    jback = jcodec.decode_sparse(frame, like=jp)
    tback = tcodec.decode_sparse(jcodec.encode_sparse(jp), like=tp)
    _assert_same_values(tback.params, jback.params)
    _assert_same_values(tback.element_mask, jback.element_mask)
    with pytest.raises(ValueError, match="use decode_sparse"):
        tcodec.decode(frame)


def _tie_tree():
    """Magnitude plateaus across leaves, so top-k breaks ties by the lowest
    flat index, plus an integer leaf."""
    k = np.array([[0.5, -0.5, 0.25], [0.5, 0.1, -0.5]], np.float32)
    b = np.array([-0.5, 0.25, 0.0, 0.5], np.float32)
    i = np.array([3, -7, 2], np.int32)
    jt = {"a": {"kernel": k, "bias": b}, "z": i}
    tt = {"a/kernel": torch.tensor(k), "a/bias": torch.tensor(b), "z": torch.tensor(i)}
    return jt, tt


@pytest.mark.parametrize("topk,bits", [(0.4, 8), (0.4, 4), (0.4, None), (None, 8),
                                       (None, 4), (0.1, 8)])
@pytest.mark.parametrize("tree", ["ties", "mixed"])
def test_compressed_frames_are_byte_identical_both_ways(topk, bits, tree):
    if tree == "ties":
        jt, tt = _tie_tree()
    else:
        jt, tt = _trees(3)
        jt, tt = jt["params"], tt["params"]
    frame = tcodec.encode_compressed(tt, TComp(topk_fraction=topk, quant_bits=bits))
    assert frame == jcodec.encode_compressed(jt, JComp(topk_fraction=topk, quant_bits=bits))
    _assert_same_values(tcodec.decode_compressed(frame, like=tt),
                        jcodec.decode_compressed(frame, like=jt))


def test_top_k_ties_and_non_finite_selection_match_jax():
    r = np.random.default_rng(5)
    for _ in range(20):
        v = np.round(r.standard_normal(64), 1).astype(np.float32)
        v[r.integers(0, 64, 3)] = np.nan
        v[r.integers(0, 64, 2)] = np.inf
        for k in (1, 3, 5, 17, 64):
            np.testing.assert_array_equal(tcodec._global_topk_indices(np.abs(v), k),
                                          jcodec._global_topk_indices(np.abs(v), k))


def test_traced_frames_match_and_carry_the_same_flow_id():
    jt, tt = _trees()
    ctx = ttrace.TraceContext.fresh(round=4)
    frame = tcodec.encode(tt, trace=ctx.to_header())
    assert frame == jcodec.encode(jt, trace=ctx.to_header())
    assert tcodec.frame_trace(frame) == jcodec.frame_trace(frame) == ctx.to_header()
    assert tcodec.frame_trace(b"garbage") is None
    jctx = jtrace.TraceContext.from_header(jcodec.frame_trace(frame))
    assert ttrace.flow_id(ctx.trace_id, 4) == jtrace.flow_id(jctx.trace_id, jctx.round)
    # the traced payload decodes as the untraced one
    _assert_same_values(tcodec.decode(frame, like=tt), jt)


@pytest.mark.parametrize("flags", [0, 1, 2])
def test_native_and_python_framing_write_the_same_bytes(flags):
    lib = tnative.get_native()
    assert lib is not None, "g++ builds the framing here"
    assert isinstance(tnative.get_framing(), tnative.NativeFraming)
    header, payload = b'{"leaves": []}', bytes(range(256)) * 5
    nat, py = tnative.NativeFraming(lib), tnative.PyFraming()
    frame = nat.frame(header, payload, flags)
    assert frame == py.frame(header, payload, flags) == jnative.PyFraming().frame(
        header, payload, flags)
    assert nat.unframe(frame) == py.unframe(frame) == (header, payload, flags)
    assert nat.crc32(payload) == py.crc32(payload)


def test_int4_nibbles_match_jax_and_the_twin():
    vals = np.random.default_rng(2).integers(-8, 8, 101).astype(np.int8)
    packed = tnative.pack_int4(vals)
    assert packed == tnative._pack_int4_py(vals) == jnative._pack_int4_py(vals)
    np.testing.assert_array_equal(tnative.unpack_int4(packed, vals.size), vals)
    np.testing.assert_array_equal(tnative._unpack_int4_py(packed, vals.size), vals)
    with pytest.raises(tnative.FrameError):
        tnative.unpack_int4(packed[:10], vals.size)


@pytest.mark.parametrize("kind", ["dense", "coo", "compressed"])
def test_a_flipped_byte_raises_frame_error_in_both(kind):
    jt, tt = _trees()
    if kind == "dense":
        frame, tdec, jdec = tcodec.encode(tt), tcodec.decode, jcodec.decode
    elif kind == "coo":
        frame = tcodec.encode_sparse(_sparse()[1])
        tdec, jdec = tcodec.decode_sparse, jcodec.decode_sparse
    else:
        frame = tcodec.encode_compressed(tt["params"], TComp(topk_fraction=0.5, quant_bits=8))
        tdec, jdec = tcodec.decode_compressed, jcodec.decode_compressed
    for pos in (0, 9, len(frame) // 2, len(frame) - 1):
        bad = bytearray(frame)
        bad[pos] ^= 0xFF
        for framing in (tnative.get_framing(), tnative.PyFraming()):
            with pytest.raises(tnative.FrameError):
                framing.unframe(bytes(bad))
        with pytest.raises(tnative.FrameError):
            tdec(bytes(bad))
        with pytest.raises(jnative.FrameError):
            jdec(bytes(bad))


def test_no_native_env_selects_the_twin(monkeypatch):
    monkeypatch.setenv("FL4HEALTH_NO_NATIVE", "1")
    assert tnative.get_native() is None
    assert isinstance(tnative.get_framing(), tnative.PyFraming)


def test_loopback_serves_a_port_handler_to_a_jax_caller():
    jt, tt = _trees()

    def handler(frame):
        tree = tcodec.decode(frame, like=tt)
        tree["params"]["Dense_0/bias"] = tree["params"]["Dense_0/bias"] + 1
        return tcodec.encode(tree)

    srv = LoopbackServer(handler)
    try:
        reply = jcodec.decode(call(srv.host, srv.port, jcodec.encode(jt)), like=jt)
        # a corrupt request drops the connection; the server lives on
        with pytest.raises(ConnectionError):
            call(srv.host, srv.port, b"not a frame", timeout=5.0)
        again = tcodec.decode(call(srv.host, srv.port, tcodec.encode(tt)), like=tt)
    finally:
        srv.close()
    np.testing.assert_array_equal(reply["params"]["Dense_0"]["bias"], jt["params"]["Dense_0"]
                                  ["bias"] + 1)
    np.testing.assert_array_equal(again["params"]["Dense_0/bias"].numpy(),
                                  jt["params"]["Dense_0"]["bias"] + 1)


def test_traced_handler_stamps_the_silo_span_as_jax():
    from fl4health_tpu_torch.observability.spans import Tracer, set_tracer

    jt, tt = _trees()
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        ctx = ttrace.TraceContext.fresh(round=2)
        frame = tcodec.encode(tt, trace=ctx.to_header())
        wrapped = ttrace.traced_handler(lambda f: f[::-1], name="silo_handle")
        assert wrapped(frame) == frame[::-1]
        assert wrapped(b"untraced") == b"untraced"[::-1]
    finally:
        set_tracer(prev)
    spans = tracer.spans_named("silo_handle")
    assert len(spans) == 1 and spans[0]["args"]["trace_id"] == ctx.trace_id
    flows = [e for e in tracer.events if e.get("ph") == "t"]
    assert [f["id"] for f in flows] == [jtrace.flow_id(ctx.trace_id, 2)]


def test_wire_bytes_land_under_jax_counter_names():
    """Each package's codec counts its frames in its own process registry,
    under the same names and labels."""
    from fl4health_tpu.observability.registry import MetricsRegistry as JRegistry
    from fl4health_tpu.observability.registry import set_registry as jset
    from fl4health_tpu_torch.observability.registry import MetricsRegistry as TRegistry
    from fl4health_tpu_torch.observability.registry import set_registry as tset

    jt, tt = _trees()
    comp = dict(topk_fraction=0.5, quant_bits=4)
    snaps = []
    for reg_cls, setter, codec, tree, cfg in ((JRegistry, jset, jcodec, jt, JComp),
                                              (TRegistry, tset, tcodec, tt, TComp)):
        reg = reg_cls()
        prev = setter(reg)
        try:
            codec.decode(codec.encode(tree))
            codec.decode_compressed(codec.encode_compressed(tree["params"], cfg(**comp)))
        finally:
            setter(prev)
        snaps.append(reg.snapshot())
    jsnap, tsnap = snaps
    names = [n for n in jsnap if n.startswith(("transport_", "fl_wire_"))]
    assert len(names) >= 6
    for n in names:
        assert tsnap[n] == jsnap[n], n
