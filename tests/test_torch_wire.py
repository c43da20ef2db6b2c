"""The port's wire format (``deeplearning4j_tpu_torch/streaming/wire.py``)
held against the JAX package's (``deeplearning4j_tpu/streaming/wire.py``).

The ``none`` codec's bytes bitwise; the ``bf16`` codes bitwise against the
JAX codec's (``ml_dtypes``) on random floats, rounding ties, the largest
finite values, infinities, subnormals and -0, with every NaN still a NaN
(and the quiet NaN of its sign, as ``ml_dtypes`` gives it); frames sent by
one package's ``send_frame`` and read by the other's ``recv_frame`` over a
``socketpair``, both ways, with scatter-gather payloads, reusable buffers
and EOF; ``pack_arrays``/``unpack_arrays`` across packages.
"""
import socket

import numpy as np
import pytest

from deeplearning4j_tpu.streaming import wire as jwire
from deeplearning4j_tpu_torch.streaming import wire


def _special_floats():
    rng = np.random.default_rng(0)
    base = rng.normal(0, 3, 4096).astype(np.float32)
    wide = (rng.normal(size=2048) * 10.0 ** rng.integers(-40, 38, 2048)
            ).astype(np.float32)
    u = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    raw = u.view(np.float32)  # every bit pattern, NaNs included
    # exact ties: low 16 bits 0x8000, with even and odd kept bits
    ties = (rng.integers(0, 2 ** 16, 512, dtype=np.uint64).astype(np.uint32)
            << 16 | 0x8000).view(np.float32)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                      np.finfo(np.float32).max, -np.finfo(np.float32).max,
                      np.finfo(np.float32).tiny, 1e-45, -1e-45, 3e-39,
                      -3e-39, 1.0, -1.0, 65504.0], np.float32)
    sub = (rng.integers(1, 2 ** 23, 512, dtype=np.uint64).astype(np.uint32)
           ).view(np.float32)  # subnormals
    return np.concatenate([base, wide, raw, ties, edges, sub, -sub])


def test_none_codec_bitwise_against_jax():
    rng = np.random.default_rng(3)
    for a in (rng.normal(size=(5, 7)).astype(np.float32),
              rng.integers(-9, 9, (4, 3)).astype(np.int64),
              np.float32(2.5), np.zeros((0, 3), np.float32),
              rng.normal(size=(3, 4)).astype(np.float64)[:, ::2]):
        a = np.asarray(a)
        jm, jb = jwire.encode_array(a, "none")
        pm, pb = wire.encode_array(a, "none")
        assert jm == pm
        assert bytes(jb) == bytes(pb)
        np.testing.assert_array_equal(wire.decode_array(jm, jb), a)
        np.testing.assert_array_equal(jwire.decode_array(pm, pb), a)


def test_bf16_codes_bitwise_against_jax():
    import ml_dtypes
    a = _special_floats()
    jm, jb = jwire.encode_array(a, "bf16")
    pm, pb = wire.encode_array(a, "bf16")
    assert jm == pm and pm["codec"] == "bf16"
    assert len(pb) == 2 * a.size
    jc = np.frombuffer(jb, np.uint16)
    pc = np.frombuffer(pb, np.uint16)
    nan = np.isnan(a)
    assert nan.sum() > 10
    np.testing.assert_array_equal(pc[~nan], jc[~nan])
    # every NaN is still a NaN, the quiet NaN of its sign, as ml_dtypes
    # gives it
    np.testing.assert_array_equal(pc[nan], jc[nan])
    assert np.all(np.isnan(a.astype(ml_dtypes.bfloat16)[nan]
                           .astype(np.float32)))
    # decodes agree both ways, NaN where NaN
    pd = wire.decode_array(pm, pb)
    jd = jwire.decode_array(jm, jb)
    assert pd.dtype == np.float32 and pd.shape == a.shape
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(wire.decode_array(jm, jb), jd)
    np.testing.assert_array_equal(jwire.decode_array(pm, pb), pd)
    # -0 stays -0, infinities stay infinite
    for v in (-0.0, np.inf, -np.inf):
        got = wire.decode_array(*wire.encode_array(
            np.array([v], np.float32), "bf16"))[0]
        assert got == v and np.signbit(got) == np.signbit(v)


def test_bf16_rounds_to_nearest_even():
    # 1 + 2^-8 is a tie between 1 and 1 + 2^-7: even (1.0) wins; 1 + 3*2^-8
    # ties between odd 1+2^-7 and even 1+2^-6: 1+2^-6 wins
    a = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -8 + 2 ** -20],
                 np.float32)
    got = wire.decode_array(*wire.encode_array(a, "bf16"))
    np.testing.assert_array_equal(got, np.array(
        [1.0, 1 + 2 ** -6, 1 + 2 ** -7], np.float32))


def test_bf16_passes_integers_through_and_rejects_unknown_codecs():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    meta, buf = wire.encode_array(a, "bf16")
    assert meta["codec"] == "none"
    np.testing.assert_array_equal(wire.decode_array(meta, buf), a)
    with pytest.raises(ValueError, match="codec"):
        wire.encode_array(a, "zip")


def _roundtrip(sender, receiver, header, payload, buffer=None):
    a, b = socket.socketpair()
    try:
        n = sender.send_frame(a, header, payload)
        got_h, got_p = (receiver.recv_frame(b) if buffer is None
                        else receiver.recv_frame(b, buffer))
        return n, got_h, bytes(got_p)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_frames_cross_packages(direction):
    sender, receiver = ((jwire, wire) if direction == "jax_to_port"
                        else (wire, jwire))
    rng = np.random.default_rng(5)
    arrays = {"x": rng.normal(size=(3, 4)).astype(np.float32),
              "y": np.eye(3, dtype=np.float32)[[0, 2, 1]],
              "ids": np.arange(5, dtype=np.int64)}
    for codec in ("none", "bf16"):
        metas, views = sender.pack_arrays(arrays, codec)
        header = {"op": "publish", "topic": "t", "meta": {"arrays": metas}}
        n, got_h, got_p = _roundtrip(sender, receiver, header, views)
        assert got_h == header
        assert n == 8 + len(str.encode(
            __import__("json").dumps(header, separators=(",", ":")))) \
            + len(got_p)
        out = receiver.unpack_arrays(got_h["meta"]["arrays"], got_p)
        ref = sender.unpack_arrays(metas, b"".join(bytes(v) for v in views))
        for k in arrays:
            np.testing.assert_array_equal(out[k], ref[k])
    # an empty payload, a reusable receive buffer
    n, got_h, got_p = _roundtrip(sender, receiver, {"op": "pull"}, b"",
                                 buffer=bytearray(4))
    assert got_h == {"op": "pull"} and got_p == b""
    n, got_h, got_p = _roundtrip(sender, receiver, {"op": "x", "n": 3},
                                 b"\x00\x01payload", buffer=bytearray(2))
    assert got_h == {"op": "x", "n": 3} and got_p == b"\x00\x01payload"


def test_recv_frame_eof_is_an_error_and_request_raises_error_replies():
    a, b = socket.socketpair()
    try:
        wire.send_frame(a, {"op": "x"}, b"abc")
        assert wire.recv_frame(b)[0] == {"op": "x"}
        a.close()
        with pytest.raises(ConnectionError):
            wire.recv_frame(b)  # EOF mid-stream is an error, not b""
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        jwire.send_frame(b, {"error": "boom"})  # the peer's reply, queued
        with pytest.raises(RuntimeError, match="boom"):
            wire.request(a, {"op": "anything"})
    finally:
        a.close()
        b.close()


def test_decode_copy_counts_bytes():
    a = np.arange(10, dtype=np.float32)
    meta, buf = wire.encode_array(a)
    before = wire.stats()["copy_bytes"].get("decode", 0)
    out = wire.decode_array(meta, buf, copy=True)
    out[0] = 7.0  # private and writable
    assert a[0] == 0.0
    assert wire.stats()["copy_bytes"]["decode"] == before + 40
    view = wire.decode_array(meta, bytes(buf))  # a received payload
    assert not view.flags.writeable
