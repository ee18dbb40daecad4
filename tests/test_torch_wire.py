"""The port's binary wire codec (mmlspark_tpu_torch/io_http/wire.py) held to
the JAX package's: every case of tests/test_wire.py, with frames crossing
between the packages in both directions (encoded by one, decoded by the
other) and within the port."""

import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from mmlspark_tpu.io_http import wire as ref_wire  # noqa: E402
from mmlspark_tpu_torch.io_http import wire as port_wire  # noqa: E402

# (encoder, decoder)
ROUTES = {"port_to_port": (port_wire, port_wire), "port_to_ref": (port_wire, ref_wire),
          "ref_to_port": (ref_wire, port_wire)}


@pytest.fixture(params=sorted(ROUTES))
def route(request):
    return ROUTES[request.param]


def _raises(dec):
    """The decoding package's WireError (each package has its own class)."""
    return dec.WireError


class TestFrameRoundTrip:
    def test_every_numeric_dtype_round_trips_byte_identical(self, route):
        enc, dec = route
        rng = np.random.default_rng(0)
        cols = {}
        for name in ("float64", "float32", "int64", "int32", "int16",
                     "int8", "uint64", "uint32", "uint16", "uint8"):
            cols[name] = (rng.normal(size=7) * 100).astype(name)
        cols["bool"] = rng.normal(size=7) > 0
        buf = enc.encode_message({"k": "v"}, cols, n_rows=7)
        assert buf == ref_wire.encode_message({"k": "v"}, cols, n_rows=7)
        meta, out = dec.decode_message(buf)
        assert meta["k"] == "v"
        assert set(out) == set(cols)
        for name, col in cols.items():
            assert out[name].dtype == col.dtype, name
            assert out[name].tobytes() == col.tobytes(), name

    def test_2d_column_keeps_shape_and_row_count(self, route):
        enc, dec = route
        feats = np.arange(12, dtype=np.float64).reshape(3, 4)
        meta, out = dec.decode_message(enc.encode_message({}, {"features": feats}))
        assert out["features"].shape == (3, 4)
        np.testing.assert_array_equal(out["features"], feats)

    def test_decoded_columns_are_zero_copy_readonly_views(self, route):
        enc, dec = route
        _, out = dec.decode_message(enc.encode_message({}, {"a": np.arange(5, dtype=np.int64)}))
        assert not out["a"].flags.writeable  # frombuffer view, not a copy
        with pytest.raises((ValueError, RuntimeError)):
            out["a"][0] = 9

    def test_non_numeric_columns_ride_json_columns(self, route):
        enc, dec = route
        cols = {"x": np.asarray([1.0, 2.0]),
                "label": np.asarray(["a", "b"]),
                "tags": [["t1"], ["t2", "t3"]]}
        meta, out = dec.decode_message(enc.encode_message({"n": 1}, cols, n_rows=2))
        assert out["x"].dtype == np.float64
        assert list(out["label"]) == ["a", "b"]
        assert out["tags"] == [["t1"], ["t2", "t3"]]
        assert set(meta["json_columns"]) == {"label", "tags"}

    def test_big_endian_host_array_lands_little_endian(self, route):
        enc, dec = route
        be = np.arange(4, dtype=">f8")
        _, out = dec.decode_message(enc.encode_message({}, {"a": be}))
        assert out["a"].dtype == np.dtype("<f8")
        np.testing.assert_array_equal(out["a"], be.astype("<f8"))


class TestFrameRejection:
    def test_bad_magic(self, route):
        enc, dec = route
        buf = bytearray(enc.encode_message({}, {"a": np.zeros(2)}))
        buf[:4] = b"NOPE"
        with pytest.raises(_raises(dec), match="magic"):
            dec.decode_message(bytes(buf))

    def test_unknown_version(self, route):
        enc, dec = route
        buf = bytearray(enc.encode_message({}, {"a": np.zeros(2)}))
        buf[4] = enc.WIRE_VERSION + 1
        with pytest.raises(_raises(dec), match="version"):
            dec.decode_message(bytes(buf))

    def test_short_frame(self, route):
        _, dec = route
        with pytest.raises(_raises(dec), match="short"):
            dec.decode_message(b"MSWR")

    def test_truncated_payload(self, route):
        enc, dec = route
        buf = enc.encode_message({}, {"a": np.arange(16, dtype=np.float64)})
        with pytest.raises(_raises(dec)):
            dec.decode_message(buf[:-8])

    def test_row_count_mismatch(self, route):
        enc, dec = route
        buf = enc.encode_message({}, {"a": np.zeros(2)}, n_rows=3)
        with pytest.raises(_raises(dec), match="dim 0"):
            dec.decode_message(buf)

    def test_corrupt_meta_blob(self, route):
        enc, dec = route
        buf = bytearray(enc.encode_message({"k": 1}, {}))
        buf[enc._HEADER.size] = ord("x")  # break the JSON
        with pytest.raises(_raises(dec), match="meta"):
            dec.decode_message(bytes(buf))

    def test_unknown_dtype_tag(self, route):
        enc, dec = route
        buf = bytearray(enc.encode_message({}, {"ab": np.zeros(2)}))
        off = enc._HEADER.size + len(b"{}") + 2 + 2
        (name_len,) = struct.unpack_from("<H", buf, off - 4)
        assert name_len == 2
        buf[off] = 200
        with pytest.raises(_raises(dec), match="dtype tag"):
            dec.decode_message(bytes(buf))


class TestScoringHelpers:
    def test_features_request_round_trip(self, route):
        enc, dec = route
        row = np.asarray([1.5, -2.25, 3.0])
        out = dec.decode_features_request(enc.encode_features_request(row), 3)
        assert out.shape == (1, 3) and out.dtype == np.float64
        np.testing.assert_array_equal(out[0], row)

    def test_features_request_batch_shape(self, route):
        enc, dec = route
        x = np.arange(8, dtype=np.float64).reshape(2, 4)
        out = dec.decode_features_request(enc.encode_features_request(x), 4)
        np.testing.assert_array_equal(out, x)

    def test_features_request_wrong_width_rejected(self, route):
        enc, dec = route
        buf = enc.encode_features_request(np.zeros(3))
        with pytest.raises(_raises(dec), match="shape"):
            dec.decode_features_request(buf, 5)

    def test_features_request_missing_column_rejected(self, route):
        enc, dec = route
        buf = enc.encode_message({}, {"not_features": np.zeros((1, 3))})
        with pytest.raises(_raises(dec), match="features"):
            dec.decode_features_request(buf, 3)

    def test_reply_round_trip_scalar_and_vector(self, route):
        enc, dec = route
        buf = enc.encode_reply("prediction", 2.5)
        assert buf == ref_wire.encode_reply("prediction", 2.5)
        col, vals = dec.decode_reply(buf)
        assert col == "prediction"
        np.testing.assert_array_equal(vals, [2.5])
        col, vals = dec.decode_reply(enc.encode_reply("scores", [0.1, 0.9]))
        assert col == "scores" and vals.shape == (1, 2)

    def test_reply_missing_value_column_rejected(self, route):
        enc, dec = route
        with pytest.raises(_raises(dec), match="value column"):
            dec.decode_reply(enc.encode_message({}, {"x": np.zeros(1)}))


class TestContentNegotiation:
    """Header helpers: the port answers as the JAX package does."""

    @pytest.mark.parametrize("ct", [port_wire.WIRE_CONTENT_TYPE,
                                    port_wire.WIRE_CONTENT_TYPE.upper() + "; charset=binary",
                                    "application/json", None])
    def test_is_wire_content_type(self, ct):
        assert port_wire.is_wire_content_type(ct) == ref_wire.is_wire_content_type(ct)
        assert port_wire.is_wire_content_type(ct) == (ct is not None and "json" not in ct)

    @pytest.mark.parametrize("headers", [
        {"Accept": f"application/json, {port_wire.WIRE_CONTENT_TYPE}"},
        {"accept": port_wire.WIRE_CONTENT_TYPE}, {"Accept": "application/json"}, {}, None])
    def test_accepts_wire_scans_accept_list(self, headers):
        want = bool(headers) and "json" != (list(headers.values())[0])[-4:]
        assert port_wire.accepts_wire(headers) == ref_wire.accepts_wire(headers) == want

    def test_content_type_of_is_case_insensitive(self):
        for mod in (port_wire, ref_wire):
            assert mod.content_type_of({"content-type": "a/b"}) == "a/b"
            assert mod.content_type_of({"Content-Type": "a/b"}) == "a/b"
            assert mod.content_type_of({}) is None
