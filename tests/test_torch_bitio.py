"""The encoder's small host modules in the port against their originals:
`bitio`'s writers (bytes equal, read back by the JAX package's `HuffReader`),
`plans.build_nest` and `gop.reorder_display_to_decode`. Everything here is
integer or byte data and is compared exactly.
"""

import numpy as np
import pytest

from hvqm4_tpu import bitio as jbitio
from hvqm4_tpu import gop as jgop
from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.plans import build_nest as jax_build_nest
from hvqm4_tpu_torch import bitio, gop
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.plans import build_nest


def _events(kind: str, seed: int):
    """A seeded sequence of ("sym", value, 0) and ("raw", value, nbits)."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return []
    if kind == "one_symbol":
        return [("sym", 42, 0)] * 9
    if kind == "one_symbol_with_raw":
        return [("sym", 7, 0), ("raw", 200, 8), ("sym", 7, 0), ("raw", 1, 1)]
    if kind == "two_symbols":
        return [("sym", int(v), 0) for v in rng.integers(3, 5, 40)]
    if kind == "many":
        # a skewed alphabet: deep and shallow leaves, ties in the counts
        return [("sym", int(v), 0)
                for v in np.minimum(rng.geometric(0.08, 600) - 1, 255)]
    assert kind == "many_with_raw"
    out = []
    for v in rng.integers(0, 256, 400):
        out.append(("sym", int(v), 0))
        if v == 255:
            out.append(("raw", int(rng.integers(0, 1 << 16)), 16))
        elif v % 7 == 0:
            n = int(rng.integers(1, 13))
            out.append(("raw", int(rng.integers(0, 1 << n)), n))
    return out


KINDS = ["empty", "one_symbol", "one_symbol_with_raw", "two_symbols", "many",
         "many_with_raw"]


def _fill(hw, events):
    for kind, v, n in events:
        if kind == "sym":
            hw.put_symbol(v)
        else:
            hw.put_raw(v, n)
    return hw


@pytest.mark.parametrize("kind", KINDS)
def test_huff_writer_bytes_match_jax_and_read_back(kind):
    events = _events(kind, seed=len(kind))
    got = _fill(bitio.HuffWriter(), events).encode()
    assert got == _fill(jbitio.HuffWriter(), events).encode()
    assert (got == b"") == (not events)
    if events:
        r = jbitio.HuffReader(got)
        back = [("sym", r.symbol(), 0) if k == "sym" else ("raw", r.raw(n), n)
                for k, _v, n in events]
        assert back == events


@pytest.mark.parametrize("kind", KINDS)
def test_build_tree_and_code_table_match_jax(kind):
    syms = [v for k, v, _n in _events(kind, seed=3) if k == "sym"]
    tree = bitio.build_tree(syms)
    assert tree == jbitio.build_tree(syms)
    assert bitio.code_table(tree) == jbitio.code_table(tree)
    if tree is not None:
        w, jw = bitio.BitWriter(), jbitio.BitWriter()
        bitio.write_tree(w, tree)
        jbitio.write_tree(jw, tree)
        assert w.getvalue() == jw.getvalue()
        assert jbitio.read_tree(jbitio.BitReader(w.getvalue())) == tree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bit_writer_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w, jw = bitio.BitWriter(), jbitio.BitWriter()
    assert w.getvalue() == jw.getvalue() == b""
    for _ in range(300):
        n = int(rng.integers(1, 33))
        v = int(rng.integers(0, 1 << n))
        if rng.random() < 0.3:
            s = v - (1 << (n - 1))
            w.write_signed(s, n)
            jw.write_signed(s, n)
        else:
            w.write_bits(v, n)
            jw.write_bits(v, n)
        assert w.bit_length() == jw.bit_length()
    assert w.getvalue() == jw.getvalue()
    assert len(w.getvalue()) == -(-w.bit_length() // 8)


def test_huff_writer_raw_without_symbols_raises():
    for mod in (bitio, jbitio):
        hw = mod.HuffWriter()
        hw.put_raw(5, 4)
        with pytest.raises(ValueError, match="raw bits in a Huffman stream "
                                             "with no symbols"):
            hw.encode()


@pytest.mark.parametrize("size,origin", [
    ((64, 48), (0, 0)), ((64, 48), (15, 11)), ((640, 480), (150, 110)),
    ((32, 16), (7, 3)), ((320, 240), (79, 59))])
def test_build_nest_matches_jax(size, origin):
    """Origins near the far corner, so that both axes wrap; at 64x48 and
    32x16 the grid is smaller than the nest and wraps more than once."""
    cfg, jcfg = SeqConfig(*size), JaxSeqConfig(*size)
    rng = np.random.default_rng(size[0] + origin[0])
    dcg = rng.integers(0, 256, cfg.block_grids[0], dtype=np.uint8)
    nest = build_nest(cfg, dcg, *origin)
    assert nest.dtype == np.uint8 and nest.shape == cfg.nest_shape
    assert np.array_equal(nest, jax_build_nest(jcfg, dcg, *origin))


GOOD = ["I", "IP", "IPP", "IPPP", "IPPPP", "IPPPPP", "IPPPPPPP", "IPB", "IBP",
        "IPBP", "IBPB", "IBPBP", "IPBPB", "IBBPB", "IBBPBP", "IPBPBPBP",
        "IPBPBPBPB", "P"]
BAD = ["IB", "IBB", "B", "PB", "BBP", "BP", "IXP", "ipp"]


@pytest.mark.parametrize("pattern", GOOD + BAD)
def test_gop_reorder_matches_jax(pattern):
    try:
        want = jgop.reorder_display_to_decode(pattern)
    except ValueError as e:
        assert pattern in BAD
        with pytest.raises(ValueError) as got:
            gop.reorder_display_to_decode(pattern)
        assert str(got.value) == str(e)
    else:
        assert pattern not in BAD
        assert gop.reorder_display_to_decode(pattern) == want
        assert sorted(d for _f, d in want) == list(range(len(pattern)))
