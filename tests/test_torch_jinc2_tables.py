"""K6's per-geometry weight tables (``kernels/jinc2.py``,
``csrc/jinc2_convert.cu``) and its thread and store indexing, on the CPU.

An output's 16 Jinc2 weights depend only on its row's and its column's d2
4-vectors (``ops/scale.jinc2_axis_tables``).  ``axis_classes`` numbers an
axis's distinct vectors, compared bit for bit; K6 reads the weights of a
(row class, column class) pair from a table built once per geometry.  Here:
each output's class reproduces its d2 vector bit for bit, the class counts
at c3 (2 x 2), c3rot (32 x 9) and 1920 -> 1440 (3), the weights gathered
per class equal the per-output weights of the plain versions' torch math
bit for bit, the table's size and the cap that sends a geometry with no
short period to the per-output route, the shared-memory formula, and the
kernel's thread mapping and transposed staging (each output once, no bank
conflicts).  No GPU, no JAX, no triton.
"""

import numpy as np
import pytest
import torch

from videorenderer_tpu_torch.kernels import jinc2 as jk
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.ops import scale

C3 = (1080, 1920, 2160, 3840)       # h, w, out_h, out_w


def _table(h, w, out_h, out_w):
    """The plain weight table of a geometry's class vectors."""
    return jk.jinc2_weight_table(torch.tensor(jk.axis_classes(h, out_h)[1]),
                                 torch.tensor(jk.axis_classes(w, out_w)[1]))
C3ROT = (1080, 1920, 3840, 2160)
AXES = [(1080, 2160), (1920, 3840), (1080, 3840), (1920, 2160),
        (1920, 1440), (2160, 1080), (1079, 2160), (67, 133), (7, 5)]


@pytest.mark.parametrize("in_size,out_size", AXES)
def test_axis_classes_reproduce_d2_bit_for_bit(in_size, out_size):
    """Each output's class holds its own d2 vector bit for bit, the classes
    are distinct, and every class is used."""
    _, d2 = scale.jinc2_axis_tables(in_size, out_size)
    cls, reps = jk.axis_classes(in_size, out_size)
    assert cls.shape == (out_size,) and cls.dtype == np.int32
    assert reps.shape[0] == 4 and reps.dtype == np.float32
    assert np.array_equal(reps[:, cls].view(np.uint32), d2.view(np.uint32))
    keys = {tuple(c) for c in reps.T.view(np.uint32).tolist()}
    assert len(keys) == reps.shape[1]
    assert set(cls.tolist()) == set(range(reps.shape[1]))


@pytest.mark.parametrize("in_size,out_size,count", [
    (1080, 2160, 2), (1920, 3840, 2), (1080, 3840, 32), (1920, 2160, 9),
    (1920, 1440, 3), (2160, 1080, 1), (1079, 2160, 2160)])
def test_class_counts(in_size, out_size, count):
    """c3 has 2 x 2 classes, c3rot 32 x 9, 1920 -> 1440 3; 1079 -> 2160
    has no short period, one class an output."""
    assert jk.axis_classes(in_size, out_size)[1].shape[1] == count


def _per_output_weights(h, w, out_h, out_w, rows, cols):
    """The plain versions' weights of outputs (rows x cols), as
    ``_jinc2_plain`` computes them: g(d2y[jo] + d2x[io]) per output, the
    sum in tap order."""
    _, dy = scale.jinc2_axis_tables(h, out_h)
    _, dx = scale.jinc2_axis_tables(w, out_w)
    dy = torch.tensor(dy[:, rows])
    dx = torch.tensor(dx[:, cols])
    out, wsum = [], None
    for jo in range(4):
        for io in range(4):
            wgt = jk._weight(dy[jo][:, None] + dx[io][None, :])
            out.append(wgt)
            wsum = wgt if wsum is None else wsum + wgt
    return torch.stack(out + [wsum], dim=-1)


@pytest.mark.parametrize("geom", [C3, C3ROT, (1080, 1920, 1440, 1920),
                                  (67, 61, 133, 128)])
def test_table_gather_equals_per_output_weights(geom):
    """The plain table gathered at each output's (row class, column class)
    equals the per-output weights and their sum bit for bit, over rows and
    columns spanning several periods; the 3 pad floats are zero."""
    h, w, out_h, out_w = geom
    rows, cols = np.arange(min(out_h, 70)), np.arange(min(out_w, 40))
    table = _table(h, w, out_h, out_w)
    rc = jk.axis_classes(h, out_h)[0][rows]
    cc = jk.axis_classes(w, out_w)[0][cols]
    assert table.shape == (jk.axis_classes(h, out_h)[1].shape[1],
                           jk.axis_classes(w, out_w)[1].shape[1],
                           jk.TABLE_ENTRY)
    got = table[torch.tensor(rc)][:, torch.tensor(cc)]
    want = _per_output_weights(h, w, out_h, out_w, rows, cols)
    assert torch.equal(got[..., :17], want)
    assert torch.equal(got[..., 17:], torch.zeros_like(got[..., 17:]))


def test_table_sizes_and_the_cap():
    """c3's table holds 4 entries (320 bytes), c3rot's 288 (23040); both
    take the table route.  1079 -> 2160 rows by 1917 -> 3840 columns, or
    by 67 -> 133, have no short period: their tables would pass the 4 MB
    cap, so they take the per-output route.  The cap is inclusive."""
    entry = jk.TABLE_ENTRY * 4
    assert jk.weight_table_bytes(*C3) == 4 * entry == 320
    assert jk.weight_table_bytes(*C3ROT) == 288 * entry == 23040
    assert jk.weight_route(*C3) == jk.weight_route(*C3ROT) == "table"
    for geom in ((1079, 1917, 2160, 3840), (1079, 67, 2160, 133)):
        assert jk.weight_table_bytes(*geom) > jk.TABLE_CAP
        assert jk.weight_route(*geom) == "per-output"
    # 1079 -> 2160 by 1920 -> 3840: 2160 x 2 entries, well under the cap
    assert jk.weight_table_bytes(1079, 1920, 2160, 3840) == 4320 * entry
    assert jk.weight_route(1079, 1920, 2160, 3840) == "table"
    # at the boundary: 2160 x 24 entries of 80 bytes is 4147200 bytes
    assert jk.TABLE_CAP == 4 << 20
    n = jk.TABLE_CAP // (2160 * entry)
    assert 2160 * n * entry <= jk.TABLE_CAP < 2160 * (n + 1) * entry


def test_k6_smem_at_c3_and_c3rot():
    """K6's window capacity at c3 (2x both axes) is 20 x 20 source pixels
    of a 32 x 32 tile, at c3rot 13 x 32 (1080 -> 3840 rows, 1920 -> 2160
    columns); the transposed store adds a 3 x 32 x 33 staging tile: 4800,
    17472 and 17664 bytes, room for many blocks an SM."""
    assert (jk._window(1080, 2160), jk._window(1920, 3840)) == (20, 20)
    assert (jk._window(1080, 3840), jk._window(1920, 2160)) == (13, 32)
    got = [jk.k6_smem_bytes(*geom, transpose)
           for geom, transpose in ((C3, False), (C3, True), (C3ROT, True))]
    assert got == [4 * 3 * 20 * 20, 4 * 3 * (20 * 20 + 32 * 33),
                   4 * 3 * (13 * 32 + 32 * 33)] == [4800, 17472, 17664]


def test_k6_cpu_call_builds_no_table():
    """On CPU tensors K6 runs its plain version: no table is built and no
    kernel launch is counted."""
    rng = np.random.default_rng(60)
    y = torch.from_numpy(rng.integers(16, 236, (1, 16, 24), dtype=np.uint8))
    u = torch.from_numpy(rng.integers(16, 241, (1, 16, 24), dtype=np.uint8))
    cmat = np.concatenate([np.eye(3, dtype=np.float32),
                           np.zeros((3, 1), np.float32)], 1)
    rk.reset_launches()
    before = jk._weight_table.cache_info().currsize
    out = jk.jinc2_convert_fused(y, u, u, None, None, cmat, 32, 48,
                                 1 / 255.0, 1 / 255.0)
    assert out.shape == (1, 3, 32, 48)
    assert rk.launches["jinc2_weight_table"] == 0
    assert rk.launches["jinc2_convert_fused"] == 0
    assert jk._weight_table.cache_info().currsize == before


def test_thread_mapping_covers_each_output_once():
    """A 32 x 32 tile's 256 threads, 4 adjacent outputs of one row each
    (tx = tid % 8, row = tid / 8), cover the tile once; the transposed
    store's threads (output row lc = tid / 8, pre-rotation rows 4 (tid % 8)
    .. + 3) cover it once too."""
    hits = np.zeros((32, 32), int)
    for tid in range(256):
        tx, lr = tid % 8, tid // 8
        hits[lr, 4 * tx:4 * tx + 4] += 1
    assert (hits == 1).all()
    hits[:] = 0
    for tid in range(256):
        lc, orow0 = tid // 8, 4 * (tid % 8)
        hits[orow0:orow0 + 4, lc] += 1
    assert (hits == 1).all()


def test_transposed_staging_is_free_of_bank_conflicts():
    """Pitch 33: a warp's staging writes (4 rows x 8 threads, word lr * 33
    + 4 tx + k) and its transposed reads (word (4 tq + k) * 33 + lc, 4
    values of lc x 8 of tq) each fall in 32 distinct banks."""
    for warp in range(8):
        for k in range(4):
            w_banks = {((tid // 8) * 33 + 4 * (tid % 8) + k) % 32
                       for tid in range(32 * warp, 32 * warp + 32)}
            r_banks = {((4 * (tid % 8) + k) * 33 + tid // 8) % 32
                       for tid in range(32 * warp, 32 * warp + 32)}
            assert len(w_banks) == len(r_banks) == 32


def test_table_entry_reads_align_to_16_bytes():
    """An entry is 20 floats: its 16 weights and its sum are five aligned
    16-byte reads, entry (r, c) starts at float (r * n_col_cls + c) * 20,
    and its sum at float 16 adds the weights in tap order."""
    assert jk.TABLE_ENTRY % 4 == 0 and jk.TABLE_ENTRY >= 17
    t = _table(*C3ROT)
    flat = t.reshape(-1)
    e = 5 * 9 + 3                       # row class 5, column class 3
    assert torch.equal(flat[e * jk.TABLE_ENTRY:e * jk.TABLE_ENTRY + 17],
                       t[5, 3, :17])
    acc = t[..., 0]
    for k in range(1, 16):
        acc = acc + t[..., k]
    assert torch.equal(t[..., 16], acc)
