"""arrow_tpu_torch.tools.probe_designs on the CPU: the other designs of the
redesigned probe kernels are made from the current sources (mosaic_probe.cu
and probe_r4.cu) by text substitution, so each substitution must find its
text exactly once; the wgmma wrapper that the tool writes for a tile width
must be the source's own at the source's width; each redesigned kernel has
its earlier source's path, its turns and, where PyTorch has one, a library
call (the mask matmul has none: its staging turn stands in); the column
cumsum's, the mask matmul's, the sublane gather's, the sized copy's, the
in-row sort's, the lane cumsum's and the lane gathers' held inputs show what
they must catch; ``--sass``'s counts are read right from cuobjdump's text.  The builds and times need the card
(``chip_smoke.py``'s ``probes`` phase)."""

import numpy as np
import pytest
import torch

from arrow_tpu_torch.tools import mosaic_probe as MP
from arrow_tpu_torch.tools import probe_designs as PD
from arrow_tpu_torch.tools import probe_r4 as PR


def test_wrapper_is_the_sources():
    assert PD.SOURCE.read_text().count(PD.wgmma_wrapper(PD.TILE)) == 1


# each switch's design: the source's lines and the design's in their place
TRANSPOSE_REGISTERS = (PD.TRANSPOSE_SHARED, "constexpr bool kTransposeShared = false;")
SWITCHES = {"quads": [TRANSPOSE_REGISTERS],
            "quads256": [TRANSPOSE_REGISTERS, (PD.TRANSPOSE_THREADS, "constexpr int kTransposeThreads = 256;")],
            "staged": [(PD.HBM_BULK, "constexpr bool kHbmBulk = true;")],
            "warp_rows": [(PD.HBM_THREADS, "constexpr int kHbmThreads = 32;")],
            "exchange": [(PD.STEP_SHUFFLE, "constexpr bool kStepShuffle = false;")],
            "cumsum_staged": [(PD.CUMSUM_STAGED, "constexpr bool kCumsumStaged = true;")],
            "cumsum_block": [(PD.CUMSUM_THREADS, "constexpr int kCumsumThreads = 128;")],
            "direct": [(PD.GATHER_DIRECT, "constexpr bool kGatherDirect = true;")],
            "count_first": [(PD.SIZED_COUNT_FIRST, "constexpr bool kSizedCountFirst = true;")],
            "eight_a_lane": [(PD.SORT_EIGHT_A_LANE, "constexpr bool kSortEightALane = true;")],
            "warp_blocks": [(PD.CUMSUM_LANES_GRID, "constexpr bool kCumsumLanesGrid = true;")],
            "row_staged": [(PD.GATHER_SHUFFLE, "constexpr bool kGatherShuffle = false;")]}
R4_DESIGNS = ("exchange", "mask_staging")  # the designs made from probe_r4.cu


@pytest.mark.parametrize("design", ["staging", "tile64", "tile128", "window", "bulk", "bulk_in", "one_block",
                                    *SWITCHES, "mask_staging"])
def test_design_sources(design):
    source = (PD.R4_SOURCE if design in R4_DESIGNS else PD.SOURCE).read_text()
    text = PD.design_sources()[design]
    assert text != source
    if design == "staging":
        assert PD.PRODUCT_CALL not in text and "wgmma_m64nNk32(d, " in text
    elif design == "mask_staging":  # only the product's call goes: the loads, compares and stores stay
        assert source.count(PD.MASK_PRODUCT_CALL) == 1
        assert text == source.replace(PD.MASK_PRODUCT_CALL, PD.MASK_STAGING_STANDIN)
        assert "void mask_product(" in text and "ldmatrix" in text and "__ldg(xb" in text
    elif design == "window":
        assert source.count(PD.SLICE_EVERY_ROW) == 1
        assert PD.SLICE_EVERY_ROW not in text and text.count("constexpr bool kSliceEveryRow = false;") == 1
    elif design == "bulk":
        assert source.count(PD.WRITE_BULK) == 1
        assert PD.WRITE_BULK not in text and text.count("constexpr bool kWriteBulk = true;") == 1
    elif design == "bulk_in":
        assert source.count(PD.OFFSET_BULK) == 1
        assert PD.OFFSET_BULK not in text and text.count("constexpr bool kOffsetBulk = true;") == 1
    elif design == "one_block":
        assert source.count(PD.SCALAR_ONE_BLOCK) == 1
        assert PD.SCALAR_ONE_BLOCK not in text and text.count("constexpr bool kScalarOneBlock = true;") == 1
    elif design in SWITCHES:
        want = source
        for line, changed in SWITCHES[design]:
            assert source.count(line) == 1 and line not in text and text.count(changed) == 1
            want = want.replace(line, changed)
        assert text == want
    else:
        n = int(design[4:])
        assert f"constexpr int kTileN = {n};" in text and f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8" in text
        assert f"%{n // 2 - 1}}}," in text and f'"+r"(d[{n // 2 - 1}])' in text and f'"+r"(d[{n // 2}])' not in text


@pytest.mark.parametrize("label", PD.REDESIGNED)
def test_redesigned_kernel_has_its_earlier_source_turns_and_library_call(label):
    """Each kernel's earlier design is its source (mosaic_probe.cu, or
    probe_r4.cu for the merge steps and the mask matmul) at the commit
    before its redesign, under build/parent/<commit>/, a library of its own;
    every design it is timed against is one that the tool builds; and its
    library call gives its function on the probe's inputs (the merge steps
    and the mask matmul have none; the mask matmul's staging stands in)."""
    source = "probe_r4.cu" if label in PR.BY_NAME else "mosaic_probe.cu"
    assert PD.source_of(label).name == source and PD.source_of(label).is_file()
    path = PD.earlier_source(label)
    assert path.relative_to(PD.PARENT).parts == (PD.BEFORE[label], "arrow_tpu_torch", "csrc", source)
    assert PD.library_name(label, "earlier") == f"earlier_{PD.BEFORE[label]}_{source[:-3]}"
    built = set(PD.design_sources()) | {PD.library_name(label, "earlier")}
    assert PD.TURNS[label][0] == "earlier" and {PD.library_name(label, d) for d in PD.TURNS[label]} <= built
    probe = PD.probe_of(label)
    args = MP.inputs_on(probe, "cpu")
    if label in PR.MERGE_STEPS:
        assert MP.library_call(label, args) is None and probe.blocked
        return
    if label == "i1_to_bf16_astype":
        assert MP.library_call(label, args) is None and "mask_staging" in PD.TURNS[label]
        return
    got = MP.library_call(label, args)()
    assert torch.equal(got, MP.plain(probe, *args))


def test_every_kernel_of_the_tools_is_redesigned_once():
    """The table names eighteen redesigned kernels in 22 labels (the merge
    step's two forms are one kernel, and so are the lane gather's four
    probes), each with an earlier design, and no kernel is left timed
    against its library call alone; the column cumsum and the mask matmul
    were redesigned together, and so were the sublane gather and the sized
    copy, the row store and the in-row sort, and the lane cumsum and the
    lane gather."""
    assert len(PD.REDESIGNED) == 22 and len(set(PD.REDESIGNED)) == 22
    assert set(PD.TURNS) == set(PD.REDESIGNED) and not hasattr(PD, "UNCHANGED")
    assert {PD.BEFORE[name] for name in PR.MERGE_STEPS} == {PD.BEFORE["bitcast_f32_u32"]}
    assert PD.BEFORE["cumsum_sublanes_f32"] == PD.BEFORE["i1_to_bf16_astype"] == "9e5ff2a"
    assert PD.BEFORE["gather_sublanes_taa_axis0"] == PD.BEFORE["dma_dynamic_size_rows"] == "81001b6"
    assert PD.TURNS["gather_sublanes_taa_axis0"] == ("earlier", "direct")
    assert PD.TURNS["dma_dynamic_size_rows"] == ("earlier", "count_first")
    assert PD.BEFORE["dynamic_store_vmem_rows"] == PD.BEFORE["lax_sort_in_kernel"] == "dfc6a14"
    assert PD.TURNS["dynamic_store_vmem_rows"] == ("earlier",)
    assert PD.TURNS["lax_sort_in_kernel"] == ("earlier", "eight_a_lane")
    lane = ("cumsum_lanes_i32", *PD.GATHER_LANES)
    assert {PD.BEFORE[label] for label in lane} == {"a5e35e7"} and len(lane) == 5
    assert set(PD.GATHER_LANES) == {p.label for p in MP.PROBES if p.label.startswith("gather_lanes")}
    assert PD.TURNS["cumsum_lanes_i32"] == ("earlier", "warp_blocks")
    assert {PD.TURNS[label] for label in PD.GATHER_LANES} == {("earlier", "row_staged")}


def test_held_inputs_cover_every_window_row():
    """A row window's designs (the row store's too) are held at the probe's
    own s and at every legal s in [0, 56] on one set of full-range random
    rows."""
    assert set(PD.WINDOWED) == {"dynamic_slice_vmem_rows", "dma_unaligned_row_write", "dma_unaligned_row_offset",
                                "dynamic_store_vmem_rows"}
    for label in PD.WINDOWED:
        cases = list(PD.held_inputs(MP.BY_LABEL[label], "cpu"))
        assert [int(s) for s, _ in cases[1:]] == list(range(57))
        rows = cases[1][1]
        assert all(r is rows for _, r in cases[1:]) and rows.min() < -2 ** 30 and rows.max() > 2 ** 30
        assert [tuple(a.shape) for a in cases[0]] == [tuple(a.shape) for a in cases[1]]


def test_held_inputs_wrap_the_scalar_add():
    """The scalar add's designs are held at the probe's own inputs and on
    full-range rows with a scalar near either end of the int32 range, where
    the sum wraps both ways."""
    for label in PD.WRAPPED:
        probe = MP.BY_LABEL[label]
        cases = list(PD.held_inputs(probe, "cpu"))
        assert [int(s) for s, _ in cases[1:]] == [2 ** 31 - 3, -2 ** 31 + 3]
        for s, rows in cases[1:]:
            exact = rows.long() + int(s)
            assert ((exact > 2 ** 31 - 1) | (exact < -2 ** 31)).any()
            assert torch.equal(MP.plain(probe, s, rows).long(), (exact + 2 ** 31) % 2 ** 32 - 2 ** 31)


def test_held_inputs_hold_the_transpose_and_the_copy_on_full_range_tiles():
    """The transpose, the HBM-to-HBM copy and the bitcast are held at the
    probe's own tile (an arange, whose values never set the high bits, or
    ones) and on a full-range random tile, where a misplaced word or a wrong
    select shows; their plain versions are a.T, src[8:16] and the float
    tile's bits (NaN payloads and subnormals among them)."""
    for label in PD.FULL_RANGE:
        probe = MP.BY_LABEL[label]
        cases = list(PD.held_inputs(probe, "cpu"))
        assert len(cases) == 2 and [(tuple(a.shape), a.dtype) for a in cases[0]] == [
            (tuple(a.shape), a.dtype) for a in cases[1]]
        tile = cases[1][0].view(torch.int32)
        assert tile.min() < -2 ** 30 and tile.max() > 2 ** 30
        assert (tile < 0).any() and len(torch.unique(tile)) > tile.numel() * 0.99
        for (a,) in cases:
            want = {"transpose_32b_128x128": lambda: a.T, "hbm_to_hbm_dma": lambda: a[8:16]}.get(
                label, lambda: a.view(torch.int32))()
            got = MP.plain(probe, a)
            assert got.is_contiguous() and torch.equal(got, want)
    (floats,) = list(PD.held_inputs(MP.BY_LABEL["bitcast_f32_u32"], "cpu"))[1]
    assert floats.dtype == torch.float32 and floats.isnan().any()
    assert ((floats.view(torch.int32) & 0x7F800000) == 0).any()  # subnormals


def test_held_inputs_hold_the_merge_steps_on_ties_full_range_and_ends():
    """A merge step's designs are held at the probe's inputs (R = 3) and on
    three (A, B) pairs, each at R = 0, 1 and 5: keys in [0, 100) with many
    ties within and across A and B, full-range keys, and all INT_MIN
    against all INT_MAX."""
    pairs = PD.step_pairs("cpu")
    assert list(pairs) == ["ties", "full range", "ends"]
    ties, full, ends = pairs.values()
    assert ties.min() == 0 and ties.max() == 99 and len(torch.unique(ties)) == 100
    assert full.min() < -2 ** 30 and full.max() > 2 ** 30 and len(torch.unique(full)) > full.numel() * 0.99
    assert (ends[0] == -2 ** 31).all() and (ends[1] == 2 ** 31 - 1).all()
    for name in PR.MERGE_STEPS:
        probe = PR.BY_NAME[name]
        cases = list(PD.held_inputs(probe, "cpu"))
        assert len(cases) == 1 + 3 * len(PD.STEP_HELD_R) and PD.STEP_HELD_R == (0, 1, 5)
        for i, pair in enumerate(pairs.values()):
            for j, r in enumerate(PD.STEP_HELD_R):
                got_r, a, b = cases[1 + i * len(PD.STEP_HELD_R) + j]
                assert int(got_r) == r and torch.equal(a, pair[0]) and torch.equal(b, pair[1])
                assert a.is_contiguous() and b.is_contiguous()
        zero = MP.plain(probe, *cases[1])
        assert int(cases[1][0]) == 0 and not zero.any()


def _pairwise_scan(x):
    """Inclusive running sum down the rows in log2(rows) rounds (each row
    adds the one d above it): the adds of a tree scan, in another order."""
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], x[d:] + x[:-d]])
        d *= 2
    return x


def test_ordered_tile_catches_a_reordered_scan():
    """The column cumsum's card tests hold it bit for bit to the plain
    version's row order on ``ordered_tile``: there a tree order and a
    float64 accumulator both give other float32 bits in most columns' finite
    rows, so a kernel that reordered its adds or widened its sum would
    fail.  Each column mixes +-1e8 with values near 1 and holds +inf, -inf
    and NaN."""
    tile = PD.ordered_tile()
    finite = tile[:48]
    assert np.isfinite(finite).all() and (np.abs(finite) == 1e8).any(0).all()
    assert (np.abs(finite - 1) < 0.01).any(0).all()
    for c in range(tile.shape[1]):
        assert {np.inf, -np.inf} <= set(tile[48:, c].tolist()) and np.isnan(tile[48:, c]).sum() == 1
    x = torch.from_numpy(tile)
    want = MP._scan(x, 0)
    assert PD.same_bits(MP.plain(MP.BY_LABEL["cumsum_sublanes_f32"], x), want)
    assert want[-1].isnan().all() and PD.same_bits(want, MP._scan(x.clone(), 0))
    for other in (_pairwise_scan(x), torch.cumsum(x.double(), 0).float()):
        assert not PD.same_bits(other, want)
        moved = (other[:48].view(torch.int32) != want[:48].view(torch.int32)).any(0)
        assert moved.sum() > 100, int(moved.sum())


def test_count_tiles_cover_every_row_count():
    """The mask matmul is held on two tiles whose rows have every count of
    positive entries from 0 to 128, with 0, -1, INT_MIN, 1 and INT_MAX among
    the entries; its plain version gives each row's count in every column."""
    tiles = PD.count_tiles()
    counts = [(t > 0).sum(1) for t in tiles]
    assert sorted(counts[0].tolist()) == list(range(128)) and sorted(counts[1].tolist()) == list(range(1, 129))
    for t in tiles:
        assert t.dtype == np.int32 and t.shape == (128, 128)
        assert {0, -1, -2 ** 31, 1, 2 ** 31 - 1} <= set(np.unique(t).tolist())
        got = MP.plain(PR.BY_NAME["i1_to_bf16_astype"], torch.from_numpy(t))
        want = torch.from_numpy((t > 0).sum(1)).float()[:, None].expand(128, 128).to(torch.bfloat16)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("label", ["cumsum_sublanes_f32", "i1_to_bf16_astype"])
def test_held_inputs_hold_the_cumsum_and_the_mask_matmul(label):
    """The column cumsum's designs are held at the probe's ones, on
    ``ordered_tile`` and on normals; the mask matmul's at the probe's ones
    and on both of ``count_tiles``; every design bit for bit
    (``same_bits``: NaNs and signed zeros count)."""
    probe = PD.probe_of(label)
    cases = [a for (a,) in PD.held_inputs(probe, "cpu")]
    extra = [PD.ordered_tile()] if label == "cumsum_sublanes_f32" else PD.count_tiles()
    assert len(cases) == 1 + len(extra) + (label == "cumsum_sublanes_f32")
    assert torch.equal(cases[0], MP.inputs_on(probe, "cpu")[0])
    for got, want in zip(cases[1:], extra):
        assert np.array_equal(got.numpy(), want, equal_nan=True)
    assert all(c.shape == cases[0].shape and c.dtype == cases[0].dtype for c in cases)
    if label == "cumsum_sublanes_f32":
        assert cases[-1].abs().max() < 10 and cases[-1].std() > 0.5  # the normals
    nan = torch.tensor([float("nan"), -0.0])
    assert PD.same_bits(nan, nan.clone()) and not PD.same_bits(nan, torch.tensor([float("nan"), 0.0]))


def _slips(x, idx):
    """The sublane gather with its row slipped by one, or its column by one
    or by a 16-byte word: what a wrong stripe or word would give."""
    cols = torch.arange(x.shape[1])[None]
    return {"row + 1": x[(idx.long() + 1) % 64, cols], "column + 1": x[idx.long(), (cols + 1) % x.shape[1]],
            "column - 4": x[idx.long(), (cols - 4) % x.shape[1]]}


def test_held_inputs_hold_the_sublane_gather_on_four_index_tiles():
    """The sublane gather's designs are held at the probe's inputs and on
    one full-range random tile with idx all 0, all 63, the identity and
    random; its plain version is x[idx[r, c], c] (the JAX probe's
    take_along_axis), the identity gives x, and on each of the four a
    slipped row or column gives another output."""
    probe = MP.BY_LABEL["gather_sublanes_taa_axis0"]
    cases = list(PD.held_inputs(probe, "cpu"))
    tiles = PD.gather_indices()
    assert list(tiles) == ["zeros", "last", "identity", "random"] and len(cases) == 5
    assert [tuple(a.shape) for a in cases[0]] == [tuple(a.shape) for a in cases[1]]
    x = cases[1][0]
    assert all(c[0] is x for c in cases[1:]) and x.min() < -2 ** 30 and x.max() > 2 ** 30
    assert len(torch.unique(x)) > x.numel() * 0.99
    for (got_x, idx), (name, want_idx) in zip(cases[1:], tiles.items()):
        assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), want_idx)
        assert idx.min() >= 0 and idx.max() < 64
        got = MP.plain(probe, got_x, idx)
        assert torch.equal(got, torch.from_numpy(np.take_along_axis(x.numpy(), want_idx, 0)))
        assert torch.equal(got, x) == (name == "identity")
        for slip, other in _slips(x, idx).items():
            assert not torch.equal(other, got), (name, slip)
    assert len(np.unique(tiles["random"])) == 64
    assert (tiles["identity"] == np.arange(64)[:, None]).all()


def test_held_inputs_hold_the_sized_copy_at_every_count():
    """The sized copy's designs are held at the probe's s = 8 and at every s
    from -1 to 65 on one set of full-range random rows: its plain version
    keeps the first s rows, clamped to [0, 64], and zeros the rest, as the
    JAX probe's oracle does."""
    probe = MP.BY_LABEL["dma_dynamic_size_rows"]
    cases = list(PD.held_inputs(probe, "cpu"))
    assert [int(s) for s, _ in cases[1:]] == list(range(-1, 66)) == list(PD.SIZED_HELD)
    rows = cases[1][1]
    assert all(r is rows for _, r in cases[1:]) and rows.min() < -2 ** 30 and rows.max() > 2 ** 30
    assert not (rows == 0).any()  # a zero row of the output is the kernel's
    for s, src in cases:
        got = MP.plain(probe, s, src)
        kept = min(max(int(s), 0), 64)
        assert torch.equal(got[:kept], src[:kept]) and not got[kept:].any()
        np.testing.assert_array_equal(got.numpy(), probe.oracle(s.numpy(), src.numpy()))


def _bitonic(a, flip=None, lane=5, per=4):
    """bitonic_rows' network, with the compare direction (keep_min) of the
    pairs that elements per lane..per lane + per - 1 take part in flipped
    at the stage flip = (k, d): a lane of the kernel that compares the
    wrong way at one stage."""
    c = torch.arange(a.shape[1])
    for k in (2 ** i for i in range(1, 8)):
        for d in (k >> i for i in range(1, k.bit_length())):
            keep_min = ((c & d) == 0) == ((c & k) == 0)
            if (k, d) == flip:
                keep_min ^= (c // per == lane) | ((c ^ d) // per == lane)
            p = a[:, c ^ d]
            a = torch.where(keep_min, torch.minimum(a, p), torch.maximum(a, p))
    return a


STAGES = [(2 ** i, 2 ** j) for i in range(1, 8) for j in range(i - 1, -1, -1)]  # the network's 28 stages, in order


def test_sort_tiles_are_the_six_tiles():
    """The in-row sort is held at the probe's tile and on six (8, 128) int32
    tiles: full-range random values with INT_MIN and INT_MAX in every row,
    all equal, rows ascending, rows descending, rows of 4 distinct values,
    rows that rise then fall; its plain version (bitonic_rows, 28 stages)
    sorts each as np.sort does."""
    tiles = PD.sort_tiles()
    assert list(tiles) == ["full range", "equal", "ascending", "descending", "four values", "bitonic"]
    probe = MP.BY_LABEL["lax_sort_in_kernel"]
    cases = [a for (a,) in PD.held_inputs(probe, "cpu")]
    assert len(cases) == 7 and torch.equal(cases[0], MP.inputs_on(probe, "cpu")[0])
    for (name, tile), got in zip(tiles.items(), cases[1:]):
        assert tile.dtype == np.int32 and tile.shape == (8, 128) and np.array_equal(got.numpy(), tile)
        assert torch.equal(MP.plain(probe, got), torch.from_numpy(np.sort(tile, 1))), name
    full, four = tiles["full range"], tiles["four values"]
    assert ((full == -2 ** 31).any(1) & (full == 2 ** 31 - 1).any(1)).all()
    assert len(np.unique(full)) > full.size * 0.98 and len(np.unique(tiles["equal"])) == 1
    assert (np.diff(tiles["ascending"].astype(np.int64), axis=1) >= 0).all()
    assert np.array_equal(tiles["descending"], tiles["ascending"][:, ::-1])
    assert set(np.unique(four).tolist()) == {-2 ** 31, -1, 0, 2 ** 31 - 1}
    for row in tiles["bitonic"].astype(np.int64):
        turn = int(np.argmax(row))
        assert 0 < turn < 127 and (np.diff(row[:turn + 1]) >= 0).all() and (np.diff(row[turn:]) <= 0).all()
    assert len(STAGES) == 28 and torch.equal(_bitonic(torch.from_numpy(full)), MP.bitonic_rows(torch.from_numpy(full)))


@pytest.mark.parametrize("stage", STAGES[1:], ids=[f"k{k}d{d}" for k, d in STAGES[1:]])
def test_sort_tiles_catch_a_lane_that_compares_the_wrong_way(stage):
    """At every stage after the first, a network whose lane of 4 elements
    compares the wrong way gives a wrong row on at least one of the sort
    tiles.  (At the first stage, k = d = 1's pairs facing the other way
    leave every 4 elements bitonic, so the network still sorts: no input can
    show it.)  At the last merge's stages, a whole stage that compares the
    wrong way misses on every tile but the equal one."""
    tiles = {name: torch.from_numpy(t) for name, t in PD.sort_tiles().items()}
    want = {name: torch.sort(t, 1).values for name, t in tiles.items()}
    assert all(torch.equal(_bitonic(t, STAGES[0]), want[name]) for name, t in tiles.items())
    assert any(not torch.equal(_bitonic(t, stage), want[name]) for name, t in tiles.items())
    k, d = stage
    if k == 128:
        whole = [name for name, t in tiles.items() if not torch.equal(_bitonic(t, stage, lane=0, per=128), want[name])]
        assert whole == ["full range", "ascending", "descending", "four values", "bitonic"]


def _lane_scan(a, lost=None, skipped=None):
    """The lane cumsum as its kernel makes it: each lane's 4 running sums
    plus the sum of the lanes before it, wrapping in int32; `lost`: a lane
    whose carry is dropped (it gets no sum of the lanes before it),
    `skipped`: a lane whose total is left out of the carries of the lanes
    after it."""
    own = a.long().view(a.shape[0], 32, 4).cumsum(2)
    totals = own[..., 3].clone()
    if skipped is not None:
        totals[:, skipped] = 0
    before = totals.cumsum(1) - totals
    if lost is not None:
        before[:, lost] = 0
    out = (own + before[..., None]).view(a.shape)
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def test_held_inputs_hold_the_lane_cumsum_where_it_wraps_and_at_every_column():
    """The lane cumsum is held at the probe's ones, on a full-range random
    tile, where the int32 sum wraps, and on 16 one-hot tiles (tile t, row r:
    a 1 at column 8t + r) that together put a 1 at every column; its plain
    version is np.cumsum in int32 on each, and so is the kernel's scan (4
    sums a lane, then the lanes before it)."""
    probe = MP.BY_LABEL["cumsum_lanes_i32"]
    cases = [a for (a,) in PD.held_inputs(probe, "cpu")]
    tiles = PD.one_hot_tiles()
    assert len(tiles) == 16 and len(cases) == 2 + len(tiles)
    assert torch.equal(cases[0], MP.inputs_on(probe, "cpu")[0])
    full = cases[1]
    assert full.min() < -2 ** 30 and full.max() > 2 ** 30
    exact = full.long().cumsum(1)
    assert ((exact > 2 ** 31 - 1) | (exact < -2 ** 31)).any()
    for t, (tile, got) in enumerate(zip(tiles, cases[2:])):
        assert tile.dtype == np.int32 and tile.shape == (8, 128) and np.array_equal(got.numpy(), tile)
        assert (tile.sum(1) == 1).all() and (np.argmax(tile, 1) == 8 * t + np.arange(8)).all()
    assert sorted(np.argmax(np.stack(tiles), 2).ravel().tolist()) == list(range(128))
    for a in cases:
        want = torch.from_numpy(np.cumsum(a.numpy(), 1, dtype=np.int32))
        assert torch.equal(MP.plain(probe, a), want) and torch.equal(_lane_scan(a), want)


@pytest.mark.parametrize("lane", range(1, 32))
def test_one_hot_tiles_catch_a_carry_lost_at_any_lane_boundary(lane):
    """At the boundary between lane - 1 and lane (columns 4 lane - 1 and
    4 lane), a scan that drops the carry into the lane, or that leaves lane -
    1's total out of the lanes after it, gives a wrong row on one of the
    one-hot tiles: the one whose 1 lies before the boundary, in the lane
    just before it."""
    tiles = [torch.from_numpy(t) for t in PD.one_hot_tiles()]
    for fault in ({"lost": lane}, {"skipped": lane - 1}):
        wrong = [t for t, a in enumerate(tiles) if not torch.equal(_lane_scan(a, **fault), _lane_scan(a))]
        assert wrong, fault
        rows = [(t, r) for t in wrong for r in range(8) if 4 * (lane - 1) <= 8 * t + r < 4 * lane]
        assert rows, (fault, wrong)


@pytest.mark.parametrize("label", PD.GATHER_LANES)
def test_held_inputs_hold_the_lane_gathers_on_every_index_set(label):
    """A lane gather is held at the probe's inputs and on one full-range x
    (for gather_lanes_f32 its bits as float32, with -0 and a signalling NaN
    in every row) with idx all 0, all W - 1, the identity, the reversal, at
    W = 256 the upper half alone, and random; its plain version is
    x[r, idx[r, c]] (the JAX probe's take_along_axis) bit for bit, and on
    each set a slipped lane or row gives another output."""
    probe = MP.BY_LABEL[label]
    x_host, idx_host = probe.inputs()
    width = x_host.shape[1]
    sets = PD.lane_indices(len(idx_host), width)
    assert list(sets) == ["zeros", "last", "identity", "reversal", *(["upper half"] if width > 128 else []), "random"]
    cases = list(PD.held_inputs(probe, "cpu"))
    assert len(cases) == 1 + len(sets)
    x = cases[1][0]
    assert all(c[0] is x for c in cases[1:]) and x.dtype == torch.from_numpy(x_host).dtype
    bits = x.view(torch.int32)
    assert bits.shape == x_host.shape and bits.min() < -2 ** 30 and bits.max() > 2 ** 30
    if x.dtype == torch.float32:
        rows = torch.arange(len(x))
        assert (bits[rows, rows] == -2 ** 31).all() and (bits[rows, width - 1 - rows] == 0x7F800001).all()
        assert x.isnan().any()
    rows = torch.arange(len(idx_host))[:, None]
    for (got_x, idx), (name, want) in zip(cases[1:], sets.items()):
        assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), want)
        assert idx.min() >= 0 and idx.max() < width
        got = MP.plain(probe, got_x, idx)
        assert PD.same_bits(got, torch.from_numpy(np.take_along_axis(x.numpy(), want, 1)))
        assert PD.same_bits(got, x[:, :128]) == (name == "identity")
        for slip, other in {"lane + 1": x[rows, (idx.long() + 1) % width],
                            "row + 1": x[(rows + 1) % len(x), idx.long()]}.items():
            assert not PD.same_bits(other, got), (name, slip)


def test_lane_indices_reach_both_halves_of_the_256_wide_row():
    """The 256-wide gather's index sets take every column of the row, the
    identity only the lower half and the reversal and the upper-half set only
    the upper; a gather that read one half alone (the index's top bit lost,
    or set) misses on those that reach the other."""
    probe = MP.BY_LABEL["gather_lanes_256wide_2gathers"]
    sets = PD.lane_indices(8, 256)
    assert set(np.concatenate([v.ravel() for v in sets.values()]).tolist()) == set(range(256))
    assert sets["identity"].max() < 128 <= min(sets["reversal"].min(), sets["upper half"].min())
    assert (sets["random"] < 128).any() and (sets["random"] >= 128).any()
    cases = list(PD.held_inputs(probe, "cpu"))[1:]
    rows = torch.arange(8)[:, None]
    for half, cols in {"lower": lambda i: i % 128, "upper": lambda i: i % 128 + 128}.items():
        missed = [name for name, (x, idx) in zip(sets, cases)
                  if not torch.equal(x[rows, cols(idx.long())], MP.plain(probe, x, idx))]
        assert missed == {"lower": ["last", "reversal", "upper half", "random"],
                          "upper": ["zeros", "identity", "random"]}[half]


# cuobjdump -sass's layout, cut down: a kernel to count, then one that is not
SASS_TEXT = """
        Function : _ZN12_GLOBAL__N_113gather_stripeEPK4int4S2_PS0_
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;   /* 0x000000040204798b */
        /*0020*/                   LDG.E.128.CONSTANT R8, desc[UR4][R6.64] ;   /* 0x000000040608798b */
        /*0030*/                   STS.128 [R0], R4 ;                           /* 0x0000000400007388 */
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;                /* 0x0000000000007b1d */
        /*0050*/              @!P0 LDS R12, [R13] ;                             /* 0x000000000d0c8984 */
        /*0060*/                   LDG.E R14, desc[UR4][R2.64] ;               /* 0x000000040203e981 */
        /*0070*/                   FADD R15, R14, R12 ;                         /* 0x0000000c0e0f7221 */
        /*0080*/                   LDG.E R16, desc[UR4][R2.64+0x4] ;           /* 0x000000040210e981 */
        /*0090*/                   STG.E.128 desc[UR4][R2.64], R4 ;            /* 0x000000040200e986 */
        /*00a0*/                   EXIT ;                                       /* 0x000000000000794d */
        Function : _ZN12_GLOBAL__N_110roll_lanesEPKiS1_iPii
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;                /* 0x000000040204e981 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;                /* 0x0000000000007b1d */
"""


def test_count_sass_counts_ops_and_the_loads_behind_a_barrier_or_an_add():
    """--sass's counts from cuobjdump's text: opcodes with any suffix (a
    predicated one too), every instruction, the LDGs after the first FADD or
    HMMA ("late LDG"), after the first BAR.SYNC and after the first SHFL,
    STS or STG, only for kernels named in SASS_KERNELS (the sublane
    gather's, the sized copy's, the in-row sort's, the row store's, the lane
    cumsum's and the lane gather's, earlier and new, among them; not the
    rolls')."""
    assert {"gather_stripe", "gather_direct", "gather_sublanes", "copy_rows_sized", "sort_rows", "write_rows",
            "store_rows", "cumsum_lanes", "gather_lanes"} <= set(PD.SASS_KERNELS)
    assert not any(k in "roll_lanes" for k in PD.SASS_KERNELS)
    counts = PD.count_sass(SASS_TEXT)
    assert list(counts) == ["_ZN12_GLOBAL__N_113gather_stripeEPK4int4S2_PS0_"]
    (got,) = counts.values()
    assert {k: got[k] for k in ("LDG", "STS", "BAR.SYNC", "LDS", "FADD", "STG", "HMMA")} == {
        "LDG": 4, "STS": 1, "BAR.SYNC": 1, "LDS": 1, "FADD": 1, "STG": 1, "HMMA": 0}
    assert got["all"] == 11 and got["late LDG"] == 1 and got["LDG after BAR.SYNC"] == 2
    assert got["LDG after SHFL, STS or STG"] == 2
