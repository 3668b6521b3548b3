"""``chip_smoke.composite_bound_ms``, the least time K5's and K6's function
takes on the card, against the count its comment writes out, on a
hand-built band of two tiles.  CPU only: the bound is arithmetic on the
band's counts."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Two tiles at block_m 64: one walks 100 of its candidates in 2 blocks, the
# other 30 in 1, so the band walks 130 candidates, 3 blocks, and 1,000
# pairs with a != 0.  A walked candidate costs a tile 256 * 15 (each
# pair's instructions) + 16 * 4 (each column's) + 16 * 3 (each row's) + 1
# (2 cb) = 3953 instructions; a pair with a != 0 costs 5 more in K5, 50
# in K6.  Bytes: 36 (K5) or 72 (K6) a walked candidate, 16 a pixel of a
# tile, 4 a pixel of a composited block, 8 (K5) or 16 (K6) a tile.
COUNTS, N_DONE, BM, NONZERO = [100, 30], [2, 1], 64, 1000
CASES = {"K5": (130 * 3953 + 1000 * 5, 130 * 36 + 2 * 4096 + 3 * 1024 + 2 * 8),
         "K6": (130 * 3953 + 1000 * 50, 130 * 72 + 2 * 4096 + 3 * 1024 + 2 * 16)}


@pytest.mark.parametrize("kernel", list(CASES))
def test_composite_bound_counts_row_and_column_terms_once(chip_smoke, kernel):
    ops, nbytes = CASES[kernel]
    ms, by, pairs = chip_smoke.composite_bound_ms(
        kernel, torch.tensor(COUNTS, dtype=torch.int32),
        torch.tensor(N_DONE, dtype=torch.int32), BM, NONZERO)
    assert pairs == 130 * 256
    # 33.5e12 FP32 instructions/s and 3.35e12 B/s: the operations bound it
    assert by == "operations" and ops / 33.5e12 > nbytes / 3.35e12
    assert ms == pytest.approx(ops / 33.5e12 * 1e3, rel=1e-12)


@pytest.mark.parametrize("kernel,tile_bytes", [("K5", 8), ("K6", 16)])
def test_composite_bound_by_bytes_where_few_candidates_are_walked(chip_smoke, kernel,
                                                                 tile_bytes):
    """A band of two empty tiles walks nothing: its bytes (the per-pixel
    outputs and the tiles' entries) bound it."""
    ms, by, pairs = chip_smoke.composite_bound_ms(
        kernel, torch.tensor([0, 0], dtype=torch.int32),
        torch.tensor([0, 0], dtype=torch.int32), BM, 0)
    assert (by, pairs) == ("bytes", 0)
    assert ms == pytest.approx((2 * 4096 + 2 * tile_bytes) / 3.35e12 * 1e3, rel=1e-12)


def test_composite_bound_counts_only_the_blocks_a_tile_composited(chip_smoke):
    """A tile of 200 candidates that exited after its first block walked
    64 of them: the bound charges those, not the 200."""
    ms, by, pairs = chip_smoke.composite_bound_ms(
        "K5", torch.tensor([200], dtype=torch.int32), torch.tensor([1], dtype=torch.int32),
        BM, 0)
    assert (by, pairs) == ("operations", 64 * 256)
    assert ms == pytest.approx(64 * 3953 / 33.5e12 * 1e3, rel=1e-12)
