"""Kernels 1 and 2's schedules (csrc/grid_positions.cu) against their plain
versions (CPU).

``ops/grid_positions.strided_stats_model`` and ``word_positions_model``
model in torch the order in which each kernel's lanes and registers combine
a row (kernel 1: the strided layout's rotate-and-select levels, its register
levels and the tree of e*e; kernel 2: each word's running max, the lane
scan of the word maxima and the carry across words). Each must equal the plain version, bitwise, at every width the
kernels take. The plain versions are held to the JAX reference in
tests/test_torch_resample.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from modppl_tpu_torch.ops import grid_positions as gp
from _torch_threads import one_thread  # noqa: F401

CSRC = Path(gp.__file__).resolve().parents[1] / "csrc"
WIDTHS = [1, 2, 8, 32, 64, 1024]
ROWS = 64
TINY = np.finfo(np.float32).tiny


def _lw(kind, nb, bw, seed):
    """Log-weights (nb, bw) float32: uniform-ish, concentrated (scale 30),
    degenerate (one finite weight), "subnormal" (e = exp(lw - max) mostly
    below the smallest normal float32, some flushed to 0), "neginf" (half
    the entries -inf), "first" (only the first weight finite)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        lw = rng.standard_normal((nb, bw)) * 0.7
    elif kind == "concentrated":
        lw = rng.standard_normal((nb, bw)) * 30.0
    elif kind == "subnormal":
        lw = rng.uniform(-106.0, -86.0, (nb, bw))
        lw.flat[rng.integers(nb * bw)] = 0.0
    elif kind == "neginf":
        lw = rng.standard_normal((nb, bw))
        lw[rng.random((nb, bw)) < 0.5] = -np.inf
        lw.flat[rng.integers(nb * bw)] = 0.0
    else:
        lw = np.full((nb, bw), -np.inf)
        lw.flat[0 if kind == "first" else rng.integers(nb * bw)] = 0.0
    return torch.from_numpy(lw.astype(np.float32))


def _positions_inputs(kind, bw, seed):
    """cum, offs, total as the filter computes them from the plain scan;
    "zeros" is cum all 0 over a total of 1, whose S is all 0; "shuffled"
    permutes each row of uniform weights' cum (the filter's S never falls
    within a row, so only such rows make the cummax do work)."""
    if kind == "zeros":
        return (torch.zeros(ROWS, bw), torch.zeros(ROWS), torch.tensor(1.0))
    lw = _lw("uniform" if kind == "shuffled" else kind, ROWS, bw, seed)
    cum, totals, _ = gp.stats_cumsum_plain(lw, lw.max())
    offs_incl = gp.doubling_cumsum(totals[None, :])[0]
    offs = torch.cat([totals.new_zeros(1), offs_incl[:-1]])
    if kind == "shuffled":
        rng = np.random.default_rng(seed)
        cum = torch.stack([r[torch.from_numpy(rng.permutation(bw))]
                           for r in cum])
    return cum, offs, offs_incl[-1]


@pytest.mark.parametrize("kind", ["uniform", "concentrated", "degenerate",
                                  "subnormal", "neginf"])
@pytest.mark.parametrize("bw", WIDTHS)
def test_stats_model_bitwise(bw, kind):
    """Kernel 1's schedule gives the plain version's cum, totals and
    sq_totals, bitwise, and its cum is doubling_cumsum of e; the tree of
    e*e gives every lane of a row the same total."""
    lw = _lw(kind, ROWS, bw, bw)
    m = lw.max()
    e = torch.exp(lw - m)
    if kind == "subnormal":
        assert bool(((e > 0) & (e < TINY)).any()) and bool((e == 0).any())
    got = gp.strided_stats_model(lw, m)
    want = gp.stats_cumsum_plain(lw, m)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
    assert torch.equal(got[0], gp.doubling_cumsum(e))
    assert torch.equal(got[2], gp.doubling_cumsum(e * e)[:, -1])


@pytest.mark.parametrize("kind", ["uniform", "concentrated", "degenerate",
                                  "subnormal", "neginf", "first", "zeros",
                                  "shuffled"])
@pytest.mark.parametrize("bw", WIDTHS)
def test_positions_model_bitwise(bw, kind):
    """Kernel 2's schedule gives the plain version's in-row cummax and row
    maxima, bitwise; "first" (all the weight on particle 0) gives S all N,
    "zeros" S all 0, and "shuffled" rows whose S falls."""
    n = ROWS * bw
    cum, offs, total = _positions_inputs(kind, bw, bw + 1)
    u = torch.tensor(0.37, dtype=torch.float32)
    got = gp.word_positions_model(cum, offs, total, u, n)
    want = gp.positions_cummax_plain(cum, offs, total, u, n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a, b)
    if kind in ("first", "zeros"):
        assert bool((got[0] == (n if kind == "first" else 0)).all())


@pytest.mark.parametrize("bw", WIDTHS)
def test_grid_layout_matches_csrc(bw):
    """The launch of the CPU models is the one csrc/grid_positions.cu
    compiles in (its two #define lines): a row is min(bw, 32) lanes of
    bw / lanes registers, a CTA's rows are whole warps, and the CTAs cover
    the rows with less than one CTA to spare. The kernels keep no shared
    memory and no barrier."""
    src = (CSRC / "grid_positions.cu").read_text()
    assert f"#define MODPPL_GRID_WARPS {gp.GRID_WARPS}\n" in src
    assert f"#define MODPPL_GRID_LANES {gp.GRID_LANES}\n" in src
    assert "__shared__" not in src and "__syncthreads" not in src
    for nb in (1, 37, ROWS, 1024):
        threads, rows, lanes, regs, blocks = gp.grid_layout(nb, bw)
        assert lanes == min(bw, 32) and lanes * regs == bw
        assert threads == 32 * gp.GRID_WARPS
        assert rows * lanes == threads
        assert (blocks - 1) * rows < nb <= blocks * rows
