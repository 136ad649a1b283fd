"""HMC chunk kernels' plain versions, port vs reference (CPU).

The reference's Pallas chunk kernels run in interpret mode, as their own
tests run them. The port is fed the reference's own random streams: each
JAX wrapper draws momenta, step-size jitters and accept uniforms from
``jax.random.split(key, 3)``; the tests draw them the same way and hand them
to the port's ``draws=`` entries. On CPU tensors the port's wrappers run
their plain versions. Everything runs in float64, so both sides agree to
1e-9 and make the same accept decisions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.inference.hmc import _quadratic_chains as j_quadratic_chains
from modppl_tpu.ops import leapfrog_pallas as jmxu
from modppl_tpu.ops import leapfrog_vpu_pallas as jvpu
from modppl_tpu_torch.inference.hmc import _quadratic_chains
from modppl_tpu_torch.interop import phase_streams, quadratic_from_numpy, tensor
from modppl_tpu_torch.ops import leapfrog, leapfrog_small
from _torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-9)


def _target(d, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d)) * 0.3
    lam = a @ a.T + np.eye(d)
    b = rng.standard_normal(d)
    return lam, b, rng


def _jax_draws(key, num, n, d, small):
    """The reference wrappers' streams: split(key, 3) -> momenta, jitter,
    accept uniforms; the d <= 12 wrappers draw the latter two as
    (T, n, 1)."""
    k_mom, k_jit, k_acc = jax.random.split(key, 3)
    shape = (num, n, 1) if small else (num, n)
    z = jax.random.normal(k_mom, (num, n, d), jnp.float64)
    jit = jax.random.uniform(k_jit, shape, jnp.float64, minval=0.5,
                             maxval=1.5)
    u01 = jax.random.uniform(k_acc, shape, jnp.float64)
    return phase_streams(np.asarray(z), np.asarray(jit), np.asarray(u01))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [3, 10])
def test_sample_chunk_small_matches_reference(d):
    lam, b, rng = _target(d, d)
    n, T, L = 200, 6, 5
    u0 = rng.standard_normal((n, d)) * 0.5
    im = 0.5 + rng.random(d)
    key = jax.random.PRNGKey(d)
    j_us, j_lp, j_ap, j_dv, j_uf = jvpu.hmc_sample_chunk_small(
        key, jnp.asarray(u0), jnp.asarray(0.3), jnp.asarray(lam),
        jnp.asarray(b), jnp.asarray(im), T, L, interpret=True)
    lam_t, b_t = quadratic_from_numpy(lam, b)
    us, lp, ap, dv, uf = leapfrog_small.hmc_sample_chunk_small(
        None, tensor(u0), torch.tensor(0.3, dtype=torch.float64), lam_t, b_t,
        tensor(im), T, L, draws=_jax_draws(key, T, n, d, small=True))
    for got, want in ((us, j_us), (lp, j_lp), (ap, j_ap), (uf, j_uf)):
        _close(got, want)
    np.testing.assert_array_equal(dv.numpy(), np.asarray(j_dv))
    # the accept decisions: a chain moved iff the reference's moved
    prev = np.concatenate([u0[None], np.asarray(j_us)[:-1]])
    moved_ref = np.any(np.asarray(j_us) != prev, axis=-1)
    moved = np.any(us.numpy() != np.concatenate(
        [u0[None], us.numpy()[:-1]]), axis=-1)
    np.testing.assert_array_equal(moved, moved_ref)
    assert 0 < moved.mean() < 1


def test_warmup_chunk_small_matches_reference():
    """T = 100: the schedule (15, [25, 50], 10) fires both slow windows'
    ends, and the Welford passes run for 75 iterations."""
    d, n, T, L = 3, 256, 100, 4
    lam, b, rng = _target(d, 11)
    u0 = rng.standard_normal((n, d))
    key = jax.random.PRNGKey(5)
    j_us, j_eps, j_im = jvpu.hmc_warmup_chunk_small(
        key, jnp.asarray(u0), 0.2, jnp.asarray(lam), jnp.asarray(b), T, L,
        interpret=True)
    lam_t, b_t = quadratic_from_numpy(lam, b)
    us, eps, im = leapfrog_small.hmc_warmup_chunk_small(
        None, tensor(u0), 0.2, lam_t, b_t, T, L,
        draws=_jax_draws(key, T, n, d, small=True))
    _close(us, j_us)
    _close(eps, j_eps)
    _close(im, j_im)
    assert not np.allclose(im.numpy(), 1.0)   # the windows' ends fired


@pytest.mark.parametrize("d,n", [(13, 37), (20, 10), (64, 9), (70, 5)])
def test_sample_chunk_matches_reference(d, n):
    lam, b, rng = _target(d, d)
    T, L = 4, 3
    u0 = rng.standard_normal((n, d)) * 0.3
    im = 1.0 + rng.random(d)
    key = jax.random.PRNGKey(42)
    j_us, j_lp, j_ap, j_dv = jmxu.hmc_sample_chunk(
        key, jnp.asarray(u0), 0.1, jnp.asarray(lam), jnp.asarray(b),
        jnp.asarray(im), T, L, interpret=True)
    lam_t, b_t = quadratic_from_numpy(lam, b)
    us, lp, ap, dv = leapfrog.hmc_sample_chunk(
        None, tensor(u0), 0.1, lam_t, b_t, tensor(im), T, L,
        draws=_jax_draws(key, T, n, d, small=False))
    for got, want in ((us, j_us), (lp, j_lp), (ap, j_ap)):
        _close(got, want)
    np.testing.assert_array_equal(dv.numpy(), np.asarray(j_dv))
    u01 = _jax_draws(key, T, n, d, small=False)[2].numpy()
    np.testing.assert_array_equal(u01 < ap.numpy(), u01 < np.asarray(j_ap))


def test_warmup_chunk_matches_reference():
    d, n, T, L = 24, 64, 60, 4
    var = np.geomspace(0.1, 10.0, d)
    lam = np.diag(1.0 / var)
    b = np.zeros(d)
    u0 = np.random.default_rng(1).standard_normal((n, d)) * np.sqrt(var)
    key = jax.random.PRNGKey(7)
    j_us, j_eps, j_im = jmxu.hmc_warmup_chunk(
        key, jnp.asarray(u0), 0.5, jnp.asarray(lam), jnp.asarray(b), T, L,
        interpret=True)
    lam_t, b_t = quadratic_from_numpy(lam, b)
    us, eps, im = leapfrog.hmc_warmup_chunk(
        None, tensor(u0), 0.5, lam_t, b_t, T, L,
        draws=_jax_draws(key, T, n, d, small=False))
    _close(us, j_us)
    _close(eps, j_eps)
    _close(im, j_im)


@pytest.mark.parametrize("d", [3, 16])
def test_quadratic_chains_replay_reference(d):
    """The whole fused path, warmup then sampling, on the reference's
    draws: warmup streams from fold_in(key, 0), sampling from
    fold_in(key, 2)."""
    lam, b, rng = _target(d, 100 + d)
    n, W, S, L = 40, 30, 8, 4
    u0 = rng.standard_normal((n, d))
    key = jax.random.PRNGKey(d)
    want = j_quadratic_chains(key, jnp.asarray(lam), jnp.asarray(b),
                              jnp.asarray(u0), W, S, 0.1, L, 0.8,
                              interpret=True)
    small = d < 13
    draws = (_jax_draws(jax.random.fold_in(key, 0), W, n, d, small),
             _jax_draws(jax.random.fold_in(key, 2), S, n, d, small))
    lam_t, b_t = quadratic_from_numpy(lam, b)
    got = _quadratic_chains(0, lam_t, b_t, tensor(u0), W, S, 0.1, L, 0.8,
                            draws=draws)
    for i in (0, 1, 2, 4, 5):   # us, logp, aprob, eps, inv_mass
        _close(got[i], want[i])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_divergent_chain_leaves_others_bitwise_unchanged():
    """Chain 0's energy overflows float32: it is flagged divergent and held
    at its start, and every other chain's results are bitwise those of the
    run without it (tests/test_leapfrog_pallas.py:560-593)."""
    rng = np.random.default_rng(0)
    d, n, T, L = 20, 8, 3, 4
    a = rng.standard_normal((d, d)) * 0.2
    lam = torch.tensor(a @ a.T + np.eye(d), dtype=torch.float32)
    b = torch.zeros(d)
    im = torch.ones(d)
    u_ok = torch.tensor(rng.standard_normal((n, d)) * 0.5,
                        dtype=torch.float32)
    u_bad = u_ok.clone()
    u_bad[0] = 1e20
    draws = leapfrog_small.phase_draws(3, T, n, d, torch.float32, "cpu")
    ok = leapfrog.hmc_sample_chunk(None, u_ok, 0.1, lam, b, im, T, L,
                                   draws=draws)
    bad = leapfrog.hmc_sample_chunk(None, u_bad, 0.1, lam, b, im, T, L,
                                    draws=draws)
    assert bool(bad[3][:, 0].any())
    assert bool(torch.isfinite(bad[0][:, 0]).all())
    for x_ok, x_bad in zip(ok, bad):
        assert torch.equal(x_ok[:, 1:], x_bad[:, 1:])


def test_chain_tile_and_shared_memory_limit():
    """Kernel 5 (fused_leapfrog) takes kernels 6 and 7's tile and carve-up:
    a tile fits the CTA's threads and shared memory at d = 13, 128 and 224
    (and at d = 3, which only kernel 5 takes), d = 128 keeps its 32 chains
    a CTA, and at d = 232 the wrapper raises before a launch."""
    for d in (3, 13, 128, 224):
        dp = -(-d // 4) * 4
        tile = leapfrog.chunk_tile(d)
        assert tile * dp <= 16 * leapfrog.CHUNK_THREADS
        assert leapfrog.chunk_smem_bytes(d, tile) <= leapfrog.MAX_SMEM
    assert leapfrog.chunk_tile(128) == 32
    with pytest.raises(ValueError, match="shared memory"):
        leapfrog.chunk_tile(232)
    # off the CPU the wrapper picks the tile first (a meta tensor reaches
    # the kernel path without a card)
    u = torch.empty(4, 232, device="meta")
    with pytest.raises(ValueError, match="largest d is 224"):
        leapfrog.fused_leapfrog(u, u, 0.1, None, None, None, 8)


@pytest.mark.parametrize("d,tile", [(13, 64), (64, 64), (128, 32),
                                    (160, 16), (224, 8)])
def test_chunk_tile_and_shared_memory_limit(d, tile):
    """Kernels 6 and 7 hold Λ, two input buffers and a prefetched stream
    in shared memory, and each of the 256 threads owns 4 x 4 of the tile:
    the mirror picks the largest tile that fits both, the warmup's tile
    partials at the chain limit fit its reduction scratch, and the kernels
    stop at d = 224."""
    dp = -(-d // 4) * 4
    assert leapfrog.chunk_tile(d) == tile
    assert leapfrog.chunk_smem_bytes(d, tile) <= leapfrog.MAX_SMEM
    assert (tile // 4) * (dp // 4) <= leapfrog.CHUNK_THREADS
    bigger = [t for t in leapfrog.CHUNK_TILES if t > tile]
    if bigger:
        t = min(bigger)
        assert (leapfrog.chunk_smem_bytes(d, t) > leapfrog.MAX_SMEM
                or t * dp > 16 * leapfrog.CHUNK_THREADS)
    n = leapfrog.chunk_max_chains(d)
    ptiles = 1 << (-(-n // tile) - 1).bit_length()
    assert ptiles <= 2 * tile * dp < 2 * ptiles   # the scratch, fully used
    assert n >= 4096   # the ill-conditioned leg's chains, at every width
    if d == leapfrog.CHUNK_MAX_DIM:
        with pytest.raises(ValueError, match="largest d is 224"):
            leapfrog.chunk_tile(d + 1)
    else:
        assert leapfrog.chunk_tile(d + 1) in leapfrog.CHUNK_TILES


def _ring_schedule(num, stages):
    """The sampling kernel's stream ring (csrc/hmc_small.cu:
    sample_small_kernel) as a list of events, one thread's program order:
    ("load", t, slot) issues transition t's cp.async copies into a slot,
    ("commit",) closes a group, ("wait", k) returns once at most k groups
    are pending, ("read", t, slot) reads transition t's streams."""
    ev = []
    for t in range(stages - 1):
        if t < num:
            ev.append(("load", t, t % stages))
        ev.append(("commit",))
    for t in range(num):
        ev.append(("wait", stages - 2))
        ev.append(("read", t, t % stages))
        if t + stages - 1 < num:
            ev.append(("load", t + stages - 1, (t + stages - 1) % stages))
        ev.append(("commit",))
    return ev


def _check_ring(num, stages):
    """Every transition's slot is loaded once, its copy has landed before
    it is read, and no slot is refilled before its transition was read."""
    groups, open_group = [], []     # loads by group, in commit order
    landed = 0                      # groups known complete
    slot_holds, loaded, read = {}, [], []
    for e in _ring_schedule(num, stages):
        if e[0] == "load":
            _, t, slot = e
            held = slot_holds.get(slot)
            assert held is None or held in read, (num, stages, t, slot)
            slot_holds[slot] = t
            loaded.append(t)
            open_group.append(t)
        elif e[0] == "commit":
            groups.append(open_group)
            open_group = []
        elif e[0] == "wait":
            landed = max(landed, len(groups) - e[1])
        else:
            _, t, slot = e
            assert slot_holds[slot] == t
            assert any(t in g for g in groups[:landed]), (num, stages, t)
            read.append(t)
    assert loaded == list(range(num)) and read == list(range(num))


@pytest.mark.parametrize("d", range(1, leapfrog_small.MAX_DIM + 1))
def test_sample_layout_and_ring_schedule(d):
    """Kernel 9 (hmc_sample_chunk_small) at every d it takes: its stream
    ring fits a block's shared memory (dynamic: the launch opts in above
    48 KB), and the ring loads every transition's slot once, before the
    read, and never overwrites a slot not yet read, at T = 1, T < stages,
    T = stages and T = 500 (the hierarchical leg's sampling phase)."""
    block, stages, smem = leapfrog_small.sample_layout(d)
    assert block % 32 == 0 and stages >= 2
    assert smem == 4 * stages * (d + 2) * block <= leapfrog_small.MAX_SMEM
    for num in (1, stages - 1, stages, 500):
        _check_ring(num, stages)


@pytest.mark.parametrize("d", [5, 40])
def test_quadratic_logp_matches_reference(d):
    lam, b, rng = _target(d, 200 + d)
    u = rng.standard_normal((7, d))
    np.testing.assert_allclose(
        leapfrog.quadratic_logp(tensor(u), tensor(lam), tensor(b)).numpy(),
        np.asarray(jmxu.quadratic_logp(jnp.asarray(u), jnp.asarray(lam),
                                       jnp.asarray(b))), **TOL)


def _spread_f32(n, seed):
    """float32 values over many binades and both signs, so that any change
    of add order shows in the bits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp(rng.uniform(-12, 12, n))
    return x.astype(np.float32)


def _warp_rows_model(x):
    """One row's total in csrc/hmc_pooled.cuh:warp_rows' order, P = len(x)
    a power of two <= 256: lane l sums its chunk [l E, (l + 1) E),
    E = max(1, P / 32), by the adjacent-pairing tree, then lane l adds
    lane l + s's partial for s = 1, 2, 4, ... < min(P, 32) (a shuffle down
    past lane 31 returns the lane's own value); lane 0 holds the total."""
    P = x.shape[0]
    E, span = max(1, P // 32), min(P, 32)
    v = np.zeros((32, 8), np.float32)
    for lane in range(32):
        for m in range(min(E, 8)):
            if lane * E + m < P:
                v[lane, m] = x[lane * E + m]
    st = 1
    while st < E:
        for m in range(0, 8, 2 * st):
            v[:, m] = v[:, m] + v[:, m + st]
        st *= 2
    t = v[:, 0].copy()
    st = 1
    while st < span:
        t = t + np.concatenate([t[st:], t[32 - st:]])
        st *= 2
    return t[0]


@pytest.mark.parametrize("P", [4, 32, 64, 256])
def test_warp_rows_order_is_the_tree(P):
    """The warmups pool one warp a row (warp_rows); its order is the
    adjacent-pairing tree, so the sum is bitwise the port's and the
    reference's _tree_sum in float32."""
    from modppl_tpu.inference.adaptation import _tree_sum as j_tree_sum
    from modppl_tpu_torch.inference.adaptation import _tree_sum

    for seed in range(5):
        x = _spread_f32(P, 1000 * P + seed)
        got = _warp_rows_model(x)
        want = _tree_sum(torch.from_numpy(x))
        assert want.dtype == torch.float32
        assert got.tobytes() == want.numpy().tobytes()
        assert got.tobytes() == np.asarray(j_tree_sum(jnp.asarray(x))).tobytes()


@pytest.mark.parametrize("n", [10_000, 100_000])
@pytest.mark.parametrize("tile", [64, 128, 256])
def test_tile_trees_then_partials_tree_is_one_tree(tile, n):
    """The warmups' pooled sum: a tree inside each tile of chains (the last
    one zero-padded), then a tree over the tile totals zero-padded to a
    power of two. For a power-of-two tile that is one tree over the chains
    zero-padded to the next power of two, whatever the tile: the bits of
    _tree_sum over all chains, which the plain versions take."""
    from modppl_tpu_torch.inference.adaptation import _tree_sum

    x = _spread_f32(n, tile + n)
    ntiles = -(-n // tile)
    padded = np.zeros(ntiles * tile, np.float32)
    padded[:n] = x
    tiles = torch.from_numpy(padded.reshape(ntiles, tile))
    partials = _tree_sum(tiles.T)                 # (ntiles,) tile totals
    for i in (0, ntiles - 1):
        assert partials[i].numpy().tobytes() == _warp_rows_model(
            tiles[i].numpy()).tobytes()
    got = _tree_sum(partials)                     # pads to ptiles
    want = _tree_sum(torch.from_numpy(x))
    assert got.numpy().tobytes() == want.numpy().tobytes()
    ptiles = 1 << (ntiles - 1).bit_length()
    assert ptiles * tile == 1 << (n - 1).bit_length()
