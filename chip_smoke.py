"""Drive modppl_tpu_torch's paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Twenty-six paths, the small entries and the lane key streams, each
driven with every kernel's launch counter set to 0 just before it and read
just after:

- the spiral-tracking bootstrap particle filter
  (``parallel/sharded_smc.sharded_batched_particle_filter``, one device,
  auto-batched, ``ess_threshold=1.0``) at N = 2^20 particles and T = 10
  steps in float32: one init and 9 steps, each of which resamples through
  three hand-written CUDA kernels;
- pooled-adaptation HMC on quadratic targets through
  ``inference/hmc.hmc_runner(device="cuda")``, the reference's two legs at
  full width (``LEGS``): the whole warmup and the whole sampling phase are
  one launch each of the d <= 12 (hierarchical, d = 3) or d >= 13
  (ill-conditioned Gaussian, d = 128) chunk kernels;
- the 3-state HMM of the reference's SMC gate through
  ``inference/vsmc.batched_particle_filter`` at N = 2^20, T = 10, float32
  weights and an int32 state, which no fused gather takes: each of the 9
  steps resamples through S -> ``grid_rank`` (kernel 4) -> a gather;
- the spiral through the same ``vsmc`` filter, whose float32 state takes
  the fused arm (kernel 3, 9 launches);
- fixed-step HMC, ``ops/leapfrog.hmc_quadratic``, on both HMC legs' targets
  after their warmup, at the adapted step size and inverse mass: one launch
  per transition of ``hmc_transition_small`` (d = 3, 500 transitions) or
  ``fused_leapfrog`` (d = 128, 256 transitions);
- guided and rejuvenated SMC (``bench.py:422-520``): the scalar
  linear-Gaussian SSM (A, Q, R = 0.9, 0.5, 0.3) through
  ``sharded_batched_particle_filter`` with the locally optimal proposal and
  one regenerative move of ``x`` a step, N = 2^20, T = 10, float32: each of
  the 9 steps resamples through kernels 1, 2 and 3;
- the generic HMC path on Bayesian logistic regression (``bench.py:128-185``,
  ``bench_hmc_nonquad``): ``hmc_runner(device="cuda")`` at d = 16, n = 128,
  10^4 chains, 300 + 500 iterations, L = 4, pooled adaptation, float32,
  each leapfrog step one batched ``vmap(grad_and_value)`` call through the
  model: no kernel of the port lies on it, and none may launch;
- importance sampling (``inference/importance.importance_sampling``,
  ``vectorized=True``) on the saturated hierarchical model at 2^24 lanes in
  one batched generate, float32, and the eager branching model through the
  same entry point (``vectorized=False``);
- Metropolis-Hastings (``inference/mh``) on the eager branching model,
  trans-dimensional jumps, drifts and regenerative moves;
- the eager particle filter (``inference/smc.ParticleSystem``) over the
  hand-coded HMM and the spiral ``Unfold``;
- ChEES-HMC (``inference/chees.chees_runner``, ``bench.py:306-367``) on
  the hierarchical leg's target with the gate observed, 10^4 chains, 200 +
  300 iterations, float32: each leapfrog step one batched
  ``vmap(grad_and_value)`` call, the shared step count read back once an
  iteration;
- mean-field ADVI (``inference/vi.advi``, ``bench.py:368-421``) on
  logistic regression at d = 16, n = 256, 1024 Monte Carlo draws a step,
  2000 steps, float32;
- the small entries: the Kalman filters, the Laplace approximation, MALA,
  exact enumeration, and ChEES on the reference tests' small models;
- NUTS (``inference/nuts.nuts_runner``, ``bench.py:246-305``, BASELINE
  configs[3]) on the hierarchical leg's target with the gate observed,
  10^4 chains, 200 + 300 iterations, max_depth 6, float32: every leaf one
  batched ``vmap(grad_and_value)`` call, one host read a subtree;
- the vmapped particle filter (``inference/vsmc.particle_filter``,
  BASELINE configs[2]): the spiral ScanKernel at 10^4 particles and 12
  steps, one key stream a particle, each step resampling through kernel 3;
  and the reference's HMM gate at 10^4 particles (systematic: S ->
  ``grid_rank``);
- ``inference/mcmc.mcmc_chains``: drift MH on the conjugate model over
  10^4 chains, one key stream a chain;
- the stochastic volatility filter (``models/stochvol.sv_scan_kernel``
  through ``batched_particle_filter(auto_batch=True)``) at 2^20 particles
  and 100 steps, ``ess_threshold=0.5``: kernel 3 every step;
- PMMH (``inference/pmcmc.pmmh`` with ``smc_log_ml_fn(auto_batch=True)``)
  on the reference test's 1-D LGSSM: 64 chains x 4096 particles in one
  chain-blocked filter a step (``inference/blocked_smc.py``), kernel 3
  once a step for all chains, 600 iterations;
- particle Gibbs with ancestor sampling (``inference/pgibbs``) on the
  reference test's LGSSM, and one conditional sweep at 2^16 x 100;
- FIVO (``inference/fivo.fit_proposal``) at the reference test's
  configuration, and the gradient of ``fivo_objective`` (the one-chain
  case of the chain-blocked filter that ``fit_proposal`` trains through)
  systematically resampled at 2^20, through kernel 3's backward;
- the tempered SMC samplers (``inference/smc_sampler``, HMC, MALA and the
  adaptive ladder) on the reference test's conjugate model at 2^20
  particles, ``grid_rank`` once a rung; parallel tempering
  (``inference/tempering``) at 6 replicas x 4 chains x 400 rounds;
- resumable inference (``inference/checkpointed``): the main path's spiral
  through ``checkpointed_sharded_particle_filter`` at 2^20 x 10 (kernels
  1-3 once a step, a checkpoint every 3 steps), BASELINE configs[2]'s
  spiral through ``checkpointed_particle_filter`` (kernel 3), and
  ``checkpointed_hmc_runner`` on the conjugate model at 10^4 chains (the
  generic path);
- the ``Cond`` combinator under importance sampling at 2^20 lanes, a
  ``Map`` plate of 2^20 elements and ``utils/profiling.capture_trace``.
ChEES, ADVI, the small entries, NUTS, ``mcmc_chains``, particle Gibbs,
``fit_proposal``, parallel tempering, the checkpointed HMC runner, ``Cond``
and ``Map`` reach no kernel of the port, and none may launch; nor do
importance sampling, MH and the eager filters.

Phases, in order; any failure raises and the script exits non-zero:

1. needs a CUDA device, and prints the card's name and power limit;
2. builds the kernels from ``modppl_tpu_torch/csrc/`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at
   N = 2^20 and 2^16 with uniform, concentrated and degenerate weights:
   the scan, the positions S, the ancestors and the copied states must all
   be bitwise equal; kernel 3 also at N = 100003 (no multiple of its
   tile), each time at C = 1, 2, 7 and 31 in both layouts, run twice;
   kernels 1 and 2 also at N = 2^14, 2^10 and 2^6 (rows of 256, 16 and 1)
   and on 37 rows of 1, 2, 16, 32, 64 and 1024, kernel 2 each time also on
   every row of its input permuted (the filter's S never falls within a
   row, so only then does its scan do work), once from an address its
   16-byte loads cannot take;
4. runs the main path with the launch counters at 0 and requires 9 launches
   of each kernel, a finite log-ML, finite states and sorted ancestors;
   reruns it on the card through the plain versions, fed the same draws,
   and requires every output bitwise equal; then reruns it on the CPU fed
   the same draws and requires the first resample's ancestors and the
   log-ML to agree within the bounds below (CUDA's and the CPU's exp, cos
   and sin round differently, which the filter amplifies step by step);
5. times the filter (median of 5 after a warm-up) and each kernel against
   its plain version and one PyTorch library call at N = 2^20 (CUDA
   events, L2 flushed before each launch; median of 20);
6. holds the four HMC kernels against their plain versions on the card:
   the d <= 12 pair bitwise (d = 3 at 10^4 chains over the full 500 / 300
   iterations, d = 12 over 20 / 60; the sampling kernel also at d = 1, 3,
   5, 8 and 12 over 10 007 chains, a partial last block, and T shorter
   than its stream ring or wrapping it, ``SAMPLE_CASES``; the warmup also
   over more than 256 tile partials, ``MANY_SMALL``), the d >= 13 pair at
   d = 13, 64, 128
   and 160, every output to the tolerances below (and reports whether
   bitwise), the sampling kernel alone with forced accepts at d = 224,
   the widest it takes, and the warmup alone at d = 13 over 20000 chains
   (more tiles than the card holds at once, more than 256 tile partials);
   runs every kernel twice, requiring bitwise equal
   results, and checks that a diverging chain leaves the others unchanged;
7. runs both HMC legs with the counters at 0 and requires one launch of
   each of the leg's two kernels, the fused path, ``quad_check_ok`` and
   posterior moments within the reference tests' bounds;
8. times each leg (median of 3 after a warm-up; min-coordinate ESS/s and
   transitions/s) and each HMC kernel against its plain version at the
   leg's shapes;
9. holds the three slice-3 kernels against their plain versions on the
   card: ``grid_rank`` bitwise at N = 2^20, 2^16 and 100003 with the three
   weight kinds and on S all 0 and all N (where kernel 3 is held too, as
   in phase 3), ``hmc_transition_small`` bitwise on all seven outputs at
   d = 3 and 7 (10^4 chains) and d = 1 and 5 (10 007 chains),
   ``fused_leapfrog`` bitwise at
   d = 3, 8, 13, 64, 128 and 224 (one call of 32 steps); each twice;
10. runs the HMM leg with the counters at 0 and requires 9 launches of
    ``grid_rank`` and none of kernel 3, a log-ML within 0.03 of the exact
    forward algorithm's, sorted ancestors, and every output bitwise equal
    to the same filter through ``grid_rank``'s plain version; an
    ``ess_threshold = 0.5`` run must skip at least one resample;
11. runs the spiral through ``vsmc`` (9 launches of kernel 3, none of
    ``grid_rank``), then ``hmc_quadratic`` on both legs (500 and 256
    launches, posterior within the bounds of phase 7, no divergence at
    d = 3);
12. times the HMM leg (median of 5), each ``hmc_quadratic`` leg (median of
    3) and the three new kernels against their plain versions, bounds and
    (``grid_rank``) ``torch.searchsorted``;
13. runs the guided leg with the counters at 0 and requires 9 launches each
    of kernels 1, 2 and 3 and none of any other, a log-ML within 0.05 of
    the exact Kalman value (float64 numpy), an overall acceptance of the
    moves strictly between 0 and 1, and every output bitwise equal to the
    same filter through the plain versions on the card, fed the run's
    recorded draws (resample uniforms, proposal draws, each move's draws
    and accept uniforms);
14. times the guided leg (median of 5 after a warm-up) in particle-steps/s;
15. runs the logistic-regression leg with the counters at 0 and requires no
    launch of any kernel, the generic path, finite outputs, and the
    posterior mean within 0.05 (or 4 Monte Carlo standard errors, if more)
    of a float64 numpy oracle (self-normalised importance sampling from the
    Laplace approximation at ``map_newton``'s mode, covariance inflated
    1.5x, 10^6 draws); the same key again must give bitwise-equal draws;
    then the per-chain path (``pooled_adaptation=False``, 256 chains,
    200 + 200): inverse mass (256, 16), posterior mean within 0.1;
16. times the leg (one run after phase 15's warm-up run; min-coordinate
    ESS/s, transitions/s, accept rate and step size) and one batched
    value-and-grad call at its 10^4 chains;
17. runs the importance leg with the counters at 0 and requires no launch:
    ``make_hierarchical_static(5)`` on the reference tests' quadratic data
    at N = 2^24 lanes, finite log-weights, ESS >= 100, the log-ML within 4
    Monte Carlo standard errors (sqrt(1/ESS - 1/N)) of the exact evidence,
    the weighted a, b, c within 4 posterior sd / sqrt(ESS) of the exact
    posterior mean, P(is_linear) < 1e-3, the same key twice bitwise equal;
    then 2^16 indices by ``importance_resampling`` (in [0, N), mean c within
    the same bound) and the eager hierarchical model at 300 samples (finite
    log-ML); then times the leg (median of 5, lanes/s);
18. runs MH on the eager hierarchical model with the counters at 0 (no
    launch): 1000 rounds of one trans-dimensional jump, three drifts and
    one ``regen_mh`` of the gate and the coefficients, 200 burn-in; the kept
    rounds quadratic in >= 99% of them, their mean a, b, c within 0.05 of
    the exact posterior mean, finite coefficients; ``regen_mh`` on the
    conjugate model (4000 steps, mean 0.5 and sd sqrt(0.5) within 0.08);
    then times 50 rounds (ms a transition, transitions/s);
19. runs ``ParticleSystem`` with the counters at 0 (no launch) over the
    hand-coded HMM (300 particles, data [0, 0, 1, 2]: log-ML within 0.25 of
    the exact forward algorithm's, ESS in (0, N]) and the spiral
    ``Unfold`` (100 particles, 12 steps: the final mean position within 0.2
    of the last observation); then times both (particle-steps/s);
20. runs the ChEES leg with the counters at 0 (no launch): finite draws
    (10^4 chains x 300), tau finite, every step count >= 1, the pooled
    posterior mean of a, b, c within 4 posterior sd / sqrt(min ESS) of
    ``exact_hierarchical_posterior``, the accept rate within 0.1 of the
    reference's own at this configuration (``CHEES_REF_ACCEPT``); that run
    is the timed one (min-coordinate ESS/s, value-and-grad calls and ms a
    call); then key 0 twice at 10^3 chains, 50 + 50 (``CHEES_RERUN``),
    bitwise equal;
21. runs the VI leg with the counters at 0 (no launch): finite outputs,
    mu within ``VI_MU_BOUND`` (twice the reference's own distance at this
    size) of phase 15's float64 oracle's posterior mean on these data, the
    last 50 steps' mean ELBO at most the oracle's log evidence; then times
    one run after phase 21's: MC model evals/s and the final ELBO;
22. checks each small entry once with the counters at 0 (no launch), with
    its wall ms: ``kalman_filter_parallel`` against ``kalman_filter`` on a
    2-D LGSSM at T = 4096 in float64 (within 1e-9) and the guided leg's
    scalar model's log-ML against the numpy Kalman value;
    ``laplace_approximation`` on Poisson-gamma (log-ML within 0.05 of
    log 1/8); ``mala`` on the conjugate model (4 chains x (1000 + 4000))
    and the gamma scale model (4 x (1000 + 3000)) at the reference tests'
    bounds; ``enumerate_posterior`` on the bernoulli gate (1e-9); and, at
    the reference's configuration, the gates the CPU tests shorten: ChEES
    on the conjugate model (32 chains, 300 + 400, dynamic and
    ``static_unroll=16``);
23. lane key streams at C = 2^20 (``core/keys.py``): lane keys, splits,
    words and float32 / float64 uniforms on the card bitwise equal to the
    same calls on the CPU, the normals within 1e-5 (float32) and 1e-12
    (float64) of (1 + |z|) (the devices' ``ndtri`` rounds differently), and
    the first C lanes of a 2C draw equal to the C draw;
24. runs the NUTS leg once with the counters at 0 (no launch), timed:
    finite draws, the posterior mean of a, b, c within 4 posterior sd /
    sqrt(min ESS) of ``exact_hierarchical_posterior``, divergences below
    1%, mean tree depth above 1; prints min-coordinate ESS/s, mean tree
    depth, accept, leaves a transition and value-and-grad calls; then a
    3 + 3 run timed and then profiled (the idle share);
25. runs the vmapped spiral filter with the counters at 0: 11 launches of
    kernel 3 and none other, the weighted mean position within 0.1 of the
    last observation, every output bitwise equal to its rerun through the
    plain versions on the card fed the run's recorded draws; the HMM gate
    at 10^4 particles, multinomial (no launch) and systematic (3 launches
    of ``grid_rank``, every output bitwise equal to its rerun through
    ``grid_rank_plain`` on the recorded draws), log-ML within 0.03 of the
    exact one; then times the spiral (median of 5, particle-steps/s). No
    plain-version rerun of any phase may launch a kernel;
26. runs ``mcmc_chains`` with the counters at 0 (no launch): 10^4 chains
    x 400 iterations of drift MH on the conjugate model, the pooled draws
    after 100 with mean 0.5 and sd sqrt(0.5) within 0.03, timed;
27. runs the SV filter (SVParams(), 2^20 x 100, ``simulate_sv``'s data
    from key 2027) with the counters at 0: 99 launches of kernel 3 and
    none other, the log-ML within 0.1 of a float64 grid oracle (m = 400 on
    [-4, 2]; it must move less than 0.01 at m = 1600 on [-5, 3]),
    resampling on 0 < k < 99 steps, every output bitwise equal to its
    rerun through the plain versions on the recorded draws; then times it
    (median of 5, particle-steps/s);
28. holds kernel 3 on a chain-blocked S (64 x 4096) bitwise against its
    plain version, one launch for all chains, and a NaN chain against the
    others (unmoved, bitwise); then runs PMMH (64 chains x 4096 particles,
    600 iterations, step 0.15, the reference test's data) with the
    counters at 0: 601 x 9 launches of kernel 3 and none other, the
    posterior mean after 150 within 0.07 of the float64 quadrature oracle,
    every chain's accept in (0.05, 0.9), the estimator at a = 0.7 over 4
    keys within 0.1 of the Kalman log-ML; timed (ms an iteration,
    chain-iterations/s);
29. runs particle Gibbs (T = 6, N = 32, 750 sweeps, 150 burn-in) with the
    counters at 0 (no launch): the trajectory's means and sds within 0.12
    of the Kalman smoother's; then without ancestor sampling at N = 64, the
    last step's mean within 0.12; one ``csmc_sweep`` at N = 2^16, T = 100,
    its log-ML within 1.0 of the Kalman filter's; each timed;
30. runs ``fit_proposal`` (N = 256, 400 steps, lr 0.03, batch 4, no
    resampling) with the counters at 0 (no launch): the learned w_obs
    within 0.15 and std within 0.1 of the optimal proposal's, the bound's
    sd over 32 runs under half the initial proposal's, its mean within 0.1
    of the Kalman log-ML; then the value and gradient of ``fivo_objective``
    (auto-batched, systematic, ``ess_threshold=1.0``; one chain of the
    blocked filter ``fit_proposal`` runs) at N = 2^20: 7
    launches of kernel 3 and none other, the value bitwise equal to the
    same call through the plain versions, the gradient finite, nonzero and
    within 1e-5 relative of theirs; each timed;
31. runs ``smc_sampler`` (HMC: 16 rungs, 2 moves, step 0.3, L = 8; MALA:
    3 moves) and ``adaptive_smc_sampler`` on the conjugate model at 2^20
    particles with the counters at 0: one ``grid_rank`` launch a rung and
    none other, the reference tests' gates (weighted mean within 0.05,
    0.07 for MALA; sd within 0.06; log-ML within 0.15, 0.2 for MALA; accept
    above 0.4; 1 < rungs < 100, betas increasing to 1); then
    ``parallel_tempering`` (6 replicas x 4 chains x 400 rounds, no launch):
    the cold chain's mean and sd after 100 within 0.06, swap accept above
    0.1; each timed;
32. runs the main path's spiral (2^20 x 10, ``auto_batch=True``,
    ``ess_threshold=1.0``) through ``checkpointed_sharded_particle_filter``
    with a checkpoint every 3 steps under a temporary directory, with the
    counters at 0: uninterrupted, 9 launches each of kernels 1-3 and none
    other, its state, log-weights and log-ML bitwise the one-shot filter's
    at the same key; a head run of 3 steps, then a run resumed from its
    checkpoint with the full constraints: 3 + 6 launches each, bitwise the
    uninterrupted run, and bitwise its rerun through the plain versions
    (in which no kernel launches); then the checkpoint's bytes, the median
    ms of a save and a restore of the filter's carry, and the median wall
    ms of the checkpointed filter beside the one-shot's (turns one-shot,
    checkpointed, checkpointed, one-shot, 5 runs each);
33. runs BASELINE configs[2]'s spiral (10^4 x 12, systematic) through
    ``checkpointed_particle_filter``, a checkpoint every 4 steps: 11
    launches of kernel 3 and none other, bitwise
    ``particle_filter(store_traces=False)`` at the same key, and a run
    resumed after 4 steps bitwise the uninterrupted one; then the LG model
    at 4096 particles, a checkpoint every 2 steps: the log-ML within 0.08
    of the Kalman value (``tests/test_checkpointed.py:65-75``);
34. runs ``checkpointed_hmc_runner`` on the conjugate model (mu ~ N(0, 1),
    x ~ N(mu, 1), x = 1) at 10^4 chains, 100 + 200, L = 8, a checkpoint
    every 50 samples, with the counters at 0 (no launch): a head run of 50
    samples and a resume to 200, concatenated, bitwise the uninterrupted
    run (``unconstrained``, ``accept_prob``, ``step_size``);
    ``summarize_mcmc`` of it: mean within 4 Monte Carlo standard errors of
    0.5, sd within 0.03 of sqrt(0.5), R-hat within 0.05 of 1; timed;
35. runs, with the counters at 0 (no launch), ``Cond`` under
    ``importance_sampling`` at 2^20 lanes (p ~ bernoulli(0.5), v from
    ``Cond(N(2, 0.1), N(-2, 0.1))``, y ~ N(v, 1) observed at 1.5): P(p |
    y) within 4 Monte Carlo standard errors of its closed form; ``Map``'s
    ``generate`` over 2^20 plate elements: its weight within 1e-5
    relative of the float64 sum of the elements' log-densities; then
    ``capture_trace`` around one run of phase 32's filter, whose written
    trace must name kernels 1-3.
36. requires the native layer (``native/addrops.c``, ``ctrie.c``, built
    at first import) active, then draws 2^20 lanes float32 of each lane
    form of slice 11 (``lane_draw_cases``: uniform_discrete, geometric,
    poisson at rates 4 and 40, gamma at shapes 2 and 0.5, beta,
    exponential, laplace, student_t, binomial at (10, 0.4) and (100,
    0.7), dirichlet, negative_binomial, ``plate(gamma, 8)`` and
    ``iid(mvnormal, 3)``) with the counters at 0 (no launch): the first C
    lanes of a 2C draw and three lanes' 1-lane draws bitwise the C draw's;
    the Kolmogorov-Smirnov distance to the closed-form CDF (float64,
    scipy) below 1.95 / sqrt(N), or the chi-square over bins of expected
    count >= 5 below its 0.001 quantile, dirichlet by its beta marginals;
    prints each draw's rounds (most, mean), host reads and median ms;
37. on tests/test_hmc_vi.py's gamma-prior scale model, with the counters
    at 0 (no launch): ``importance_sampling`` over 10^4 lanes (gamma's
    lane form under the model), every scale > 0 and the weighted mean
    within 0.08 and within 4 standard errors at its ESS of the quadrature
    oracle; then NUTS at 10^4 chains, 200 + 300, max_depth 6, from the
    reference's start (the initial trace's point plus 0.5 standard
    normals a chain), timed: every scale > 0, the mean within 0.08 and
    within 4 Monte Carlo standard errors of the oracle, divergences below
    1%; ESS/s, leaves a transition, value-and-grad calls;
38. runs tests/test_spiral_lgssm_moments.py's gate through the vmapped
    ``particle_filter(store_traces=True)``, systematic, at N = 32768 and
    2^20, T = 12, with the counters at 0: 11 launches of kernel 3 and none
    other, the log-ML, the filtered mean and covariance at T and the
    smoothed means along the ancestry within the reference's bounds of
    ``kalman_filter_parallel`` / ``kalman_smoother_parallel``, every
    output bitwise its rerun through the plain versions on the recorded
    draws, the peak device memory beside the stored states, timed; then MH
    at phase 18's schedule in turns pure, native, native, pure (each turn
    a process; the pure turns rebind ``Trie`` to ``PureTrie``), the same
    chains, ms a transition; then ``enumerate_posterior`` over a
    hand-coded GenFn on the card against its closed form (1e-12).

Phases 39-42 (slice 12, layout invariance and multi-device) run the dp = 1
runs in this process and the dp = 2 (ranks 0-1) and dp = 4 runs on four
gloo ranks that share this card (``--slice12-rank``, spawned once after the
kernels are built, killed together past SHARD_TIMEOUT): NCCL refuses two
ranks on one GPU, so the ranks use gloo (whose send and recv take only
host tensors: ``ppermute`` stages through the host), and the ranks' times
are four processes on one card, not four cards.

39. the spiral filter at 2^20 x 10 (BASELINE configs[4]'s 10^6 particles)
    through ``sharded_batched_particle_filter`` at dp = 1, 2 and 4: every
    output bitwise across dp (digests) and each run bitwise its rerun
    through the plain versions; kernels 1-2 9 launches a rank, kernel 3 9
    at dp = 1, kernel 4 (the parents from the gathered S) 9 a rank at
    dp > 1; the collectives' bytes a step, the halo and ring exchanges and
    the host copies; wall ms a dp; kernels 1-2's µs at the shards' rows;
40. ``ess_threshold=0.5`` and ``halo=1`` (every step the ring) at dp = 4,
    and the guided and rejuvenated LG filter at 2^20 x 10 at dp = 2, each
    bitwise its dp = 1 run;
41. the checkpointed sharded filter at dp = 2, a checkpoint every 3 steps,
    interrupted after 3 and resumed: bitwise the uninterrupted dp = 1 run;
42. ``shardmap_hmc`` and ``shardmap_chees`` on hmc-hierarchical-d3's
    target at 10^4 chains, 60 + 40, dp = 4 against dp = 1 (no kernel):
    bitwise, or else the largest differences, the target's value-and-grad
    compared across batch sizes, and both runs held to the posterior gate.

Each group of phases prints its seconds as it ends (``# seconds:``).

``--profile`` adds a torch.profiler breakdown by kernel of one run of each
path (phases 20, 21 and 32-38 included): device ops, device-to-host
copies, busy ms and the idle share; a profile that lacks a kernel the
launch counters saw says so and gives no idle share.

    python3 chip_smoke.py --turns OTHER_TREE [hmc] [resample] [lanes]

instead compares two checkouts on one card, with each tree's own code, in
turns (other, this, this, other; each turn a process of its own run from
that tree's root), and prints one JSON line per turn with a digest of each
kernel's outputs, so the turns also show whether the two trees agree
bitwise. The groups (both when none is named):

- ``hmc``: kernels 5-10 (the d >= 13 chunk kernels and ``fused_leapfrog``
  at the ill-conditioned leg's shapes, the d <= 12 chunk kernels at the
  hierarchical leg's, ``hmc_transition_small`` at (10^4, 3) with L = 8),
  both legs (``time_leg``) and ``hmc_quadratic`` on both legs' targets
  (d = 128 and d = 3, ``time_quad``; at d = 3 also one profiled run: the
  card's busy ms and ``hmc_transition_small``'s us a launch on its path);
- ``resample``: kernels 1-4 at N = 2^20 (kernels 3 and 4 digested on all
  three weight kinds), both filters' median wall ms, and one profiled run
  of each: the card's busy ms and each of its kernels' us a launch on its
  path;
- ``lanes``: the one-device spiral and guided filters at 2^20 x 10,
  median wall ms of 5 and one profiled run's busy ms each.

The last three lines are the kernels' JSON record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N = 1 << 20
T = 10
CHECK_SIZES = (1 << 20, 1 << 16)
KINDS = ("uniform", "concentrated", "degenerate")
# kernel 3 is also held at an N that is no multiple of its tile, and at
# each C below in both layouts (31 is the widest the filters fuse)
GATHER_ODD_N = 100_003
GATHER_COLUMNS = (1, 2, 7, 31)
# kernels 1 and 2 are also held at N whose rows are narrower than 1024
# (bw = 256) and than a warp (bw = 16, bw = 1), and on GRID_ODD_ROWS rows,
# which fill no whole CTA, at each of GRID_ODD_WIDTHS
GRID_SIZES = (1 << 14, 1 << 10, 1 << 6)
GRID_ODD_ROWS = 37
GRID_ODD_WIDTHS = (1, 2, 16, 32, 64, 1024)
# GPU vs CPU on the same draws: CUDA's and the CPU's exp, cos and sin round
# differently, and a particle whose ancestor flips moves every later slot of
# the systematic grid, so the two runs part after the first resample or two.
# What stays comparable: the first resample's ancestors, and the log-ML up
# to Monte Carlo error (seed-to-seed sd 0.0084 at N = 2^20 on an H100).
LOG_ML_GAP = 0.05
FIRST_STEP_AGREEMENT = 0.99


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_lw(kind, n, seed, device):
    """Log-weights: uniform-ish, concentrated (scale 30) or degenerate (one
    finite weight), float32, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        lw = rng.standard_normal(n) * 0.7
    elif kind == "concentrated":
        lw = rng.standard_normal(n) * 30.0
    else:
        lw = np.full(n, -np.inf)
        lw[rng.integers(n)] = 0.0
    return torch.from_numpy(lw.astype(np.float32)).to(device)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Errors:
    """The largest kernel-vs-plain difference seen per kernel."""

    def __init__(self):
        self.max = {}

    def same(self, name, what, got, want):
        err = (got.double() - want.double()).abs()
        both_inf = torch.isinf(got) & torch.isinf(want) & (got == want)
        err = float(torch.where(both_inf, 0.0, err).max()) if err.numel() else 0.0
        self.max[name] = max(self.max.get(name, 0.0), err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: {what} differs from the plain "
                                 f"version (max abs err {err})")


def check_kernels(device, sizes=CHECK_SIZES, kinds=KINDS):
    """Phase 3: every kernel against its plain version on ``device``."""
    errs = Errors()
    for n in sizes:
        for seed, kind in enumerate(kinds):
            s = check_grid(errs, n, kind, seed, device)
            check_gather(errs, s, kind, seed, device)
    for n in GRID_SIZES:
        for seed, kind in enumerate(kinds):
            check_grid(errs, n, kind, seed, device)
    for bw in GRID_ODD_WIDTHS:
        for seed, kind in enumerate(kinds):
            lw = make_lw(kind, GRID_ODD_ROWS * bw, seed, device)
            check_grid_rows(errs, lw.reshape(GRID_ODD_ROWS, bw), lw.max(),
                            kind, device)
    for seed, kind in enumerate(kinds):
        check_gather(errs, rank_s(kind, GATHER_ODD_N, seed, device), kind,
                     seed, device)
    return errs.max


def check_grid_rows(errs, rows, m, kind, device):
    """Kernels 1 and 2 on ``rows`` (nb, bw) against their plain versions,
    bitwise; returns kernel 2's plain (s_rows, row maxima)."""
    from modppl_tpu_torch.ops import grid_positions as gp

    nb, bw = rows.shape
    n = nb * bw
    where = f"(nb={nb}, bw={bw}, {kind})"
    got = gp.stats_cumsum(rows, m)
    want = gp.stats_cumsum_plain(rows, m)
    for what, a, b in zip(("cum", "totals", "sq_totals"), got, want):
        errs.same("stats_cumsum", f"{what} {where}", a, b)
    sync(device)

    cum, totals, _ = want
    offs_incl = gp.doubling_cumsum(totals[None, :])[0]
    offs = torch.cat([totals.new_zeros(1), offs_incl[:-1]])
    total = offs_incl[-1]
    u = torch.tensor(0.37, dtype=torch.float32, device=device)
    want = gp.positions_cummax_plain(cum, offs, total, u, n)
    # the filter's S never falls within a row, so kernel 2's scan is also
    # held on each row of cum permuted; and on cum 4 bytes past a 16-byte
    # boundary, which its word loads cannot take
    g = torch.Generator().manual_seed(bw)
    shuffled = cum[:, torch.randperm(bw, generator=g).to(device)]
    unaligned = torch.empty(n + 1, device=device)[1:].view(nb, bw)
    unaligned.copy_(shuffled)
    for label, c, plain in (
            ("", cum, want),
            (" shuffled", shuffled,
             gp.positions_cummax_plain(shuffled, offs, total, u, n)),
            (" shuffled, unaligned", unaligned,
             gp.positions_cummax_plain(shuffled, offs, total, u, n))):
        got = gp.positions_cummax(c, offs, total, u, n)
        for what, a, b in zip(("s_rows", "row maxima"), got, plain):
            errs.same("positions_cummax", f"{what}{label} {where}", a, b)
    sync(device)
    return want


def check_grid(errs, n, kind, seed, device):
    """Kernels 1 and 2 at N = ``n`` in the filter's rows, and the S the
    filter makes of them; returns S."""
    from modppl_tpu_torch.parallel import sharded_smc as smc

    lw = make_lw(kind, n, seed, device)
    s_rows, mx = check_grid_rows(errs, lw.reshape(-1, smc._cdf_block(n)),
                                 lw.max(), kind, device)
    u = torch.tensor(0.37, dtype=torch.float32, device=device)
    s, _, _ = smc._det_grid_positions(u, lw, n)
    s_plain = torch.maximum(
        s_rows, torch.cat([torch.full((1,), -2 ** 31, dtype=torch.int32,
                                      device=device),
                           torch.cummax(mx, 0).values[:-1]])[:, None]
    ).reshape(n)
    errs.same("positions_cummax", f"S (N={n}, {kind})", s, s_plain)
    sync(device)
    return s


def rank_s(kind, n, seed, device, num=None):
    """S (n,) for ``kind`` weights over ``num`` slots (default n) as the
    systematic resamplers compute it; ``"zeros"`` and ``"all_num"`` give S
    all 0 and all num."""
    from modppl_tpu_torch.ops import resample as rs
    from modppl_tpu_torch.utils.numerics import logsumexp, normalized_cdf

    num = n if num is None else num
    if kind in ("zeros", "all_num"):
        return torch.full((n,), 0 if kind == "zeros" else num,
                          dtype=torch.int32, device=device)
    lw = make_lw(kind, n, seed, device)
    cdf = normalized_cdf(lw - logsumexp(lw))
    return rs.slot_positions(cdf, torch.tensor(0.37, device=device), num)


def check_gather(errs, s, kind, seed, device):
    """Kernel 3 against its plain version on S, twice, at every C of
    GATHER_COLUMNS in both layouts: parents and states bitwise."""
    from modppl_tpu_torch.ops import fused_resample as fr

    n = s.shape[0]
    g = torch.Generator(device=device).manual_seed(seed)
    for c in GATHER_COLUMNS:
        for layout, shape in (("cn", (c, n)), ("nc", (n, c))):
            state = torch.randn(*shape, generator=g, device=device)
            got = _twice("resample_fused_from_s", lambda: (
                fr.resample_fused_from_s(s, state, layout=layout)))
            want = fr.resample_fused_plain(s, state, layout=layout)
            where = f"(N={n}, C={c}, {layout}, {kind})"
            errs.same("resample_fused_from_s", f"states {where}", got[0],
                      want[0])
            errs.same("resample_fused_from_s", f"parents {where}", got[1],
                      want[1])
            if kind == "degenerate" and int(got[1].unique().numel()) != 1:
                raise AssertionError("degenerate weights: expected a single "
                                     "ancestor")
        sync(device)


def run_filter(device, n, seed, mesh=None, **kwargs):
    """The main path: the spiral filter on ``device`` in float32 (over the
    dp shards of ``mesh``, one device for None)."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.models.spiral import (
        circle_observations,
        spiral_scan_kernel,
    )
    from modppl_tpu_torch.parallel.sharded_smc import (
        sharded_batched_particle_filter,
    )

    obs = torch.tensor(circle_observations(T), dtype=torch.float32,
                       device=device)
    kwargs.setdefault("ess_threshold", 1.0)
    return sharded_batched_particle_filter(
        mesh, seed, spiral_scan_kernel(),
        torch.zeros(2, dtype=torch.float32, device=device),
        Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]}),
        n, auto_batch=True, device=device, **kwargs)


def wrappers():
    from modppl_tpu_torch.ops import fused_resample as fr
    from modppl_tpu_torch.ops import grid_positions as gp

    return {"stats_cumsum": gp.stats_cumsum,
            "positions_cummax": gp.positions_cummax,
            "resample_fused_from_s": fr.resample_fused_from_s}


@contextlib.contextmanager
def swapped(swaps):
    """Each ``(module, name, plain)`` of ``swaps`` in the module's global
    ``name`` for the block. On a CUDA tensor the wrappers only launch
    kernels, so a reference run on the card swaps the functions its path
    calls. No kernel may launch in the block: a launch there means the
    path reached a kernel through a name the swaps missed, and would hold
    the kernel against itself."""
    fns = all_wrappers()
    before = {k: f.launches for k, f in fns.items()}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    moved = {k: f.launches - before[k] for k, f in fns.items()
             if f.launches != before[k]}
    if moved:
        raise AssertionError(f"a plain-version rerun launched kernels: "
                             f"{moved}")


def plain_versions():
    """Kernels 1-3's plain versions in their places: kernels 1-2 where the
    sharded filter calls them, kernel 3 where the sharded filter's gather
    (``parallel.resample``) and the fused systematic resampler of
    ``inference/vsmc._resample`` (``ops.fused_resample``) call it."""
    from modppl_tpu_torch.ops import fused_resample as fr
    from modppl_tpu_torch.ops import grid_positions as gp
    from modppl_tpu_torch.parallel import resample
    from modppl_tpu_torch.parallel import sharded_smc as smc

    return swapped([(smc, "stats_cumsum", gp.stats_cumsum_plain),
                    (smc, "positions_cummax", gp.positions_cummax_plain),
                    (resample, "resample_fused_from_s",
                     fr.resample_fused_plain),
                    (fr, "resample_fused_from_s", fr.resample_fused_plain)])


def check_main_path(device, n=N, seed=7):
    """Phase 4: one counted run on ``device``; the same filter with the
    plain versions on ``device``, fed the same draws, must be bitwise
    equal; the same filter on the CPU, fed the same draws, must agree on
    the first resample and stay within LOG_ML_GAP of the log-ML. Returns
    (launches by kernel, a dict of what was seen)."""
    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
    rec = []
    out = run_filter(device, n, seed, record=rec)
    sync(device)
    launches = {name: fn.launches for name, fn in fns.items()}
    for name, count in launches.items():
        if count != T - 1:
            raise AssertionError(f"{name}: {count} launches on the main path, "
                                 f"expected {T - 1}")

    log_ml = float(out["log_ml"])
    anc = out["ancestors"]
    if not math.isfinite(log_ml):
        raise AssertionError(f"log_ml is not finite: {log_ml}")
    if out["state"].shape != (n, 2) or not bool(out["state"].isfinite().all()):
        raise AssertionError("final states: expected finite (N, 2) values")
    if anc.shape != (T - 1, n) or bool((anc[:, 1:] < anc[:, :-1]).any()):
        raise AssertionError("ancestors: expected sorted (T-1, N) indices")
    ess = out["ess"].double().cpu()
    if not bool(((ess > 0) & (ess <= n * (1 + 1e-5))).all()):
        raise AssertionError(f"ESS out of (0, N]: {ess.tolist()}")

    with plain_versions():
        plain = run_filter(device, n, seed, replay=rec)
    for what in ("log_ml", "ancestors", "state", "log_weights", "ess"):
        if not torch.equal(out[what], plain[what]):
            raise AssertionError(f"main path: {what} differs from the same "
                                 f"filter through the plain versions")

    replay = [(None if u is None else u.cpu(),
               {a: v.cpu() for a, v in pool.items()}) for u, pool in rec]
    cpu = run_filter("cpu", n, seed, replay=replay)
    gap = abs(log_ml - float(cpu["log_ml"]))
    agree = (anc.cpu() == cpu["ancestors"]).double().mean(dim=1).tolist()
    seen = {"log_ml": log_ml, "log_ml_cpu": float(cpu["log_ml"]),
            "log_ml_gap": gap, "parent_agreement": agree}
    if gap > LOG_ML_GAP:
        raise AssertionError(f"log_ml GPU {log_ml} vs CPU "
                             f"{float(cpu['log_ml'])}: gap {gap}")
    if agree[0] < FIRST_STEP_AGREEMENT:
        raise AssertionError(f"first resample: GPU and CPU ancestors agree "
                             f"on only {agree[0]} of the slots")
    return launches, seen


def time_filter(n=N, runs=5):
    """Median seconds of one filter on the card after one warm-up run."""
    run_filter("cuda", n, 100, store_ancestry=False)
    torch.cuda.synchronize()
    times = []
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_filter("cuda", n, 101 + i, store_ancestry=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not math.isfinite(float(out["log_ml"])):
            raise AssertionError("timed run: log_ml is not finite")
    return statistics.median(times), times


# GPU clock cycles the card sleeps before each timed launch (~1 ms)
SLEEP_CYCLES = 2_000_000


def time_ms(fn, reps=20, warmup=3):
    """Median device ms of ``fn`` with L2 flushed before each launch. The
    card sleeps after the flush, so the host has queued ``fn``'s launches
    before the start event runs: the time is the device's, not the
    wrapper's Python (which a small kernel would otherwise wait for)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def time_kernels(n=N):
    """(kernel ms, plain ms, library ms, bound ms) per kernel at the main
    path's shapes. The library call is the one PyTorch call closest to the
    kernel's work, timed as a yardstick only (the port never calls it):
    torch.cumsum of the rows, torch.cummax of the unscanned positions,
    torch.searchsorted for the ancestors' rank step. The bound is the
    kernel's bytes (each input read once, each output written once) over
    3.35 TB/s."""
    from modppl_tpu_torch.ops import fused_resample as fr
    from modppl_tpu_torch.ops import grid_positions as gp
    from modppl_tpu_torch.parallel import sharded_smc as smc

    lw = make_lw("uniform", n, 0, "cuda")
    rows, m = lw.reshape(-1, smc._cdf_block(n)), lw.max()
    cum, totals, _ = gp.stats_cumsum_plain(rows, m)
    offs_incl = gp.doubling_cumsum(totals[None, :])[0]
    offs = torch.cat([totals.new_zeros(1), offs_incl[:-1]])
    total = offs_incl[-1]
    u = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    s, _, _ = smc._det_grid_positions(u, lw, n)
    state = torch.randn(n, 2, device="cuda")
    s_unscanned = torch.clamp(torch.ceil(((cum + offs[:, None]) / total) * n
                                         - u), 0, n).to(torch.int32)
    slots = torch.arange(n, dtype=torch.int32, device="cuda")
    library = {
        "stats_cumsum": lambda: torch.cumsum(rows, dim=1),
        "positions_cummax": lambda: torch.cummax(s_unscanned, dim=1),
        "resample_fused_from_s": lambda: torch.searchsorted(s, slots,
                                                            right=True),
    }
    nb = rows.shape[0]
    nbytes = {"stats_cumsum": 4 * (2 * n + 2 * nb),
              "positions_cummax": 4 * (2 * n + 2 * nb + 2),
              "resample_fused_from_s": 4 * n * (2 + 2 * state.shape[1])}
    pairs = {
        "stats_cumsum": (lambda: gp.stats_cumsum(rows, m),
                         lambda: gp.stats_cumsum_plain(rows, m)),
        "positions_cummax": (
            lambda: gp.positions_cummax(cum, offs, total, u, n),
            lambda: gp.positions_cummax_plain(cum, offs, total, u, n)),
        "resample_fused_from_s": (
            lambda: fr.resample_fused_from_s(s, state, layout="nc"),
            lambda: fr.resample_fused_plain(s, state, layout="nc")),
    }
    out = {}
    for name, (kernel, plain) in pairs.items():
        # turns: plain, kernel, kernel, plain; each reported as its median
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                          time_ms(plain))
        out[name] = (statistics.median([k1, k2]), statistics.median([p1, p2]),
                     time_ms(library[name]), nbytes[name] / 3.35e12 * 1e3)
    return out


def profile_run(label, fn, median_s):
    """Device time of one run of ``fn`` by kernel and copy, and the
    device's idle share of the unprofiled median wall time ``median_s``.
    Each kernel the launch counters saw in the run is looked up in the
    profile by its CUDA symbol (``KERNEL_SYMBOLS``) and printed with its
    device time per profiled launch. If one has no row, the trace is
    incomplete: the line names it and gives no idle share."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, launches = counted(fn)
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    found = {name: [r for r in rows
                    if re.search(rf"\b{KERNEL_SYMBOLS[name]}\b", r[0])]
             for name, count in launches.items() if count}
    missing = [f"{KERNEL_SYMBOLS[name]} ({name}, {launches[name]} launches)"
               for name, hits in found.items() if not hits]
    copies = sum(r[2] for r in rows if "DtoH" in r[0])
    head = (f"# profile {label}: {sum(r[2] for r in rows)} device ops, "
            f"{copies} device-to-host copies, busy {busy_ms:.3f} ms of a "
            f"{median_s * 1e3:.3f} ms run")
    if missing:
        print(f"{head}; trace incomplete, no rows for {', '.join(missing)}: "
              f"no idle share")
    else:
        print(f"{head}: idle share {1 - busy_ms / (median_s * 1e3):.3f}")
    for name, hits in found.items():
        ms, count = sum(r[1] for r in hits), sum(r[2] for r in hits)
        if count:
            print(f"#   kernel {name}: {launches[name]} launches counted, "
                  f"{count} profiled, {ms:.3f} ms, {ms / count * 1e3:.2f} us "
                  f"a launch")
    for key, ms, count in rows[:15]:
        print(f"#   {ms:8.3f} ms  x{count:<4d} {key[:100]}")


# --------------------------------------------------------------------------
# slice 2: pooled-adaptation HMC on quadratic targets
# --------------------------------------------------------------------------

# the reference's two HMC legs (bench.py:65-125, 190-243) at full width
LEGS = {
    "hierarchical": dict(dim=3, num_chains=10_000, num_warmup=300,
                         num_samples=500, num_leapfrog=8),
    "illcond": dict(dim=128, num_chains=4096, num_warmup=300,
                    num_samples=256, num_leapfrog=32),
}
LEG_KERNELS = {"hierarchical": ("hmc_warmup_chunk_small",
                                "hmc_sample_chunk_small"),
               "illcond": ("hmc_warmup_chunk", "hmc_sample_chunk")}
# d >= 13 kernels vs their plain versions, the pass criteria, each value x
# against the plain version's y as |x - y| <= tol (1 + |y|):
# - sampling with forced accepts (u01 = -1), 8 transitions of 32 leapfrog
#   steps: positions, logp and aprob within POS_TOL, divergent flags equal;
# - sampling with real uniforms: accept decisions equal on >=
#   DECISION_AGREEMENT of (chain, transition) pairs, and on every chain whose
#   decisions all agree, positions, logp and aprob within POS_TOL and the
#   divergent flags equal;
# - warmup, 300 iterations: eps and inv_mass within ADAPT_TOL relative, the
#   final positions within ADAPT_TOL on >= WARMUP_CHAIN_AGREEMENT of the
#   chains (a chain whose accept decision flips in any iteration parts from
#   its twin, and every chain moves with eps and inv_mass).
# The plain versions take the kernels' arithmetic order today, so the
# results are also bitwise (and reported so); the tolerances leave room for
# a product in another order (tensor cores), since the dot-product order is
# the kernel's own.
POS_TOL = 1e-4
DECISION_AGREEMENT = 0.999
ADAPT_TOL = 1e-3
WARMUP_CHAIN_AGREEMENT = 0.99
WIDE_DIMS = ((13, 1024), (64, 1024), (128, 4096), (160, 1024))
# the iterations of each WIDE_DIMS warmup check: a fast phase, two slow
# windows and the last fast phase (300 before, cut to keep the script
# inside its time limit)
WIDE_WARMUP = 100
# the widest d the d >= 13 kernels take, sampling only with forced accepts:
# (d, chains)
WIDEST = (224, 1024)
# the d >= 13 warmup with more tiles than the card holds at once (blocks
# walk several tiles) and more than 256 tile partials (pooled through
# shared memory): (d, chains, iterations)
MANY_CHAINS = (13, 20_000, 60)
# the d <= 12 pair's bitwise checks: (d, chains, sampling T, warmup T)
SMALL_CASES = ((3, 10_000, 500, 300), (12, 10_000, 20, 60))
# the d <= 12 sampling kernel alone, bitwise, at the edges of its launch
# (csrc/hmc_small.cu): (d, chains, T). 10 007 chains leave a partial last
# block; T = 1 and 3 are shorter than its stream ring, T = 40 wraps it
# several times; d = 8 is the widest with Λ in registers, d = 12 the widest.
SAMPLE_CASES = ((1, 10_007, 40), (3, 10_007, 1), (5, 10_007, 40),
                (8, 10_007, 3), (8, 10_007, 40), (12, 10_007, 40))
# the d <= 12 warmup over more than 256 tile partials of 256 chains, pooled
# through shared memory (reduce_partials), bitwise: (d, chains, warmup T).
# At d = 12 there are more tiles than blocks fit on the card at once, so
# blocks walk several tiles and the positions go through device memory.
MANY_SMALL = ((3, 100_000, 60), (12, 200_000, 20))


def hmc_wrappers():
    from modppl_tpu_torch.ops import leapfrog, leapfrog_small

    return {"hmc_warmup_chunk_small": leapfrog_small.warmup_chunk_small,
            "hmc_sample_chunk_small": leapfrog_small.sample_chunk_small,
            "hmc_warmup_chunk": leapfrog.warmup_chunk,
            "hmc_sample_chunk": leapfrog.sample_chunk}


@contextlib.contextmanager
def full_fp32():
    """Any matmul of the plain versions in full float32 (no TF32), stated
    explicitly."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def quad_problem(d, n, seed, device):
    """A well-conditioned quadratic target (Λ = A Aᵀ / d + I, b), a positive
    inverse mass and start points, float32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    return (f32(a @ a.T / d + np.eye(d)), f32(rng.standard_normal(d)),
            f32(0.5 + rng.random(d)), f32(rng.standard_normal((n, d))))


def hold_close(errs, name, what, got, want, tol, chains=None):
    """Every element of ``got`` within tol * (1 + |want|) of ``want`` (a
    bool output equal), over the chains where ``chains`` (a mask over
    axis 1, the chain axis of a (T, N[, d]) output) is true; the largest
    difference goes into ``errs``."""
    if chains is not None:
        got, want = got[:, chains], want[:, chains]
    if got.dtype == torch.bool:
        err = 0.0 if torch.equal(got, want) else 1.0
        ok = err == 0.0
    else:
        diff = torch.where(got == want, 0.0, (got.double() - want.double())
                           .abs())
        err = float(diff.max()) if diff.numel() else 0.0
        ok = bool((diff <= tol * (1 + want.double().abs())).all())
    errs.max[name] = max(errs.max.get(name, 0.0), err)
    if not ok:
        raise AssertionError(f"{name}: {what} differs from the plain version "
                             f"by {err} (limit {tol} relative)")


def _twice(name, fn):
    """Run a kernel twice on the same inputs; the results must be bitwise
    equal (no atomics, fixed reduction orders)."""
    first, second = fn(), fn()
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two runs on the same inputs differ")
    return first


def check_hmc_kernels(device):
    """The four HMC kernels against their plain versions on the card."""
    from modppl_tpu_torch.ops import leapfrog as lf
    from modppl_tpu_torch.ops import leapfrog_small as lfs

    errs = Errors()
    f32 = torch.float32
    # d <= 12: bitwise, at the hierarchical leg's width (full T at d = 3)
    for d, n, t_s, t_w in SMALL_CASES:
        lam, b, im, u0 = quad_problem(d, n, d, device)
        z, jit, u01 = lfs.phase_draws(d, t_s, n, d, f32, device)
        args = (u0, z / torch.sqrt(im), 0.3 * jit, u01, lam, b, im, 8)
        got = _twice("hmc_sample_chunk_small",
                     lambda: lfs.sample_chunk_small(*args))
        want = lfs.sample_chunk_small_plain(*args)
        for what, x, y in zip(("us", "logp", "aprob", "divergent"), got, want):
            errs.same("hmc_sample_chunk_small", f"{what} (d={d}, T={t_s})",
                      x, y)
        z, jit, u01 = lfs.phase_draws(100 + d, t_w, n, d, f32, device)
        args = (u0, z, jit, u01, lam, b, 0.1, 8)
        got = _twice("hmc_warmup_chunk_small",
                     lambda: lfs.warmup_chunk_small(*args))
        want = lfs.warmup_chunk_small_plain(*args)
        for what, x, y in zip(("us", "eps", "inv_mass"), got, want):
            errs.same("hmc_warmup_chunk_small", f"{what} (d={d}, T={t_w})",
                      x, y)
        sync(device)
    for d, n, t_s in SAMPLE_CASES:
        lam, b, im, u0 = quad_problem(d, n, 500 + d, device)
        z, jit, u01 = lfs.phase_draws(600 + 10 * d + t_s, t_s, n, d, f32,
                                      device)
        args = (u0, z / torch.sqrt(im), 0.3 * jit, u01, lam, b, im, 8)
        got = _twice("hmc_sample_chunk_small",
                     lambda: lfs.sample_chunk_small(*args))
        want = lfs.sample_chunk_small_plain(*args)
        for what, x, y in zip(("us", "logp", "aprob", "divergent"), got, want):
            errs.same("hmc_sample_chunk_small", f"{what} (d={d}, N={n}, "
                      f"T={t_s})", x, y)
        sync(device)
    for d, n, t_w in MANY_SMALL:
        lam, b, _, u0 = quad_problem(d, n, 300 + d, device)
        z, jit, u01 = lfs.phase_draws(400 + d, t_w, n, d, f32, device)
        args = (u0, z, jit, u01, lam, b, 0.1, 8)
        got = _twice("hmc_warmup_chunk_small",
                     lambda: lfs.warmup_chunk_small(*args))
        want = lfs.warmup_chunk_small_plain(*args)
        for what, x, y in zip(("us", "eps", "inv_mass"), got, want):
            errs.same("hmc_warmup_chunk_small", f"{what} (d={d}, N={n}, "
                      f"T={t_w})", x, y)
        sync(device)

    # d >= 13: every output to the stated tolerances, at the illcond leg's
    # L = 32; the plain versions take the kernels' arithmetic order, so the
    # results are also reported as bitwise equal or not
    agree, bitwise = {}, {}
    with full_fp32():
        for d, n in WIDE_DIMS:
            lam, b, im, u0 = quad_problem(d, n, d, device)
            z, jit, u01 = lfs.phase_draws(d, 8, n, d, f32, device)
            mom, epsj = z / torch.sqrt(im), 0.1 * jit
            forced = torch.full_like(u01, -1.0)
            got = _twice("hmc_sample_chunk", lambda: lf.sample_chunk(
                u0, mom, epsj, forced, lam, b, im, 32))
            want = lf.sample_chunk_plain(u0, mom, epsj, forced, lam, b, im, 32)
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            for what, x, y in zip(("us", "logp", "aprob", "divergent"),
                                  got, want):
                hold_close(errs, "hmc_sample_chunk", f"forced-accept {what} "
                           f"(d={d})", x, y, POS_TOL)
            got = lf.sample_chunk(u0, mom, epsj, u01, lam, b, im, 32)
            want = lf.sample_chunk_plain(u0, mom, epsj, u01, lam, b, im, 32)
            same &= all(torch.equal(x, y) for x, y in zip(got, want))
            decided = (u01 < got[2]) == (u01 < want[2])
            agree[d] = float(decided.double().mean())
            if agree[d] < DECISION_AGREEMENT:
                raise AssertionError(f"hmc_sample_chunk: accept decisions "
                                     f"agree on {agree[d]} at d={d}")
            # a chain whose decisions all agree took the same moves
            for what, x, y in zip(("us", "logp", "aprob", "divergent"),
                                  got, want):
                hold_close(errs, "hmc_sample_chunk", f"{what} (d={d})", x, y,
                           POS_TOL, chains=decided.all(dim=0))
            z, jit, u01 = lfs.phase_draws(100 + d, WIDE_WARMUP, n, d, f32,
                                          device)
            same &= hold_warmup(errs, d, lf, (u0, z, jit, u01, lam, b, 0.1,
                                              32))
            bitwise[d] = same
            sync(device)
        # the widest d: 8 forced-accept transitions, within POS_TOL
        d, n = WIDEST
        lam, b, im, u0 = quad_problem(d, n, d, device)
        z, jit, _ = lfs.phase_draws(d, 8, n, d, f32, device)
        args = (u0, z / torch.sqrt(im), 0.1 * jit,
                torch.full_like(jit, -1.0), lam, b, im, 32)
        got = _twice("hmc_sample_chunk", lambda: lf.sample_chunk(*args))
        want = lf.sample_chunk_plain(*args)
        bitwise[d] = all(torch.equal(x, y) for x, y in zip(got, want))
        for what, x, y in zip(("us", "logp", "aprob", "divergent"),
                              got, want):
            hold_close(errs, "hmc_sample_chunk", f"forced-accept {what} "
                       f"(d={d})", x, y, POS_TOL)
        sync(device)
        d, n, t_w = MANY_CHAINS
        lam, b, _, u0 = quad_problem(d, n, d, device)
        z, jit, u01 = lfs.phase_draws(200 + d, t_w, n, d, f32, device)
        bitwise[f"{d}, N={n}"] = hold_warmup(
            errs, d, lf, (u0, z, jit, u01, lam, b, 0.1, 32))
        sync(device)
    check_divergent_isolation(device)
    return errs.max, agree, bitwise


def hold_warmup(errs, d, lf, args):
    """The d >= 13 warmup, run twice, against its plain version: eps and
    inv_mass within ADAPT_TOL relative, the final positions within ADAPT_TOL
    on >= WARMUP_CHAIN_AGREEMENT of the chains. Returns whether all three
    outputs are bitwise equal."""
    got = _twice("hmc_warmup_chunk", lambda: lf.warmup_chunk(*args))
    want = lf.warmup_chunk_plain(*args)
    for what, x, y in (("eps", got[1], want[1]),
                       ("inv_mass", got[2], want[2])):
        rel = float(((x - y).abs() / y.abs()).max())
        errs.max["hmc_warmup_chunk"] = max(
            errs.max.get("hmc_warmup_chunk", 0.0),
            float((x - y).abs().max()))
        if rel > ADAPT_TOL:
            raise AssertionError(f"hmc_warmup_chunk: {what} off by {rel} "
                                 f"relative at d={d}")
    err = (got[0] - want[0]).abs()
    errs.max["hmc_warmup_chunk"] = max(errs.max["hmc_warmup_chunk"],
                                       float(err.max()))
    near = float((err <= ADAPT_TOL * (1 + want[0].abs())).all(dim=1)
                 .double().mean())
    if near < WARMUP_CHAIN_AGREEMENT:
        raise AssertionError(f"hmc_warmup_chunk: final positions within "
                             f"{ADAPT_TOL} on only {near} of the chains at "
                             f"d={d}")
    return all(torch.equal(x, y) for x, y in zip(got, want))


def check_divergent_isolation(device):
    """A chain whose energy overflows float32 is flagged divergent and held
    at its start; every other chain is bitwise what it is without it."""
    from modppl_tpu_torch.ops import leapfrog as lf
    from modppl_tpu_torch.ops import leapfrog_small as lfs

    lam, b, im, u_ok = quad_problem(20, 8, 0, device)
    u_bad = u_ok.clone()
    u_bad[0] = 1e20
    draws = lfs.phase_draws(3, 3, 8, 20, torch.float32, device)
    ok = lf.hmc_sample_chunk(None, u_ok, 0.1, lam, b, im, 3, 4, draws=draws)
    bad = lf.hmc_sample_chunk(None, u_bad, 0.1, lam, b, im, 3, 4, draws=draws)
    if not bool(bad[3][:, 0].any()) or not bool(bad[0][:, 0].isfinite().all()):
        raise AssertionError("divergent chain: not flagged or not held")
    for x, y in zip(ok, bad):
        if not torch.equal(x[:, 1:], y[:, 1:]):
            raise AssertionError("divergent chain: another chain changed")


def hierarchical_data(device):
    """bench.py:78-84: 10 points on [-1, 1], a quadratic signal plus noise
    from numpy seed 0, float32."""
    from modppl_tpu_torch.models.hierarchical_static import NOISE

    xs = np.linspace(-1.0, 1.0, 10).astype(np.float32)
    ys = (0.3 + 0.5 * xs - 0.8 * xs * xs + NOISE
          * np.random.default_rng(0).standard_normal(10)).astype(np.float32)
    return (torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device))


def make_leg(name, device):
    """The leg's runner through the user's entry point, ``hmc_runner``."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.hmc import hmc_runner

    cfg = {k: v for k, v in LEGS[name].items() if k != "dim"}
    if name == "hierarchical":
        from modppl_tpu_torch.models.hierarchical_static import (
            make_hierarchical_static,
        )

        xs, ys = hierarchical_data(device)
        return hmc_runner(make_hierarchical_static(10), (xs,),
                          Trie.from_dict({"ys": ys, "is_linear": False}),
                          setup_key=99, device=device, **cfg)
    from modppl_tpu_torch.models.illcond_gauss import make_illcond_gauss

    return hmc_runner(make_illcond_gauss(128, 1e4), (), Trie(),
                      setup_key=99, device=device, **cfg)


def check_leg(name, out):
    """Fused path, self-check, and the posterior within the reference
    tests' bounds (test_combinators.py:103-104 for the hierarchical
    coefficients; test_leapfrog_pallas.py:322-323 for the Gaussian)."""
    if not (out["fused_quadratic"] and bool(out["quad_check_ok"])):
        raise AssertionError(f"{name}: fused path not taken or its "
                             f"self-check failed")
    us = out["unconstrained"].double().cpu().numpy()
    if not np.isfinite(us).all():
        raise AssertionError(f"{name}: non-finite draws")
    if not posterior_ok(name, us.reshape(-1, us.shape[-1])):
        raise AssertionError(f"{name}: posterior moments out of bounds")


def posterior_ok(name, flat):
    """The draws ``flat`` (draws, d) within the reference tests' bounds of
    the leg's exact posterior."""
    if name == "hierarchical":
        from modppl_tpu_torch.models.hierarchical_static import (
            exact_hierarchical_posterior,
        )

        xs, ys = (x.cpu().numpy() for x in hierarchical_data("cpu"))
        _, _, _, mean, cov, _ = exact_hierarchical_posterior(xs, ys)
        sd = np.sqrt(np.diag(cov))
        ok = (np.abs(flat.mean(0) - mean).max() <= 0.03
              and np.abs(flat.std(0) / sd - 1).max() <= 0.3)
    else:
        from modppl_tpu_torch.models.illcond_gauss import illcond_cov

        var = np.diag(illcond_cov(128, 1e4)).astype(np.float64)
        ok = (np.abs(flat.mean(0)).max() <= 0.05
              and np.abs(flat.var(0) / var - 1).max() <= 0.15)
    return bool(ok)


def check_hmc_main_path(device="cuda"):
    """Both legs once through hmc_runner with the counters at 0 just before
    each: each of its two kernels must launch exactly once, the other
    leg's not at all."""
    fns = hmc_wrappers()
    launches, outs = {}, {}
    for name in LEGS:
        run = make_leg(name, device)
        for fn in fns.values():
            fn.launches = 0
        outs[name] = run(0)
        sync(device)
        counts = {k: fn.launches for k, fn in fns.items()}
        for k, c in counts.items():
            want = 1 if k in LEG_KERNELS[name] else 0
            if c != want:
                raise AssertionError(f"{name}: {k} launched {c} times, "
                                     f"expected {want}")
        for k in LEG_KERNELS[name]:
            launches[k] = counts[k]
        check_leg(name, outs[name])
    return launches, outs


def time_leg(name, reps=3):
    """bench.py's measure: the median wall time of ``reps`` runs after a
    warm-up, and min-coordinate ESS (ess_autocorr per coordinate) of the
    last run. Returns (median s, times, ess_min, ess_median, accept)."""
    from modppl_tpu_torch.utils.diagnostics import ess_autocorr

    run = make_leg(name, "cuda")
    run(0)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        out = run(i + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    us = out["unconstrained"].double().cpu().numpy()
    ess = np.array([ess_autocorr(us[:, :, j]) for j in range(us.shape[-1])])
    return (statistics.median(times), times, float(ess.min()),
            float(np.median(ess)), float(out["accept_prob"].mean()))


def leg_inputs(name):
    """The kernels' inputs at a leg's shapes, with random draws."""
    from modppl_tpu_torch.ops import leapfrog_small as lfs

    c = LEGS[name]
    d, n = c["dim"], c["num_chains"]
    lam, b, im, u0 = quad_problem(d, n, 7, "cuda")
    warm = lfs.phase_draws(1, c["num_warmup"], n, d, torch.float32, "cuda")
    z, jit, u01 = lfs.phase_draws(2, c["num_samples"], n, d, torch.float32,
                                  "cuda")
    samp = (u0, z / torch.sqrt(im), 0.1 * jit, u01, lam, b, im,
            c["num_leapfrog"])
    return (u0, *warm, lam, b, 0.1, c["num_leapfrog"]), samp


def hmc_bounds(name):
    """Per phase of a leg: (bound ms, "bytes" or "operations"): the larger
    of (bytes read once + written once) / 3.35 TB/s and FP32 flops /
    67 TFLOP/s (the H100's published peaks at 700 W). Flops per transition
    and chain, the least the function needs: (L + 1) gradients of 2 d^2,
    logp at both ends as u.(b + g)/2 from the gradient (4 d), and 7 d per
    leapfrog step (two momentum and one position multiply-add, b - uΛ)."""
    c = LEGS[name]
    d, n, L = c["dim"], c["num_chains"], c["num_leapfrog"]
    per = (L + 1) * 2 * d * d + 4 * d + 7 * d * L
    q = 4 * (d * d + 2 * d)   # Λ, b, inv_mass
    out = {}
    for phase, num in (("warmup", c["num_warmup"]),
                       ("sample", c["num_samples"])):
        streams = 4 * num * n * (d + 2)
        if phase == "warmup":
            nbytes = q + 4 * n * d + streams + 4 * n * d + 4 * (d + 1)
        else:
            nbytes = q + 4 * n * d + streams + num * n * (4 * d + 9)
        t_bytes, t_ops = nbytes / 3.35e12, num * n * per / 67e12
        out[phase] = (max(t_bytes, t_ops) * 1e3,
                      "bytes" if t_bytes >= t_ops else "operations")
    return out


def time_hmc_kernels():
    """(kernel ms, plain ms, bound ms, bound by) per HMC kernel at its
    leg's shapes, in turns (plain, kernel, kernel): each kernel turn the
    median of 5 launches, reported as the median of its two turns; the
    plain version one run (a plain run launches ~10^5-10^6 small ops, and
    kernels 6-7's take 22-25 s a run on the card, so a second plain turn
    is left out to keep the script inside its time)."""
    from modppl_tpu_torch.ops import leapfrog as lf
    from modppl_tpu_torch.ops import leapfrog_small as lfs

    pairs = {"hierarchical": (("hmc_warmup_chunk_small", lfs.warmup_chunk_small,
                               lfs.warmup_chunk_small_plain),
                              ("hmc_sample_chunk_small", lfs.sample_chunk_small,
                               lfs.sample_chunk_small_plain)),
             "illcond": (("hmc_warmup_chunk", lf.warmup_chunk,
                          lf.warmup_chunk_plain),
                         ("hmc_sample_chunk", lf.sample_chunk,
                          lf.sample_chunk_plain))}
    out = {}
    with full_fp32():
        for leg, kernels in pairs.items():
            warm, samp = leg_inputs(leg)
            bound = hmc_bounds(leg)
            for (name, kernel, plain), args, phase in zip(
                    kernels, (warm, samp), ("warmup", "sample")):
                p1 = time_ms(lambda: plain(*args), reps=1, warmup=0)
                k1 = time_ms(lambda: kernel(*args), reps=5, warmup=1)
                k2 = time_ms(lambda: kernel(*args), reps=5, warmup=1)
                out[name] = (statistics.median([k1, k2]), p1, *bound[phase])
            del warm, samp
    return out


# --------------------------------------------------------------------------
# slice 3: the HMM filter through grid_rank, fixed-step quadratic HMC
# --------------------------------------------------------------------------

# the reference's quantitative SMC gate (tests/test_vsmc.py:29-40) at the
# headline width: 2^20 particles, T = 10 observations drawn from the HMM
HMM_PRIOR = (0.2, 0.3, 0.5)
HMM_EMISSION = ((0.1, 0.2, 0.7), (0.2, 0.7, 0.1), (0.7, 0.2, 0.1))  # .T
HMM_TRANSITION = ((0.4, 0.4, 0.2), (0.2, 0.3, 0.5), (0.9, 0.05, 0.05))  # .T
HMM_LOG_ML_GAP = 0.03
HMM_ADAPTIVE_GAP = 0.05
# grid_rank's bitwise checks; 100003 is not a multiple of 1024. On the
# edge S (all 0, all N) both rank kernels are held
RANK_SIZES = (1 << 20, 1 << 16, 100_003)
EDGE_S = ("zeros", "all_num")
# grid_rank with m entries of S over num slots, m != num: (m, num), n_in = m
RANK_M_NUM = ((3000, 5000), (7000, 2500), (700, 2100), (2100, 700))
# hmc_quadratic on each leg's target, after its hmc_runner warmup: the
# kernel each transition launches
QUAD_KERNEL = {"hierarchical": "hmc_transition_small",
               "illcond": "fused_leapfrog"}
# hmc_transition_small's bitwise checks: (d, chains); 10 007 chains leave a
# partial last block
TRANSITION_CASES = ((3, 10_000), (7, 10_000), (1, 10_007), (5, 10_007))
# fused_leapfrog vs its plain version, bitwise, one call of L = 32 steps
# each: (d, chains). d = 3 is below the chunk kernels' range (the wrapper
# is public), d = 13 has padded coordinates and a partial last tile, and
# d = 224 is the widest d.
LEAPFROG_DIMS = ((3, 4096), (8, 4096), (13, 1000), (64, 4096),
                 (128, 4096), (224, 1024))


def hmm_arrays():
    """(prior, emission, transition) as float64 numpy arrays in the
    reference's conventions: emission[obs, state], transition[new, prev]."""
    return (np.array(HMM_PRIOR), np.array(HMM_EMISSION).T,
            np.array(HMM_TRANSITION).T)


def hmm_observations(num_steps, seed=0):
    """T observations drawn from the HMM with numpy.random.default_rng."""
    prior, emission, transition = hmm_arrays()
    rng = np.random.default_rng(seed)
    z, obs = rng.choice(3, p=prior), []
    for _ in range(num_steps):
        obs.append(int(rng.choice(3, p=emission[:, z])))
        z = rng.choice(3, p=transition[:, z])
    return obs


def run_hmm(device, n, seed, ess_threshold=1.0):
    """The HMM leg: vsmc.batched_particle_filter, systematic resampling,
    float32 weights and an int32 state, on ``device``."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.vsmc import batched_particle_filter
    from modppl_tpu_torch.interop import hmm_params_from_numpy
    from modppl_tpu_torch.models.hmm import hmm_scan_kernel

    params = hmm_params_from_numpy(*(a.astype(np.float32)
                                     for a in hmm_arrays()), device=device)
    obs = torch.tensor(hmm_observations(T), dtype=torch.int32, device=device)
    return batched_particle_filter(
        seed, hmm_scan_kernel(params),
        torch.zeros((), dtype=torch.float32, device=device),
        Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]}), n,
        resampling="systematic", ess_threshold=ess_threshold, auto_batch=True,
        device=device)


def run_spiral_vsmc(device, n, seed):
    """The spiral through vsmc.batched_particle_filter (not the sharded
    filter): a float32 state of two columns takes kernel 3."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.vsmc import batched_particle_filter
    from modppl_tpu_torch.models.spiral import (
        circle_observations,
        spiral_scan_kernel,
    )

    obs = torch.tensor(circle_observations(T), dtype=torch.float32,
                       device=device)
    return batched_particle_filter(
        seed, spiral_scan_kernel(), torch.zeros(2, dtype=torch.float32,
                                                device=device),
        Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]}), n,
        auto_batch=True, device=device)


def all_wrappers():
    from modppl_tpu_torch.ops import leapfrog, leapfrog_small, resample

    fns = {**wrappers(), **hmc_wrappers()}
    fns.update({"grid_rank": resample.grid_rank,
                "fused_leapfrog": leapfrog.fused_leapfrog,
                "hmc_transition_small": leapfrog_small.hmc_transition_small})
    return fns


def counted(fn):
    """Run ``fn`` with every kernel's launch counter at 0 just before it;
    returns (its result, the launches by kernel) read just after it."""
    fns = all_wrappers()
    for f in fns.values():
        f.launches = 0
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {k: f.launches for k, f in fns.items()}


def require_launches(what, launches, want):
    """Every kernel launched exactly ``want.get(name, 0)`` times."""
    for k, c in launches.items():
        if c != want.get(k, 0):
            raise AssertionError(f"{what}: {k} launched {c} times, expected "
                                 f"{want.get(k, 0)}")


def plain_grid_rank():
    """grid_rank's plain version in the kernel's place on the card (where
    ``ops.resample.systematic_parents`` calls it)."""
    from modppl_tpu_torch.ops import resample

    return swapped([(resample, "grid_rank", resample.grid_rank_plain)])


def check_slice3_kernels(device):
    """Phase (a): the three new kernels against their plain versions on the
    card, each run twice (bitwise equal); kernel 3 too on the edge S, and
    grid_rank too with m != num."""
    from modppl_tpu_torch.ops import leapfrog as lf
    from modppl_tpu_torch.ops import leapfrog_small as lfs
    from modppl_tpu_torch.ops import resample as rs

    errs, f32 = Errors(), torch.float32
    for n in RANK_SIZES:
        for seed, kind in enumerate(KINDS + EDGE_S):
            s = rank_s(kind, n, seed, device)
            got = _twice("grid_rank", lambda: (rs.grid_rank(s, n),))[0]
            errs.same("grid_rank", f"parents (N={n}, {kind})", got,
                      rs.grid_rank_plain(s, n))
            if kind == "degenerate" and int(got.unique().numel()) != 1:
                raise AssertionError("grid_rank: degenerate weights, expected "
                                     "a single ancestor")
            if kind in EDGE_S:
                check_gather(errs, s, kind, seed, device)
        sync(device)
    for m, num in RANK_M_NUM:
        for seed, kind in enumerate(KINDS + EDGE_S):
            s = rank_s(kind, m, seed, device, num)
            got = _twice("grid_rank", lambda: (rs.grid_rank(s, m, num),))[0]
            errs.same("grid_rank", f"parents (m={m}, num={num}, {kind})", got,
                      rs.grid_rank_plain(s, m, num))
        sync(device)
    for d, n in TRANSITION_CASES:
        lam, b, im, u0 = quad_problem(d, n, 30 + d, device)
        z, jit, u01 = lfs.phase_draws(40 + d, 1, n, d, f32, device)
        args = (u0, z[0] / torch.sqrt(im), 0.3 * jit[0], u01[0], lam, b, im, 8)
        got = _twice("hmc_transition_small",
                     lambda: _flat(lfs.hmc_transition_small(*args)))
        want = _flat(lfs.transition_small_plain(*args))
        for what, x, y in zip(("u_out", "p_end", "logp", "aprob", "divergent",
                               "h0", "h1"), got, want):
            errs.same("hmc_transition_small", f"{what} (d={d}, N={n})", x, y)
        sync(device)
    with full_fp32():
        for d, n in LEAPFROG_DIMS:
            lam, b, im, u0 = quad_problem(d, n, 50 + d, device)
            z, jit, _ = lfs.phase_draws(60 + d, 1, n, d, f32, device)
            args = (u0, z[0] / torch.sqrt(im), 0.1 * jit[0], lam, b, im, 32)
            got = _twice("fused_leapfrog", lambda: lf.fused_leapfrog(*args))
            want = lf.fused_leapfrog_plain(*args)
            for what, x, y in zip(("u_L", "p_L"), got, want):
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"fused_leapfrog: non-finite {what}")
                errs.same("fused_leapfrog", f"{what} (d={d}, N={n})", x, y)
            sync(device)
    return errs.max


def _flat(out):
    (u, p), *rest = out
    return (u, p, *rest)


def check_hmm_leg(device="cuda", n=N):
    """Phase (b): the HMM leg with the counters at 0: 9 launches of
    grid_rank and none of kernel 3, the log-ML within HMM_LOG_ML_GAP of the
    exact one, sorted ancestors, bitwise equal to the same filter through
    grid_rank's plain version; an ess_threshold = 0.5 run that skips at
    least one resample."""
    from modppl_tpu_torch.models.hmm import hmm_forward_log_ml

    exact = float(hmm_forward_log_ml(*hmm_arrays(), hmm_observations(T)))
    out, launches = counted(lambda: run_hmm(device, n, 13))
    require_launches("HMM leg", launches, {"grid_rank": T - 1})
    log_ml = float(out["log_ml"])
    if not math.isfinite(log_ml) or abs(log_ml - exact) > HMM_LOG_ML_GAP:
        raise AssertionError(f"HMM leg: log_ml {log_ml} vs exact {exact}")
    anc = out["ancestors"]
    if anc.shape != (T - 1, n) or bool((anc[:, 1:] < anc[:, :-1]).any()):
        raise AssertionError("HMM leg: expected sorted (T-1, N) ancestors")
    if out["state"].dtype != torch.int32 or out["log_weights"].shape != (n,):
        raise AssertionError("HMM leg: expected an int32 state and (N,) "
                             "weights")
    with plain_grid_rank():
        plain = run_hmm(device, n, 13)
    for what in ("log_ml", "ancestors", "state", "log_weights", "ess",
                 "resampled"):
        if not torch.equal(out[what], plain[what]):
            raise AssertionError(f"HMM leg: {what} differs from the same "
                                 f"filter through grid_rank's plain version")
    adaptive = run_hmm(device, n, 14, ess_threshold=0.5)
    skipped = int((~adaptive["resampled"]).sum())
    gap_adaptive = abs(float(adaptive["log_ml"]) - exact)
    if skipped < 1 or gap_adaptive > HMM_ADAPTIVE_GAP:
        raise AssertionError(f"HMM leg, ess_threshold 0.5: {skipped} skipped "
                             f"resamples, log_ml gap {gap_adaptive}")
    return launches["grid_rank"], {"log_ml": log_ml, "exact": exact,
                                   "skipped": skipped,
                                   "gap_adaptive": gap_adaptive}


def check_spiral_vsmc(device="cuda", n=N):
    """Phase (c): the spiral's float32 state takes the fused arm: 9
    launches of kernel 3, none of grid_rank."""
    out, launches = counted(lambda: run_spiral_vsmc(device, n, 15))
    require_launches("spiral via vsmc", launches,
                     {"resample_fused_from_s": T - 1})
    if not math.isfinite(float(out["log_ml"])):
        raise AssertionError("spiral via vsmc: log_ml is not finite")
    return float(out["log_ml"])


def quad_leg(name, device="cuda"):
    """A leg's target after its hmc_runner warmup: (u0 = the last draws,
    Λ, b, the adapted inverse mass and step size)."""
    run = make_leg(name, device)
    out = run(0)
    lam, b = run.quadratic
    return (out["unconstrained"][:, -1, :].contiguous(), lam, b,
            out["inv_mass"], out["step_size"])


def run_quad(name, leg, key):
    from modppl_tpu_torch.ops.leapfrog import hmc_quadratic

    u0, lam, b, im, eps = leg
    c = LEGS[name]
    return hmc_quadratic(key, u0, lam, b, im, step_size=eps,
                         num_samples=c["num_samples"],
                         num_leapfrog=c["num_leapfrog"])


def check_quad_legs(legs):
    """Phase (d): hmc_quadratic on both legs with the counters at 0: one
    launch of the leg's kernel per transition and no other; the posterior
    within check_leg's bounds; no divergence at d = 3."""
    launches = {}
    for name, leg in legs.items():
        with full_fp32():
            out, counts = counted(lambda: run_quad(name, leg, 21))
        num = LEGS[name]["num_samples"]
        require_launches(f"hmc_quadratic {name}", counts,
                         {QUAD_KERNEL[name]: num})
        launches[QUAD_KERNEL[name]] = counts[QUAD_KERNEL[name]]
        us = out["samples"].double().cpu().numpy()
        if not np.isfinite(us).all() or not posterior_ok(
                name, us.reshape(-1, us.shape[-1])):
            raise AssertionError(f"hmc_quadratic {name}: posterior moments "
                                 f"out of bounds")
        if name == "hierarchical" and bool(out["divergences"].any()):
            raise AssertionError("hmc_quadratic hierarchical: divergences")
    return launches


def time_quad(name, leg, reps=3):
    """Median wall time of ``reps`` hmc_quadratic runs after a warm-up;
    min-coordinate ESS of the last; (median s, times, ess_min, accept)."""
    from modppl_tpu_torch.utils.diagnostics import ess_autocorr

    with full_fp32():
        run_quad(name, leg, 30)
        torch.cuda.synchronize()
        times = []
        for i in range(reps):
            t0 = time.perf_counter()
            out = run_quad(name, leg, 31 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    us = out["samples"].transpose(0, 1).double().cpu().numpy()
    ess = min(ess_autocorr(us[:, :, j]) for j in range(us.shape[-1]))
    return (statistics.median(times), times, float(ess),
            float(out["accept_prob"].mean()))


def time_hmm(n=N, runs=5):
    """Median seconds of one HMM filter on the card after a warm-up."""
    run_hmm("cuda", n, 100)
    torch.cuda.synchronize()
    times = []
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_hmm("cuda", n, 101 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not math.isfinite(float(out["log_ml"])):
            raise AssertionError("timed HMM run: log_ml is not finite")
    return statistics.median(times), times


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the larger of bytes / 3.35 TB/s and
    FP32 flops / 67 TFLOP/s."""
    t_bytes, t_ops = nbytes / 3.35e12, flops / 67e12
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_slice3_kernels():
    """(kernel ms, plain ms, library ms or None, bound ms, bound by) for the
    three new kernels at their main paths' shapes, in turns (plain, kernel,
    kernel, plain), each turn the median of CUDA-event launches with L2
    flushed before each (time_ms): grid_rank at N = 2^20,
    hmc_transition_small at the hierarchical leg's (10^4, 3) and L = 8,
    fused_leapfrog at the ill-conditioned leg's (4096, 128) and L = 32. The
    plain fused_leapfrog launches ~5000 small ops, so it gets one run a
    turn. Bounds count each input read once and each output written once,
    and the flops the function needs: per chain and transition (L + 1)
    gradients of 2 d^2, the Hamiltonians at both ends (3 d^2 + 7 d each for
    the single transition), 7 d per leapfrog step."""
    from modppl_tpu_torch.ops import leapfrog as lf
    from modppl_tpu_torch.ops import leapfrog_small as lfs
    from modppl_tpu_torch.ops import resample as rs
    from modppl_tpu_torch.utils.numerics import logsumexp, normalized_cdf

    out = {}
    lw = make_lw("uniform", N, 0, "cuda")
    s = rs.slot_positions(normalized_cdf(lw - logsumexp(lw)),
                          torch.tensor(0.37, device="cuda"), N)
    slots = torch.arange(N, dtype=torch.int32, device="cuda")
    cases = {"grid_rank": (lambda: rs.grid_rank(s, N),
                           lambda: rs.grid_rank_plain(s, N),
                           lambda: torch.searchsorted(s, slots, right=True),
                           bound(8 * N, 0), 20)}
    for name, (dim, n, L, kernel, plain) in {
            "hmc_transition_small": (3, 10_000, 8, lfs.hmc_transition_small,
                                     lfs.transition_small_plain),
            "fused_leapfrog": (128, 4096, 32, lf.fused_leapfrog,
                               lf.fused_leapfrog_plain)}.items():
        lam, b, im, u0 = quad_problem(dim, n, 70, "cuda")
        z, jit, u01 = lfs.phase_draws(71, 1, n, dim, torch.float32, "cuda")
        p0, eps = z[0] / torch.sqrt(im), 0.1 * jit[0]
        params = 4 * (dim * dim + 2 * dim)
        grads = (L + 1) * 2 * dim * dim + 7 * dim * L
        if name == "hmc_transition_small":
            args = (u0, p0, eps, u01[0], lam, b, im, L)
            nbytes = params + n * (4 * (4 * dim + 2) + 4 * 4 + 1)
            flops = n * (grads + 2 * (3 * dim * dim + 7 * dim))
            reps = 20
        else:
            args = (u0, p0, eps, lam, b, im, L)
            nbytes = params + n * (4 * (4 * dim + 1))
            flops = n * grads
            reps = 1
        cases[name] = (lambda k=kernel, a=args: k(*a),
                       lambda p=plain, a=args: p(*a), None,
                       bound(nbytes, flops), reps)
    with full_fp32():
        for name, (kernel, plain, library, (b_ms, by), reps) in cases.items():
            p1 = time_ms(plain, reps=reps, warmup=1)
            k1, k2 = time_ms(kernel), time_ms(kernel)
            p2 = time_ms(plain, reps=reps, warmup=1)
            out[name] = (statistics.median([k1, k2]),
                         statistics.median([p1, p2]),
                         None if library is None else time_ms(library),
                         b_ms, by)
    return out


# --------------------------------------------------------------------------
# slice 4: guided and rejuvenated SMC on the scalar linear-Gaussian SSM
# (bench.py:422-520, bench_smc_guided)
# --------------------------------------------------------------------------

LG_A, LG_Q, LG_R = 0.9, 0.5, 0.3
# the reference's gate for the guided filter (tests/test_batched_filter.py:
# 208), against the exact Kalman log-ML
LG_LOG_ML_GAP = 0.05
GUIDED_KERNELS = ("stats_cumsum", "positions_cummax", "resample_fused_from_s")
_LG_MODELS = {}


def lg_models():
    """(init, step, proposal) of the guided leg: the model of bench.py:
    434-446 and its locally optimal proposal (bench.py:447-453), one Gen
    each for the process."""
    if not _LG_MODELS:
        from modppl_tpu_torch.dists import normal
        from modppl_tpu_torch.modeling import gen

        a, q, r = LG_A, LG_Q, LG_R
        prec = 1.0 / q ** 2 + 1.0 / r ** 2

        @gen
        def lg_init(h, _s0):
            x = h.sample(normal, (0.0, 1.0), "x")
            h.sample(normal, (x, r), "y")
            return x

        @gen
        def lg_step(h, t, prev):
            x = h.sample(normal, (a * prev, q), "x")
            h.sample(normal, (x, r), "y")
            return x

        @gen
        def lg_prop(h, t, prev, cons):
            y = cons.read("y")
            m = (a * prev / q ** 2 + y / r ** 2) / prec
            h.sample(normal, (m, 1.0 / math.sqrt(prec)), "x")

        _LG_MODELS.update(init=lg_init, step=lg_step, prop=lg_prop)
    return _LG_MODELS["init"], _LG_MODELS["step"], _LG_MODELS["prop"]


def lg_observations(num_steps=T):
    """The leg's observations, drawn as bench.py:478-484 draws them, in
    float32."""
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal()]
    for _ in range(num_steps - 1):
        xs.append(LG_A * xs[-1] + LG_Q * rng.standard_normal())
    return np.array([x + LG_R * rng.standard_normal() for x in xs],
                    dtype=np.float32)


def lg_kalman_log_ml(ys):
    """Exact log p(y_1:T) of the scalar model, float64 numpy."""
    mu, var, total = 0.0, 1.0, 0.0
    for i, y in enumerate(np.asarray(ys, np.float64)):
        if i > 0:
            mu, var = LG_A * mu, LG_A * LG_A * var + LG_Q * LG_Q
        s = var + LG_R * LG_R
        total += -0.5 * (math.log(2 * math.pi * s) + (y - mu) ** 2 / s)
        k = var / s
        mu, var = mu + k * (y - mu), (1 - k) * var
    return total


def run_guided(device, n, seed, mesh=None, **kwargs):
    """The guided leg: sharded_batched_particle_filter with the locally
    optimal proposal and one regenerative move of "x" a step, float32, as
    bench_smc_guided calls it (over the dp shards of ``mesh``)."""
    from modppl_tpu_torch.core import Trie, select
    from modppl_tpu_torch.inference.vsmc import ScanKernel
    from modppl_tpu_torch.parallel.sharded_smc import (
        sharded_batched_particle_filter,
    )

    init, step, prop = lg_models()
    ys = torch.tensor(lg_observations(), device=device)
    return sharded_batched_particle_filter(
        mesh, seed, ScanKernel(init, step),
        torch.zeros((), dtype=torch.float32, device=device),
        Trie.from_dict({"y": ys[0]}), Trie.from_dict({"y": ys[1:]}), n,
        ess_threshold=1.0, auto_batch=True, store_ancestry=False,
        proposal=prop, rejuvenation=(select("x"), 1), device=device,
        **kwargs)


def check_guided_leg(device="cuda", n=N):
    """Phase 13: the guided leg with the counters at 0: 9 launches each of
    kernels 1, 2 and 3 and none of any other; a finite log-ML within
    LG_LOG_ML_GAP of the exact Kalman value; an overall acceptance of the
    moves strictly between 0 and 1; and every output bitwise equal to the
    same filter through the plain versions on the card, fed the run's
    recorded draws (resample uniforms, proposal draws, each move's draws
    and accept uniforms)."""
    exact = lg_kalman_log_ml(lg_observations())
    rec = []
    out, launches = counted(lambda: run_guided(device, n, 17, record=rec))
    require_launches("guided leg", launches,
                     {name: T - 1 for name in GUIDED_KERNELS})
    log_ml = float(out["log_ml"])
    if not math.isfinite(log_ml) or abs(log_ml - exact) > LG_LOG_ML_GAP:
        raise AssertionError(f"guided leg: log_ml {log_ml} vs exact {exact}")
    if out["state"].shape != (n,) or not bool(out["state"].isfinite().all()):
        raise AssertionError("guided leg: expected finite (N,) states")
    acceptance = float(out["acceptance"].double().mean())
    if not 0.0 < acceptance < 1.0:
        raise AssertionError(f"guided leg: acceptance {acceptance} is not "
                             f"in (0, 1)")
    if len(rec) != T or len(rec[1]) != 4 or len(rec[1][3]) != 1:
        raise AssertionError("guided leg: expected T record entries with a "
                             "proposal pool and one move a step")
    with plain_versions():
        plain = run_guided(device, n, 17, replay=rec)
    for what in ("log_ml", "state", "log_weights", "ess", "resampled",
                 "acceptance"):
        if not torch.equal(out[what], plain[what]):
            raise AssertionError(f"guided leg: {what} differs from the same "
                                 f"filter through the plain versions")
    return launches, {"log_ml": log_ml, "exact": exact,
                      "acceptance": acceptance,
                      "acceptance_by_step": out["acceptance"][:, 0].tolist()}


def time_guided(n=N, runs=5):
    """Median seconds of one guided filter on the card after a warm-up."""
    run_guided("cuda", n, 100)
    torch.cuda.synchronize()
    times = []
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_guided("cuda", n, 101 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not math.isfinite(float(out["log_ml"])):
            raise AssertionError("timed guided run: log_ml is not finite")
    return statistics.median(times), times


# --------------------------------------------------------------------------
# slice 5: the generic HMC path on Bayesian logistic regression
# --------------------------------------------------------------------------

# bench.py:128-185 (bench_hmc_nonquad) at full width: d = 16, n = 128,
# 10^4 chains, 300 + 500, L = 4, pooled adaptation; data from the port's
# simulate_logreg with seed 42, float32
LOGREG = dict(dim=16, n_data=128, num_chains=10_000, num_warmup=300,
              num_samples=500, num_leapfrog=4)
# the per-chain path on the same target: (chains, warmup, samples)
LOGREG_PER_CHAIN = (256, 200, 200)
# the posterior mean against the oracle: within LOGREG_MEAN_GAP or 4 Monte
# Carlo standard errors, whichever is larger (pooled leg); within
# LOGREG_PER_CHAIN_GAP (per-chain run)
LOGREG_MEAN_GAP = 0.05
LOGREG_PER_CHAIN_GAP = 0.1
# the oracle: self-normalised importance sampling, Laplace proposal with
# its covariance inflated LOGREG_INFLATE times, LOGREG_ORACLE_DRAWS draws
LOGREG_ORACLE_DRAWS = 1_000_000
LOGREG_INFLATE = 1.5


def logreg_data(device):
    """The leg's (X (128, 16), ys (128,)), float32, from seed 42."""
    from modppl_tpu_torch.models.logreg import simulate_logreg

    X, ys, _ = simulate_logreg(42, LOGREG["n_data"], LOGREG["dim"],
                               device=device)
    return X, ys


def make_logreg_leg(device, **overrides):
    """The leg's runner through the user's entry point, ``hmc_runner``."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.hmc import hmc_runner
    from modppl_tpu_torch.models.logreg import make_logreg

    cfg = {k: v for k, v in LOGREG.items() if k not in ("dim", "n_data")}
    cfg.update(overrides)
    return hmc_runner(make_logreg(LOGREG["dim"]), logreg_data(device), Trie(),
                      setup_key=99, device=device, **cfg)


def logreg_oracle(X, ys, draws=LOGREG_ORACLE_DRAWS, seed=0, chunk=100_000):
    """The posterior mean of w and its Monte Carlo standard error, by
    self-normalised importance sampling in float64 numpy, independent of
    the port: proposal N(w_map, LOGREG_INFLATE H^-1), w_map from
    ``map_newton`` and H the negative Hessian of the log posterior there;
    ``draws`` proposals from ``default_rng(seed)``. Returns (mean, se, the
    importance sampler's effective sample size, the log evidence log
    p(ys | X))."""
    from modppl_tpu_torch.models.logreg import map_newton

    X = np.asarray(X, np.float64)
    ys = np.asarray(ys, np.float64)
    d = X.shape[1]
    w_map = map_newton(X, ys)
    p = 1.0 / (1.0 + np.exp(-X @ w_map))
    chol = np.linalg.cholesky(
        LOGREG_INFLATE * np.linalg.inv((X.T * (p * (1 - p))) @ X + np.eye(d)))
    rng = np.random.default_rng(seed)
    log_w, ws = [], []
    for start in range(0, draws, chunk):
        z = rng.standard_normal((min(chunk, draws - start), d))
        w = w_map + z @ chol.T
        logits = w @ X.T
        # log sigmoid(x) = -log(1 + e^-x)
        loglik = -(ys * np.logaddexp(0.0, -logits)
                   + (1.0 - ys) * np.logaddexp(0.0, logits)).sum(1)
        # log posterior - log proposal, up to constants
        log_w.append(loglik - 0.5 * (w * w).sum(1) + 0.5 * (z * z).sum(1))
        ws.append(w)
    log_w, ws = np.concatenate(log_w), np.concatenate(ws)
    top = log_w.max()
    wt = np.exp(log_w - top)
    # the dropped constants: the prior's and the proposal's normalizers
    log_ev = (top + math.log(wt.sum() / draws)
              + float(np.log(np.diag(chol)).sum()))
    wt /= wt.sum()
    mean = wt @ ws
    se = np.sqrt((wt * wt) @ ((ws - mean) ** 2))
    return mean, se, float(1.0 / (wt * wt).sum()), log_ev


def logreg_summary(out):
    """(draws (chains, samples, d) float64 numpy, per-coordinate ESS)."""
    from modppl_tpu_torch.utils.diagnostics import ess_autocorr

    us = out["unconstrained"].double().cpu().numpy()
    return us, np.array([ess_autocorr(us[:, :, j])
                         for j in range(us.shape[-1])])


def check_logreg_leg(device="cuda"):
    """Phase 15: the leg with the counters at 0, through hmc_runner: no
    kernel launches, the generic path, finite outputs, the posterior mean
    within max(LOGREG_MEAN_GAP, 4 Monte Carlo standard errors) of the
    oracle; the same key again gives bitwise-equal draws, step size,
    inverse mass and accept probabilities. Then the per-chain path
    (``pooled_adaptation=False``) at LOGREG_PER_CHAIN: inv_mass (chains, d)
    and the posterior mean within LOGREG_PER_CHAIN_GAP. Returns (the
    pooled runner, what was seen)."""
    X, ys = logreg_data(device)
    oracle, oracle_se, oracle_ess, _ = logreg_oracle(X.cpu().numpy(),
                                                     ys.cpu().numpy())
    d = LOGREG["dim"]
    with full_fp32():
        run = make_logreg_leg(device)
        out, launches = counted(lambda: run(0))
        require_launches("logreg leg", launches, {})
        again = run(0)
    if out["fused_quadratic"] or not bool(out["quad_check_ok"]):
        raise AssertionError("logreg leg: expected the generic path")
    for what in ("unconstrained", "logp", "accept_prob", "step_size",
                 "inv_mass"):
        if not bool(torch.isfinite(out[what]).all()):
            raise AssertionError(f"logreg leg: {what} is not finite")
        if not torch.equal(out[what], again[what]):
            raise AssertionError(f"logreg leg: {what} differs between two "
                                 f"runs of the same key")
    us, ess = logreg_summary(out)
    flat = us.reshape(-1, d)
    mean = flat.mean(0)
    se = np.sqrt(flat.var(0) / ess + oracle_se ** 2)
    gap = np.abs(mean - oracle)
    allowed = np.maximum(LOGREG_MEAN_GAP, 4.0 * se)
    if us.shape != (LOGREG["num_chains"], LOGREG["num_samples"], d) or \
            not (gap <= allowed).all():
        raise AssertionError(f"logreg leg: posterior mean {mean} vs oracle "
                             f"{oracle} (gap {gap}, allowed {allowed})")
    chains, warm, samp = LOGREG_PER_CHAIN
    with full_fp32():
        per = make_logreg_leg(device, num_chains=chains, num_warmup=warm,
                              num_samples=samp, pooled_adaptation=False)(0)
    per_us = per["unconstrained"].double().cpu().numpy()
    per_gap = np.abs(per_us.reshape(-1, d).mean(0) - oracle)
    if per["inv_mass"].shape != (chains, d) or \
            per["step_size"].shape != (chains,) or \
            not np.isfinite(per_us).all() or \
            not (per_gap <= LOGREG_PER_CHAIN_GAP).all():
        raise AssertionError(f"logreg per-chain run: inv_mass "
                             f"{tuple(per['inv_mass'].shape)}, gap {per_gap}")
    return run, {"gap": float(gap.max()), "allowed": float(allowed.min()),
                 "oracle_se": float(oracle_se.max()),
                 "oracle_ess": oracle_ess, "per_chain_gap":
                 float(per_gap.max()), "eps": float(out["step_size"]),
                 "accept": float(out["accept_prob"].mean())}


def time_logreg_leg(run, reps=1, device="cuda"):
    """Phase 16: bench.py's measure on the runner phase 15 warmed up: the
    median wall time of ``reps`` runs (one by default: the script's time
    went to the NUTS leg), keys 1..reps, and min-coordinate ESS of the
    last. Returns (median s, times, ess_min, ess_median, accept,
    eps)."""
    times = []
    with full_fp32():
        for i in range(reps):
            sync(device)
            t0 = time.perf_counter()
            out = run(i + 1)
            sync(device)
            times.append(time.perf_counter() - t0)
    _, ess = logreg_summary(out)
    return (statistics.median(times), times, float(ess.min()),
            float(np.median(ess)), float(out["accept_prob"].mean()),
            float(out["step_size"]))


def time_logreg_vag(calls=50, reps=3, device="cuda"):
    """Wall ms of one batched value-and-grad call of the leg's target at
    its 10^4 chains, the call each leapfrog step makes: the median over
    ``reps`` batches of ``calls`` back-to-back calls, each batch ended by a
    synchronize."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.hmc import (
        _value_and_grad,
        make_unconstrained_logprob,
        ravel_latents,
    )
    from modppl_tpu_torch.models.logreg import make_logreg

    args, model = logreg_data(device), make_logreg(LOGREG["dim"])
    tr, _ = model.generate(99, args, Trie())
    logprob, u0, _, _ = make_unconstrained_logprob(model, args, tr, Trie(),
                                                   device=device)
    _, unravel = ravel_latents(u0)
    vag = _value_and_grad(lambda u: logprob(unravel(u)))
    U = torch.randn((LOGREG["num_chains"], LOGREG["dim"]),
                    generator=torch.Generator(device).manual_seed(0),
                    device=device)
    times = []
    with full_fp32():
        vag(U)
        for _ in range(reps):
            sync(device)
            t0 = time.perf_counter()
            for _ in range(calls):
                vag(U)
            sync(device)
            times.append((time.perf_counter() - t0) / calls * 1e3)
    return statistics.median(times), times


# --------------------------------------------------------------------------
# slice 6: importance sampling, Metropolis-Hastings, the eager filter
# --------------------------------------------------------------------------

# the reference tests' strongly quadratic data (tests/test_importance.py:
# 105-110): y = 0.3 + 0.4 x + 0.5 x^2 at five points
IS_XS = (-2.0, -1.0, 0.0, 1.0, 2.0)
IS_YS = tuple(0.3 + 0.4 * x + 0.5 * x * x for x in IS_XS)
# phase 17: lanes of the batched leg, indices resampled from it, samples of
# the eager leg; the gates are at IS_SE Monte Carlo standard errors and
# need an ESS of IS_MIN_ESS
IS_LANES = 1 << 24
IS_RESAMPLED = 1 << 16
IS_EAGER_SAMPLES = 300
IS_SE = 4.0
IS_MIN_ESS = 100.0
IS_P_LINEAR_MAX = 1e-3
# phase 18: rounds of (one jump, MH_DRIFTS drifts, one regenerative move),
# the first MH_BURN dropped; the kept rounds quadratic in MH_QUAD_SHARE of
# them and their mean coefficients within MH_MEAN_GAP of the exact
# posterior mean; the conjugate chain's regen_mh steps and bounds
MH_ROUNDS, MH_BURN, MH_DRIFTS, MH_DRIFT = 1000, 200, 3, 0.05
MH_QUAD_SHARE = 0.99
MH_MEAN_GAP = 0.05
MH_TIMED_ROUNDS = 50
CONJ_STEPS, CONJ_BURN, CONJ_GAP = 4000, 500, 0.08
# phase 19: the reference tests' eager filters (particles, data) and gates
PF_HMM_PARTICLES, PF_HMM_DATA, PF_HMM_GAP = 300, (0, 0, 1, 2), 0.25
PF_SPIRAL_PARTICLES, PF_SPIRAL_STEPS, PF_SPIRAL_GAP = 100, 12, 0.2


def is_inputs(device):
    """The importance leg's (model, args, observations) on ``device``."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.models.hierarchical_static import (
        make_hierarchical_static,
    )

    xs = torch.tensor(IS_XS, dtype=torch.float32, device=device)
    ys = torch.tensor(IS_YS, dtype=torch.float32, device=device)
    return (make_hierarchical_static(len(IS_XS)), (xs,),
            Trie.from_dict({"ys": ys}))


def run_is(device, n, key):
    from modppl_tpu_torch.inference import importance_sampling

    model, args, obs = is_inputs(device)
    return importance_sampling(key, model, args, obs, n, device=device)


def is_summary(traces, lnw):
    """(ESS, the weighted means of a, b, c, the weighted P(is_linear)), in
    float64 from the float32 lanes."""
    w = torch.exp(lnw.double())
    means = [float(torch.sum(w * traces.data.read(f"coeffs/{c}").double()))
             for c in "abc"]
    p_lin = float(torch.sum(w * traces.data.read("is_linear").double()))
    return float(1.0 / torch.sum(w * w)), np.array(means), p_lin


def exact_quadratic():
    """(log evidence, posterior mean (3,), posterior sd (3,)) of the
    quadratic branch, float64 numpy."""
    from modppl_tpu_torch.models.hierarchical_static import (
        exact_hierarchical_posterior,
    )

    _, _, _, mean, cov, log_z = exact_hierarchical_posterior(IS_XS, IS_YS)
    return log_z, mean, np.sqrt(np.diag(cov))


def hierarchical_obs():
    """The eager model's observations, one ``(y, i)`` address a point."""
    from modppl_tpu_torch.core.trie import Trie

    obs = Trie()
    for i, y in enumerate(IS_YS):
        obs.observe(f"(y, {i})", y)
    return obs


def check_is_leg(device="cuda", n=IS_LANES):
    """Phase 17: the batched leg with the counters at 0 (no launch): finite
    log-weights, ESS >= IS_MIN_ESS, the log-ML within IS_SE standard errors
    sqrt(1/ESS - 1/N) of the exact evidence, the weighted a, b, c within
    IS_SE posterior sd / sqrt(ESS) of the exact posterior mean, P(is_linear)
    below IS_P_LINEAR_MAX, the same key twice bitwise equal; then
    ``importance_resampling`` of IS_RESAMPLED indices (in [0, N), their mean
    c within the same bound) and the eager hierarchical model at
    IS_EAGER_SAMPLES samples (finite log-ML)."""
    from modppl_tpu_torch.inference import (
        importance_resampling,
        importance_sampling,
    )
    from modppl_tpu_torch.models import hierarchical_model

    (traces, lnw, log_ml), launches = counted(lambda: run_is(device, n, 17))
    require_launches("importance leg", launches, {})
    if lnw.shape != (n,) or not bool(torch.isfinite(lnw).all()):
        raise AssertionError("importance leg: log-weights not finite (N,)")
    ess, means, p_lin = is_summary(traces, lnw)
    log_z, mean, sd = exact_quadratic()
    ml_se = math.sqrt(1.0 / ess - 1.0 / n)
    bound = IS_SE * sd / math.sqrt(ess)
    seen = {"ess": ess, "log_ml": float(log_ml), "exact": log_z,
            "ml_se": ml_se, "means": means.tolist(), "exact_mean":
            mean.tolist(), "bound": bound.tolist(), "p_linear": p_lin}
    if ess < IS_MIN_ESS or abs(float(log_ml) - log_z) > IS_SE * ml_se or \
            not (np.abs(means - mean) <= bound).all() or \
            not p_lin < IS_P_LINEAR_MAX:
        raise AssertionError(f"importance leg: {seen}")
    del traces
    again = run_is(device, n, 17)[1]
    if not torch.equal(lnw, again):
        raise AssertionError("importance leg: the same key gave different "
                             "log-weights")
    del again

    def resample_and_eager():
        model, args, obs = is_inputs(device)
        traces, idx, _ = importance_resampling(18, model, args, obs, n,
                                               IS_RESAMPLED, device=device)
        c = traces.data.read("coeffs/c")[idx.long()].double()
        eager = importance_sampling(19, hierarchical_model, (list(IS_XS),),
                                    hierarchical_obs(), IS_EAGER_SAMPLES,
                                    vectorized=False, device=device)
        return idx, float(c.mean()), eager

    (idx, c_mean, eager), launches = counted(resample_and_eager)
    require_launches("importance resampling and eager leg", launches, {})
    seen.update(resampled_c=c_mean, eager_log_ml=float(eager[2]),
                eager_quadratic=sum(t.data.search("coeffs/c") is not None
                                    for t in eager[0]))
    if idx.shape != (IS_RESAMPLED,) or int(idx.min()) < 0 or \
            int(idx.max()) >= n or abs(c_mean - mean[2]) > bound[2] or \
            not math.isfinite(seen["eager_log_ml"]):
        raise AssertionError(f"importance resampling / eager leg: {seen}")
    return seen


def time_is_leg(n=IS_LANES, runs=5):
    """Median wall time of ``runs`` batched runs (keys 1..runs)."""
    times = []
    for i in range(runs):
        sync("cuda")
        t0 = time.perf_counter()
        run_is("cuda", n, i + 1)
        sync("cuda")
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def run_mh_chain(device, rounds, key):
    """The eager hierarchical model's chain in the schedule of the
    reference's mh.rs:76-110: a round is one ``add_or_remove_param_proposal``
    move, MH_DRIFTS ``hierarchical_drift_proposal`` moves at MH_DRIFT and one
    ``regen_mh`` of the gate and the coefficients (a regeneration of the gate
    alone raises, here as in the reference, when it empties the quadratic
    branch). Returns (is_linear by round, [a, b, c] by round with c NaN in a
    linear round, accepted moves)."""
    from modppl_tpu_torch.core.address import select
    from modppl_tpu_torch.core.keys import split
    from modppl_tpu_torch.inference import mh, regen_mh
    from modppl_tpu_torch.models import (
        add_or_remove_param_proposal,
        hierarchical_drift_proposal,
        hierarchical_model,
    )

    k0, key = split(key)
    trace, _ = hierarchical_model.generate(k0, (list(IS_XS),),
                                           hierarchical_obs(), device=device)
    regen = select("is_linear", "coeffs")
    gates, coeffs, accepted = [], [], 0
    nan = torch.full((), math.nan, device=device)
    for _ in range(rounds):
        keys = split(key, MH_DRIFTS + 3)
        key = keys[0]
        trace, acc = mh(keys[1], hierarchical_model, trace,
                        add_or_remove_param_proposal)
        accepted += acc
        for k in keys[2:-1]:
            trace, acc = mh(k, hierarchical_model, trace,
                            hierarchical_drift_proposal, (MH_DRIFT,))
            accepted += acc
        trace, acc = regen_mh(keys[-1], hierarchical_model, trace, regen)
        accepted += acc
        d = trace.data
        linear = d.search("coeffs/c") is None
        gates.append(linear)
        coeffs.append(torch.stack([d.read("coeffs/a"), d.read("coeffs/b"),
                                   nan if linear else d.read("coeffs/c")]))
    return (np.array(gates), torch.stack(coeffs).double().cpu().numpy(),
            accepted)


def run_conjugate_regen(device, steps, key):
    """``regen_mh`` on mu of mu ~ N(0, 1), x ~ N(mu, 1), x = 1
    (tests/test_mh.py:57-68): the chain of mu."""
    from modppl_tpu_torch.core.address import select
    from modppl_tpu_torch.core.keys import split
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.dists import normal
    from modppl_tpu_torch.inference import regen_mh
    from modppl_tpu_torch.modeling import gen

    @gen
    def conjugate(h):
        mu = h.sample(normal, (0.0, 1.0), "mu")
        h.sample(normal, (mu, 1.0), "x")
        return mu

    k0, key = split(key)
    trace, _ = conjugate.generate(k0, (), Trie.from_dict({"x": 1.0}),
                                  device=device)
    mus = []
    for k in split(key, steps):
        trace, _ = regen_mh(k, conjugate, trace, select("mu"))
        mus.append(trace.data.read("mu"))
    return torch.stack(mus).double().cpu().numpy()


def check_mh_leg(device="cuda"):
    """Phase 18: the chain and the conjugate regen_mh chain with the
    counters at 0 (no launch): the kept rounds quadratic in MH_QUAD_SHARE of
    them, their mean a, b, c within MH_MEAN_GAP of the exact posterior
    mean, finite coefficients; the conjugate chain's mean 0.5 and sd
    sqrt(0.5), each within CONJ_GAP. Returns what was seen."""
    (gates, coeffs, accepted), launches = counted(
        lambda: run_mh_chain(device, MH_ROUNDS, 23))
    require_launches("MH leg", launches, {})
    mus, launches = counted(lambda: run_conjugate_regen(device, CONJ_STEPS,
                                                        24))
    require_launches("conjugate regen_mh", launches, {})
    _, mean, _ = exact_quadratic()
    kept = ~gates[MH_BURN:]
    kept_means = coeffs[MH_BURN:][kept].mean(0)
    mus = mus[CONJ_BURN:]
    seen = {"quadratic_share": float(kept.mean()), "means":
            kept_means.tolist(), "exact_mean": mean.tolist(),
            "gap": float(np.abs(kept_means - mean).max()),
            "accept": accepted / (MH_ROUNDS * (MH_DRIFTS + 2)),
            "conj_mean": float(mus.mean()), "conj_sd": float(mus.std())}
    finite = np.isfinite(coeffs[:, :2]).all() and \
        np.isfinite(coeffs[~gates, 2]).all()
    if seen["quadratic_share"] < MH_QUAD_SHARE or seen["gap"] > MH_MEAN_GAP \
            or not finite or abs(seen["conj_mean"] - 0.5) > CONJ_GAP or \
            abs(seen["conj_sd"] - math.sqrt(0.5)) > CONJ_GAP:
        raise AssertionError(f"MH leg: {seen}")
    return seen


def time_mh(rounds=MH_TIMED_ROUNDS, runs=3):
    """Median wall time of ``runs`` chains of ``rounds`` rounds."""
    times = []
    for i in range(runs):
        sync("cuda")
        t0 = time.perf_counter()
        run_mh_chain("cuda", rounds, 30 + i)
        sync("cuda")
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def spiral_observations(device):
    """Points on a circle of radius 0.4 (tests/test_smc_unfold.py's
    ``simulate_loop``), one a step from angle 1.0, as constraint tries."""
    from modppl_tpu_torch.core.trie import Trie

    out = []
    for t in range(PF_SPIRAL_STEPS):
        ang = 2 * math.pi * t / PF_SPIRAL_STEPS + 1.0
        c = Trie()
        c.observe("obs", torch.tensor([0.4 * math.cos(ang),
                                       0.4 * math.sin(ang)],
                                      dtype=torch.float32, device=device))
        out.append(c)
    return out


def run_hmm_pf(device, key):
    """``ParticleSystem`` over the hand-coded HMM of the reference's
    test (tests/test_particle_filter.py:38-67): (log-ML, ESS by step)."""
    from modppl_tpu_torch.inference import ParticleSystem
    from modppl_tpu_torch.models import HMM, HMMParams

    params = HMMParams(*(torch.tensor(a, dtype=torch.float32, device=device)
                         for a in hmm_arrays()))
    pf = ParticleSystem(HMM(params), PF_HMM_PARTICLES, key, device=device)
    pf.init_step(None, ([None], [PF_HMM_DATA[0]]))
    ess = []
    for obs in PF_HMM_DATA[1:]:
        pf.step(([None], [obs]))
        ess.append(float(pf.effective_sample_size()))
        pf.resample()
    return float(pf.log_marginal_likelihood_estimate()), ess


def run_spiral_pf(device, key):
    """``ParticleSystem`` over ``spiral_model`` (tests/test_smc_unfold.py:
    60-81), resampling every step: (distance of the final mean position
    from the last observation, log-ML)."""
    from modppl_tpu_torch.inference import ParticleSystem
    from modppl_tpu_torch.models import spiral_model
    from modppl_tpu_torch.models.spiral import polar_to_cartesian

    data = spiral_observations(device)
    pf = ParticleSystem(spiral_model, PF_SPIRAL_PARTICLES, key, device=device)
    pf.init_step(torch.zeros(2, device=device), [data[0]])
    pf.resample()
    for constraints in data[1:]:
        pf.step([constraints])
        pf.resample()
    pos = torch.stack([polar_to_cartesian(tr.retv[-1]) for tr in pf.traces])
    dist = torch.linalg.norm(pos.mean(0) - data[-1].read("obs"))
    return float(dist), float(pf.log_marginal_likelihood_estimate())


def check_eager_filters(device="cuda"):
    """Phase 19: both eager filters with the counters at 0 (no launch):
    the HMM's log-ML within PF_HMM_GAP of the exact forward algorithm's and
    its ESS in (0, N] each step; the spiral's final mean position within
    PF_SPIRAL_GAP of the last observation."""
    from modppl_tpu_torch.models.hmm import hmm_forward_log_ml

    (lml, ess), launches = counted(lambda: run_hmm_pf(device, 41))
    require_launches("eager HMM filter", launches, {})
    exact = float(hmm_forward_log_ml(*hmm_arrays(), PF_HMM_DATA))
    (dist, spiral_ml), launches = counted(lambda: run_spiral_pf(device, 42))
    require_launches("eager spiral filter", launches, {})
    seen = {"log_ml": lml, "exact": exact, "ess": ess, "spiral_dist": dist,
            "spiral_log_ml": spiral_ml}
    if abs(lml - exact) > PF_HMM_GAP or \
            not all(0.0 < e <= PF_HMM_PARTICLES for e in ess) or \
            not dist < PF_SPIRAL_GAP or not math.isfinite(spiral_ml):
        raise AssertionError(f"eager filters: {seen}")
    return seen


def time_eager_filter(run, runs=3):
    """Median wall time of ``runs`` runs of one eager filter."""
    times = []
    for i in range(runs):
        sync("cuda")
        t0 = time.perf_counter()
        run("cuda", 50 + i)
        sync("cuda")
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


# --------------------------------------------------------------------------
# slice 7: ChEES, ADVI, and the small entries (Kalman, Laplace, MALA,
# enumeration, the GP model)
# --------------------------------------------------------------------------

# bench.py:306-367 (bench_chees) at full width: the hierarchical leg's
# target and data (hierarchical_data), 10^4 chains, 200 + 300, setup key 99
CHEES = dict(num_chains=10_000, num_warmup=200, num_samples=300)
# the determinism rerun: key 0 twice at 10^3 chains, 50 + 50
CHEES_RERUN = dict(num_chains=1000, num_warmup=50, num_samples=50)
CHEES_SE = 4.0
# the accept rate: within CHEES_ACCEPT_GAP of the reference's own at this
# configuration (its chees_runner on the CPU, float64, key PRNGKey(0):
# 0.910; tests/test_torch_card_bounds.py recomputes it). Its adaptation
# targets 0.75, but the short last step-size window leaves the sampling
# phase well above that, so a band around 0.75 would reject the reference
CHEES_ACCEPT_GAP = 0.1
CHEES_REF_ACCEPT = 0.910
# bench.py:368-421 (bench_vi) at full width: d = 16, n = 256, 1024 Monte
# Carlo draws a step, 2000 steps, lr 5e-3; data simulate_logreg(7), float32
VI = dict(dim=16, n_data=256, num_mc=1024, num_steps=2000,
          learning_rate=5e-3)
# the largest coordinate distance of ADVI's mu from the oracle posterior
# mean allowed: twice the reference's own at this size (the JAX package's
# advi on the CPU, float64, on bench_vi's data simulate_logreg(PRNGKey(7)),
# key PRNGKey(0): 0.4164; tests/test_torch_card_bounds.py recomputes it),
# set before the leg first ran on the card
VI_MU_BOUND = 0.833
# phase 22: the 2-D LGSSM's length, the reference gates' configurations
KALMAN_T = 4096
KALMAN_TOL = 1e-9
MALA_CONJ = dict(num_samples=4000, num_warmup=1000, num_chains=4)
MALA_SCALE = dict(num_samples=3000, num_warmup=1000, num_chains=4)
MALA_SCALE_DATA = (0.3, -0.5, 0.8, 0.1, -0.2)
CHEES_CONJ = dict(num_samples=400, num_warmup=300, num_chains=32)


@contextlib.contextmanager
def counting_vag(module):
    """Count the batched value-and-grad calls of a runner built inside the
    context (the calls are counted for the runner's life)."""
    calls = [0]
    orig = module._value_and_grad

    def wrapped(logprob):
        vag = orig(logprob)

        def counted_vag(U):
            calls[0] += 1
            return vag(U)

        return counted_vag

    module._value_and_grad = wrapped
    try:
        yield calls
    finally:
        module._value_and_grad = orig


def make_chees_leg(device, config=None):
    """bench_chees's runner through the user's entry point,
    ``chees_runner``."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.chees import chees_runner
    from modppl_tpu_torch.models.hierarchical_static import (
        make_hierarchical_static,
    )

    xs, ys = hierarchical_data(device)
    return chees_runner(make_hierarchical_static(10), (xs,),
                        Trie.from_dict({"ys": ys, "is_linear": False}),
                        setup_key=99, device=device, **(config or CHEES))


def chees_exact():
    """(posterior mean (3,), sd (3,)) of a, b, c with the gate observed
    quadratic, float64 numpy, on hierarchical_data's points."""
    from modppl_tpu_torch.models.hierarchical_static import (
        exact_hierarchical_posterior,
    )

    xs, ys = (x.numpy() for x in hierarchical_data("cpu"))
    _, _, _, mean, cov, _ = exact_hierarchical_posterior(xs, ys)
    return mean, np.sqrt(np.diag(cov))


def check_chees_leg(device="cuda"):
    """Phase 20: the ChEES leg with the counters at 0 (no launch), run once
    and timed: finite draws, tau finite, every num_leapfrog >= 1, the
    pooled posterior mean of a, b, c within CHEES_SE posterior sd / sqrt(min
    ESS) of the exact one, the accept rate within CHEES_ACCEPT_GAP of the
    reference's at this configuration (CHEES_REF_ACCEPT). Returns (the
    runner, the run's output, what was seen: its wall time and
    value-and-grad calls too)."""
    import importlib

    # the module (the package exports a function of the same name)
    chees = importlib.import_module("modppl_tpu_torch.inference.chees")
    with counting_vag(chees) as calls, full_fp32():
        run = make_chees_leg(device)
        sync(device)
        t0 = time.perf_counter()
        out, launches = counted(lambda: run(0))
        wall = time.perf_counter() - t0
    require_launches("chees leg", launches, {})
    for what in ("unconstrained", "logp", "accept_prob", "step_size",
                 "trajectory_length"):
        if not bool(torch.isfinite(out[what]).all()):
            raise AssertionError(f"chees leg: {what} is not finite")
    us, ess = logreg_summary(out)
    mean = us.reshape(-1, 3).mean(0)
    exact, sd = chees_exact()
    bound = CHEES_SE * sd / math.sqrt(ess.min())
    accept = float(out["accept_prob"].double().mean())
    nl = out["num_leapfrog"]
    seen = {"means": mean.tolist(), "exact": exact.tolist(),
            "bound": bound.tolist(), "ess": ess.tolist(), "accept": accept,
            "tau": float(out["trajectory_length"]),
            "eps": float(out["step_size"]),
            "mean_leapfrog": float(nl.double().mean()),
            "vag_calls": calls[0], "wall_s": wall,
            "divergences": int(out["divergences"].sum())}
    if us.shape != (CHEES["num_chains"], CHEES["num_samples"], 3) or \
            not (np.abs(mean - exact) <= bound).all() or \
            abs(accept - CHEES_REF_ACCEPT) > CHEES_ACCEPT_GAP or \
            int(nl.min()) < 1 or not math.isfinite(seen["tau"]):
        raise AssertionError(f"chees leg: {seen}")
    return run, out, seen


def check_chees_rerun(device="cuda"):
    """Phase 20's determinism check, at CHEES_RERUN: key 0 twice through
    one runner, every output bitwise equal."""
    with full_fp32():
        run = make_chees_leg(device, CHEES_RERUN)
        first, second = run(0), run(0)
    for what in ("unconstrained", "logp", "accept_prob", "step_size",
                 "trajectory_length", "num_leapfrog", "divergences"):
        if not torch.equal(first[what], second[what]):
            raise AssertionError(f"chees leg: {what} differs between two "
                                 f"runs of key 0 at {CHEES_RERUN}")


def vi_data(device):
    """bench_vi's (X (256, 16), ys (256,)), float32, from seed 7."""
    from modppl_tpu_torch.models.logreg import simulate_logreg

    X, ys, _ = simulate_logreg(7, VI["n_data"], VI["dim"], device=device)
    return X, ys


def run_vi(device, key, data=None):
    """bench_vi's call: mean-field ADVI through ``advi``."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.vi import advi
    from modppl_tpu_torch.models.logreg import make_logreg

    return advi(key, make_logreg(VI["dim"]),
                data if data is not None else vi_data(device), Trie(),
                num_steps=VI["num_steps"], num_mc=VI["num_mc"],
                learning_rate=VI["learning_rate"], device=device)


def check_vi_leg(device="cuda"):
    """Phase 21: the VI leg with the counters at 0 (no launch): finite mu,
    log_sigma and ELBO trace; mu within VI_MU_BOUND of the float64
    importance-sampling oracle's posterior mean on these data (phase 15's
    ``logreg_oracle``); the last 50 steps' mean ELBO at most the oracle's
    log evidence. Returns what was seen."""
    data = vi_data(device)
    oracle, oracle_se, _, log_ev = logreg_oracle(*(x.cpu().numpy()
                                                   for x in data))
    with full_fp32():
        out, launches = counted(lambda: run_vi(device, 0, data))
    require_launches("vi leg", launches, {})
    mu = out["mu"].double().cpu().numpy()
    final_elbo = float(out["elbo"][-50:].double().mean())
    gap = float(np.abs(mu - oracle).max())
    seen = {"gap": gap, "bound": VI_MU_BOUND, "final_elbo": final_elbo,
            "log_evidence": float(log_ev),
            "oracle_se": float(oracle_se.max()),
            "sigma_mean": float(torch.exp(out["log_sigma"]).mean())}
    if not (np.isfinite(mu).all()
            and bool(torch.isfinite(out["log_sigma"]).all())
            and bool(torch.isfinite(out["elbo"]).all())) or \
            gap > VI_MU_BOUND or not final_elbo <= log_ev:
        raise AssertionError(f"vi leg: {seen}")
    return seen


def time_vi_leg(reps=1, device="cuda"):
    """Phase 21's timing, as bench_vi measures: the median wall time of
    ``reps`` runs (keys 1..reps; one by default) after phase 21's run; MC
    model evals/s and the last run's final ELBO (mean of its last 50
    steps)."""
    data = vi_data(device)
    times = []
    with full_fp32():
        for i in range(reps):
            sync(device)
            t0 = time.perf_counter()
            out = run_vi(device, i + 1, data)
            sync(device)
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return {"median_s": med, "times": times,
            "evals_per_s": VI["num_steps"] * VI["num_mc"] / med,
            "final_elbo": float(out["elbo"][-50:].double().mean())}


def _timed_check(name, fn, results, device="cuda"):
    """Run one phase-22 check with the counters at 0, require no launch,
    and keep its wall ms."""
    sync(device)
    t0 = time.perf_counter()
    seen, launches = counted(fn)
    results[name] = {"ms": (time.perf_counter() - t0) * 1e3, **seen}
    require_launches(name, launches, {})


def kalman_check(device):
    """``kalman_filter_parallel`` against ``kalman_filter`` on a 2-D LGSSM
    at T = KALMAN_T in float64 (every output within KALMAN_TOL), and the
    guided leg's scalar model's log-ML against ``lg_kalman_log_ml``."""
    from modppl_tpu_torch.inference.kalman import (
        kalman_filter,
        kalman_filter_parallel,
    )
    from modppl_tpu_torch.models.lgssm import LGSSMParams, lgssm_simulate

    f64 = dict(dtype=torch.float64, device=device)
    th = 0.3
    params = LGSSMParams(
        torch.tensor([[0.95 * math.cos(th), -0.95 * math.sin(th)],
                      [0.95 * math.sin(th), 0.95 * math.cos(th)]], **f64),
        0.1 * torch.eye(2, **f64), torch.tensor([[1.0, 0.5], [0.0, 1.0]],
                                                **f64),
        0.5 * torch.eye(2, **f64), torch.zeros(2, **f64), torch.eye(2, **f64))
    _, ys = lgssm_simulate(5, params, KALMAN_T)
    seq = kalman_filter(params, ys, device=device)
    par = kalman_filter_parallel(params, ys, device=device)
    errs = {k: float((par[k] - seq[k]).abs().max()) for k in seq}
    scale = {k: float(seq[k].abs().max()) for k in seq}
    lg = LGSSMParams(*(torch.tensor(v, **f64) for v in (
        [[LG_A]], [[LG_Q ** 2]], [[1.0]], [[LG_R ** 2]], [0.0], [[1.0]])))
    lg_ys = lg_observations()
    lg_ml = float(kalman_filter(lg, torch.tensor(lg_ys, **f64)[:, None],
                                device=device)["log_ml"])
    exact = lg_kalman_log_ml(lg_ys)
    seen = {"max_err": errs, "log_ml": float(seq["log_ml"]),
            "lg_log_ml": lg_ml, "lg_exact": float(exact)}
    if any(errs[k] > KALMAN_TOL * (1.0 + scale[k]) for k in errs) or \
            abs(lg_ml - exact) > KALMAN_TOL * (1.0 + abs(exact)):
        raise AssertionError(f"kalman: {seen}")
    return seen


def small_models(device):
    """The reference tests' small models: conjugate N(0, 1) -> N(mu, 1)
    (tests/test_mala.py), the gamma scale model, Poisson-gamma
    (tests/test_map_laplace.py), conjugate N(0, 1) -> N(mu, 0.5)
    (tests/test_chees.py) and the bernoulli-gated mixture
    (tests/test_enumerate.py, float64 constants)."""
    from modppl_tpu_torch.dists import bernoulli, gamma, iid, normal, poisson
    from modppl_tpu_torch.modeling import gen

    ys5 = iid(normal, 5)
    f64 = dict(dtype=torch.float64, device=device)

    @gen
    def conj1(h):
        mu = h.sample(normal, (0.0, 1.0), "mu")
        h.sample(normal, (mu, 1.0), "x")
        return mu

    @gen
    def scale_model(h):
        scale = h.sample(gamma, (2.0, 1.0), "scale")
        h.sample(ys5, (0.0, scale), "ys")

    @gen
    def poisson_gamma(h):
        lam = h.sample(gamma, (2.0, 1.0), "lam")
        h.sample(poisson, (lam,), "k")
        return lam

    @gen
    def conj_half(h):
        mu = h.sample(normal, (0.0, 1.0), "mu")
        h.sample(normal, (mu, 0.5), "x")
        return mu

    @gen
    def mixture(h):
        z = h.sample(bernoulli, torch.tensor(0.3, **f64), "z")
        mu = torch.where(torch.as_tensor(z), torch.tensor(2.0, **f64),
                         torch.tensor(-1.0, **f64))
        h.sample(normal, (mu, 1.0), "x")
        return z

    return dict(conj1=conj1, scale_model=scale_model,
                poisson_gamma=poisson_gamma, conj_half=conj_half,
                mixture=mixture)


def scale_model_oracle():
    """E[scale | ys] of the gamma scale model by quadrature (numpy)."""
    grid = np.linspace(1e-3, 6.0, 4001)
    d = np.asarray(MALA_SCALE_DATA, np.float32).astype(np.float64)
    lps = (np.log(grid) - grid
           + np.sum(-0.5 * (d[None, :] / grid[:, None]) ** 2
                    - np.log(grid[:, None]), axis=1))
    w = np.exp(lps - lps.max())
    return float(np.sum(grid * w) / np.sum(w))


def check_small_entries(device="cuda"):
    """Phase 22: each small entry once with the counters at 0 (no launch),
    against its reference gate, with its wall ms; the reference's full
    configurations of the ChEES conjugate gates the CPU tests shorten
    (dynamic and static_unroll=16). Returns {check: seen}."""
    import scipy.stats as st

    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.chees import chees
    from modppl_tpu_torch.inference.enumerate import enumerate_posterior
    from modppl_tpu_torch.inference.map_laplace import laplace_approximation
    from modppl_tpu_torch.inference.mala import mala

    m = small_models(device)
    out = {}

    def fail(name, seen):
        raise AssertionError(f"{name}: {seen}")

    _timed_check("kalman", lambda: kalman_check(device), out, device)

    def laplace():
        r = laplace_approximation(0, m["poisson_gamma"], (),
                                  Trie.from_dict({"k": 3}), num_steps=600,
                                  learning_rate=0.03, device=device)
        seen = {"log_ml": float(r["log_ml"]), "exact": math.log(0.125)}
        if abs(seen["log_ml"] - seen["exact"]) > 0.05:
            fail("laplace", seen)
        return seen

    def mala_conj():
        r = mala(0, m["conj1"], (), Trie.from_dict({"x": 1.0}),
                 device=device, **MALA_CONJ)
        mus = r["samples"]["mu"].double().cpu().numpy().ravel()
        seen = {"mean": float(mus.mean()), "sd": float(mus.std()),
                "accept": float(r["accept_prob"].double().mean())}
        if abs(seen["mean"] - 0.5) > 0.05 or \
                abs(seen["sd"] - math.sqrt(0.5)) > 0.05 or \
                not 0.35 < seen["accept"] < 0.8:
            fail("mala conjugate", seen)
        return seen

    def mala_scale():
        data = torch.tensor(MALA_SCALE_DATA, device=device)
        r = mala(1, m["scale_model"], (), Trie.from_dict({"ys": data}),
                 device=device, **MALA_SCALE)
        s = r["samples"]["scale"].double().cpu().numpy().ravel()
        seen = {"mean": float(s.mean()), "exact": scale_model_oracle(),
                "min": float(s.min())}
        if not seen["min"] > 0.0 or abs(seen["mean"] - seen["exact"]) > 0.08:
            fail("mala scale", seen)
        return seen

    def enumerate_gate():
        r = enumerate_posterior(m["mixture"], (), Trie.from_dict({"x": 1.0}),
                                {"z": torch.tensor([False, True])},
                                device=device)
        j0 = math.log(0.7) + st.norm(-1, 1).logpdf(1.0)
        j1 = math.log(0.3) + st.norm(2, 1).logpdf(1.0)
        exact = float(np.logaddexp(j0, j1))
        seen = {"log_ml": float(r["log_ml"]), "exact": exact,
                "p_z": float(r["marginals"]["z"][1]),
                "p_z_exact": math.exp(j1 - exact)}
        if abs(seen["log_ml"] - exact) > 1e-9 or \
                abs(seen["p_z"] - seen["p_z_exact"]) > 1e-9:
            fail("enumerate", seen)
        return seen

    def chees_conj(static_unroll):
        r = chees(0, m["conj_half"], (), Trie.from_dict({"x": 1.0}),
                  static_unroll=static_unroll, device=device, **CHEES_CONJ)
        mus = r["samples"]["mu"][:, 100:].double().cpu().numpy().ravel()
        nl = r["num_leapfrog"]
        seen = {"mean": float(mus.mean()), "sd": float(mus.std()),
                "divergences": int(r["divergences"].sum()),
                "max_leapfrog": int(nl.max()),
                "tau": float(r["trajectory_length"])}
        if abs(seen["mean"] - 0.8) > 0.05 or \
                abs(seen["sd"] - math.sqrt(0.2)) > 0.05 or \
                seen["divergences"] or \
                tuple(nl.shape) != (CHEES_CONJ["num_samples"],) or \
                (static_unroll and seen["max_leapfrog"] > static_unroll):
            fail(f"chees conjugate static_unroll={static_unroll}", seen)
        return seen

    with full_fp32():
        for name, fn in (("laplace", laplace), ("mala_conjugate", mala_conj),
                         ("mala_scale", mala_scale),
                         ("enumerate", enumerate_gate),
                         ("chees_conjugate", lambda: chees_conj(None)),
                         ("chees_conjugate_static16",
                          lambda: chees_conj(16))):
            _timed_check(name, fn, out, device)
    return out


# --------------------------------------------------------------------------
# slice 8: lane key streams, NUTS, the vmapped particle filter, mcmc_chains
# --------------------------------------------------------------------------

# phase 23: lane streams at C = 2^20; the card's ndtri against the CPU's
LANES = 1 << 20
LANE_NORMAL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# bench.py:246-305 (bench_nuts, BASELINE configs[3]) at full width: the
# hierarchical leg's target and data with the gate observed, 10^4 chains,
# 200 + 300, max_depth 6, setup key 99, run key 0
NUTS = dict(num_chains=10_000, num_warmup=200, num_samples=300, max_depth=6)
NUTS_SE = 4.0
NUTS_MAX_DIVERGENCE = 0.01
NUTS_MIN_DEPTH = 1.0
# the window whose profile gives the idle share (the profiler's own cost
# grows with the ops)
NUTS_PROFILED = dict(num_warmup=3, num_samples=3)
# BASELINE configs[2]: the spiral ScanKernel at 10^4 particles through the
# vmapped particle_filter, tests/test_vsmc.py:82-101's observations
PF_PARTICLES = 10_000
PF_STEPS = 12
PF_TRACK_GAP = 0.1
PF_TIMED_RUNS = 5
# tests/test_vsmc.py:26-59's HMM gate at 10^4 particles
PF_HMM_GATE_DATA = (0, 0, 1, 2)
# tests/test_mcmc_compiled.py:46-59's gate at 10^4 chains
MCMC_CHAINS = 10_000
MCMC_ITERS = 400
MCMC_BURN = 100
MCMC_GAP = 0.03


def check_lane_streams(device="cuda"):
    """Phase 23: lane keys and their draws on ``device`` against the same
    calls on the CPU at C = LANES: keys, words and uniforms bitwise, the
    normals (``ndtri`` rounds per device) within LANE_NORMAL_TOL (1 + |z|);
    and the first C lanes of a 2C draw equal the C draw on the card.
    Returns what was seen."""
    from modppl_tpu_torch.core import keys as K

    def calls(dev):
        ks = K.lanes(12345, LANES, dev)
        sk = K.split_keys(6789, LANES, dev)
        data = torch.arange(LANES, dtype=torch.int64, device=dev) * 7919
        return {"lanes": ks, "split_keys": sk,
                "split_lanes": K.split_lanes(ks, 4),
                "fold_in_lanes": K.fold_in_lanes(sk, data),
                "lane_bits": K.lane_bits(sk, 4),
                "uniform32": K.uniform_lanes(ks, (3,), torch.float32),
                "uniform64": K.uniform_lanes(ks, (3,), torch.float64),
                "normal32": K.normal_lanes(sk, (2,), torch.float32),
                "normal64": K.normal_lanes(sk, (2,), torch.float64)}

    card, host = calls(device), calls("cpu")
    seen = {}
    for name, x in card.items():
        y = host[name]
        if name.startswith("normal"):
            tol = LANE_NORMAL_TOL[y.dtype]
            err = float(((x.cpu() - y).abs() / (1 + y.abs())).max())
            seen[name] = err
            if not err <= tol:
                raise AssertionError(f"lane streams: {name} on the card "
                                     f"differs from the CPU's by {err} "
                                     f"(1 + |z|), over {tol}")
        elif not torch.equal(x.cpu(), y):
            raise AssertionError(f"lane streams: {name} on the card differs "
                                 "from the CPU's")
    for draw in (K.uniform_lanes, K.normal_lanes):
        one = draw(K.split_keys(3, LANES, device), (2,), torch.float32)
        two = draw(K.split_keys(3, 2 * LANES, device), (2,), torch.float32)
        if not torch.equal(two[:LANES], one):
            raise AssertionError(f"lane streams: {draw.__name__}'s first C "
                                 "lanes of a 2C draw differ from the C draw")
    return seen


def make_nuts_leg(device, **overrides):
    """bench_nuts's runner through the user's entry point,
    ``nuts_runner``."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.nuts import nuts_runner
    from modppl_tpu_torch.models.hierarchical_static import (
        make_hierarchical_static,
    )

    xs, ys = hierarchical_data(device)
    return nuts_runner(make_hierarchical_static(10), (xs,),
                       Trie.from_dict({"ys": ys, "is_linear": False}),
                       setup_key=99, device=device,
                       **{**NUTS, **overrides})


def check_nuts_leg(device="cuda"):
    """Phase 24: the NUTS leg with the counters at 0 (no launch), run once
    and timed: finite draws, the pooled posterior mean of a, b, c within
    NUTS_SE posterior sd / sqrt(min ESS) of the exact one, divergences
    below NUTS_MAX_DIVERGENCE, mean tree depth above NUTS_MIN_DEPTH.
    Returns what was seen: wall time, ESS, value-and-grad calls and leaves
    a transition too."""
    import importlib

    nuts_mod = importlib.import_module("modppl_tpu_torch.inference.nuts")
    with counting_vag(nuts_mod) as calls, full_fp32():
        run = make_nuts_leg(device)
        sync(device)
        t0 = time.perf_counter()
        out, launches = counted(lambda: run(0))
        wall = time.perf_counter() - t0
    require_launches("nuts leg", launches, {})
    for what in ("unconstrained", "logp", "accept_prob", "step_size"):
        if not bool(torch.isfinite(out[what]).all()):
            raise AssertionError(f"nuts leg: {what} is not finite")
    us, ess = logreg_summary(out)
    mean = us.reshape(-1, 3).mean(0)
    exact, sd = chees_exact()
    bound = NUTS_SE * sd / math.sqrt(ess.min())
    transitions = NUTS["num_warmup"] + NUTS["num_samples"]
    seen = {"means": mean.tolist(), "exact": exact.tolist(),
            "bound": bound.tolist(), "ess": ess.tolist(),
            "accept": float(out["accept_prob"].double().mean()),
            "eps": float(out["step_size"]),
            "divergence_rate": float(out["divergences"].double().mean()),
            "mean_depth": float(out["tree_depth"].double().mean()),
            "max_depth": int(out["tree_depth"].max()),
            "vag_calls": calls[0], "leaves": run.chains.leaves,
            "leaves_a_transition": run.chains.leaves / transitions,
            "wall_s": wall}
    if us.shape != (NUTS["num_chains"], NUTS["num_samples"], 3) or \
            not (np.abs(mean - exact) <= bound).all() or \
            not seen["divergence_rate"] < NUTS_MAX_DIVERGENCE or \
            not seen["mean_depth"] > NUTS_MIN_DEPTH:
        raise AssertionError(f"nuts leg: {seen}")
    return seen


def timed_nuts_run(device, key, **config):
    """One timed run of a leg-width runner at ``config``: (output, wall s,
    leaves a transition)."""
    with full_fp32():
        run = make_nuts_leg(device, **config)
        sync(device)
        t0 = time.perf_counter()
        out = run(key)
        sync(device)
    transitions = config["num_warmup"] + config["num_samples"]
    return out, time.perf_counter() - t0, run.chains.leaves / transitions


def profile_nuts(device="cuda"):
    """Phase 24's idle share, after the leg warmed the process up:
    NUTS_PROFILED at the leg's width timed, then profiled."""
    _, wall, _ = timed_nuts_run(device, 7, **NUTS_PROFILED)
    run = make_nuts_leg(device, **NUTS_PROFILED)
    with full_fp32():
        profile_run(f"nuts leg {NUTS_PROFILED}", lambda: run(7), wall)


def run_pf_spiral(device, seed, **kwargs):
    """BASELINE configs[2]: the spiral ScanKernel through the vmapped
    ``particle_filter``, float32, systematic, PF_PARTICLES x PF_STEPS."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.vsmc import particle_filter
    from modppl_tpu_torch.models.spiral import spiral_scan_kernel

    obs = torch.tensor(pf_observations(), dtype=torch.float32, device=device)
    return particle_filter(
        seed, spiral_scan_kernel(),
        torch.zeros(2, dtype=torch.float32, device=device),
        Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]}),
        PF_PARTICLES, resampling="systematic", ess_threshold=1.0,
        store_traces=False, device=device, **kwargs)


def pf_observations():
    """tests/test_vsmc.py:82-101: a circle of radius 0.4, PF_STEPS points
    a turn."""
    return [[0.4 * math.cos(2 * math.pi * t / PF_STEPS),
             0.4 * math.sin(2 * math.pi * t / PF_STEPS)]
            for t in range(PF_STEPS)]


def run_pf_hmm(device, seed, resampling, **kwargs):
    """tests/test_vsmc.py:26-59's HMM through the vmapped filter."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.vsmc import particle_filter
    from modppl_tpu_torch.interop import hmm_params_from_numpy
    from modppl_tpu_torch.models.hmm import hmm_scan_kernel

    params = hmm_params_from_numpy(*(a.astype(np.float32)
                                     for a in hmm_arrays()), device=device)
    obs = torch.tensor(PF_HMM_GATE_DATA, dtype=torch.int32, device=device)
    return particle_filter(
        seed, hmm_scan_kernel(params),
        torch.zeros((), dtype=torch.float32, device=device),
        Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]}),
        PF_PARTICLES, resampling=resampling, ess_threshold=1.0,
        store_traces=False, device=device, **kwargs)


def check_pf_leg(device="cuda"):
    """Phase 25: the vmapped filter with the counters at 0. The spiral:
    PF_STEPS - 1 launches of kernel 3 and none other, the weighted mean
    position within PF_TRACK_GAP of the last observation, and every output
    bitwise equal to its rerun through the plain versions on the card fed
    the run's recorded draws (a rerun that launches no kernel). The HMM
    gate, multinomial (no launch) and systematic (S -> grid_rank, one
    launch a step, every output bitwise equal to its rerun through
    grid_rank's plain version on the recorded draws): log-ML within
    HMM_LOG_ML_GAP of the exact one. Returns what was seen."""
    from modppl_tpu_torch.models.hmm import hmm_forward_log_ml
    from modppl_tpu_torch.models.spiral import polar_to_cartesian

    record = []
    out, launches = counted(lambda: run_pf_spiral(device, 17, record=record))
    require_launches("vmapped spiral", launches,
                     {"resample_fused_from_s": PF_STEPS - 1})
    pos = polar_to_cartesian(out["state"].double())
    w = torch.softmax(out["log_weights"].double(), 0)
    mean = torch.sum(w[:, None] * pos, 0).cpu()
    gap = float(torch.linalg.norm(mean - torch.tensor(
        pf_observations()[-1], dtype=torch.float64)))
    if not (gap < PF_TRACK_GAP and math.isfinite(float(out["log_ml"]))):
        raise AssertionError(f"vmapped spiral: mean position {gap} from the "
                             f"last observation, log_ml {out['log_ml']}")
    with plain_versions():
        plain = run_pf_spiral(device, 18, replay=record)
    for what in ("state", "log_weights", "log_ml", "ancestors", "ess",
                 "resampled"):
        if not torch.equal(out[what], plain[what]):
            raise AssertionError(f"vmapped spiral: {what} differs from its "
                                 "rerun through the plain versions")
    exact = float(hmm_forward_log_ml(*hmm_arrays(), PF_HMM_GATE_DATA))
    seen = {"spiral_gap": gap, "spiral_log_ml": float(out["log_ml"]),
            "launches": launches["resample_fused_from_s"], "exact": exact}
    steps = len(PF_HMM_GATE_DATA) - 1
    for seed, resampling, want in ((0, "multinomial", {}),
                                   (1, "systematic", {"grid_rank": steps})):
        rec = []
        hmm, hl = counted(lambda: run_pf_hmm(device, seed, resampling,
                                             record=rec))
        require_launches(f"vmapped HMM ({resampling})", hl, want)
        if want:
            with plain_grid_rank():
                plain = run_pf_hmm(device, seed + 10, resampling, replay=rec)
            for what in ("state", "log_weights", "log_ml", "ancestors",
                         "ess", "resampled"):
                if not torch.equal(hmm[what], plain[what]):
                    raise AssertionError(
                        f"vmapped HMM ({resampling}): {what} differs from "
                        "its rerun through grid_rank's plain version")
        log_ml = float(hmm["log_ml"])
        if not abs(log_ml - exact) <= HMM_LOG_ML_GAP:
            raise AssertionError(f"vmapped HMM ({resampling}): log_ml "
                                 f"{log_ml} vs exact {exact}")
        seen[f"hmm_{resampling}"] = log_ml
        seen[f"grid_rank_{resampling}"] = hl["grid_rank"]
    return seen


def time_pf_leg(runs=PF_TIMED_RUNS, device="cuda"):
    """Phase 25's timing: the median wall time of ``runs`` spiral filters
    after a warm-up (particle-steps/s)."""
    run_pf_spiral(device, 40)
    times = []
    for i in range(runs):
        sync(device)
        t0 = time.perf_counter()
        run_pf_spiral(device, 41 + i)
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def check_mcmc_chains(device="cuda"):
    """Phase 26: tests/test_mcmc_compiled.py:46-59's gate at MCMC_CHAINS
    chains with the counters at 0 (no launch): the drift-MH kernel on the
    conjugate model, MCMC_ITERS iterations, the pooled draws after
    MCMC_BURN with mean 0.5 and sd sqrt(0.5) within MCMC_GAP. Returns
    what was seen, its wall time too."""
    from modppl_tpu_torch.core.keys import split_keys
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.dists import normal
    from modppl_tpu_torch.inference.mcmc import mcmc_chains, mh_kernel
    from modppl_tpu_torch.modeling import gen

    @gen
    def conjugate(h):
        mu = h.sample(normal, (0.0, 1.0), "mu")
        h.sample(normal, (mu, 1.0), "x")
        return mu

    @gen
    def drift(h, trace, scale):
        h.sample(normal, (trace.data.read("mu"), scale), "mu")

    obs = Trie.from_dict({"x": torch.tensor(1.0, device=device)})

    def run():
        traces0, _ = conjugate.generate(split_keys(2, MCMC_CHAINS, device),
                                        (), obs)
        return mcmc_chains(3, mh_kernel(conjugate, drift, (0.8,)), traces0,
                           MCMC_ITERS, MCMC_CHAINS,
                           extract=lambda t: t.data.read("mu"))

    sync(device)
    t0 = time.perf_counter()
    (_, mus, accepts), launches = counted(run)
    wall = time.perf_counter() - t0
    require_launches("mcmc_chains", launches, {})
    kept = mus[:, MCMC_BURN:].double()
    seen = {"mean": float(kept.mean()), "sd": float(kept.std()),
            "accept": float(accepts.double().mean()), "wall_s": wall}
    if mus.shape != (MCMC_CHAINS, MCMC_ITERS) or \
            abs(seen["mean"] - 0.5) > MCMC_GAP or \
            abs(seen["sd"] - math.sqrt(0.5)) > MCMC_GAP:
        raise AssertionError(f"mcmc_chains: {seen}")
    return seen


def slice8_phases(card, profile, device="cuda", clock=None):
    """Phases 23-26 (slice 8), with their lines of output."""
    lanes_seen = check_lane_streams(device)
    print(f"# lane streams at C={LANES}: keys, words and uniforms on the "
          f"card == the CPU's, bitwise; normals within "
          f"{lanes_seen}"
          f" (1 + |z|); the first C lanes of 2C draws == the C draws "
          f"({card})")
    sys.stdout.flush()
    if clock:
        clock.mark("23 lane streams")
    nu = check_nuts_leg(device)
    ess_min = min(nu["ess"])
    print(f"# main path: NUTS on the hierarchical model {NUTS} float32 "
          f"through nuts_runner(device={device!r}), no kernel launched; "
          f"mean a, b, c {[round(x, 5) for x in nu['means']]} exact "
          f"{[round(x, 5) for x in nu['exact']]} (bound "
          f"{[round(x, 5) for x in nu['bound']]}); divergences "
          f"{nu['divergence_rate']!r}; mean tree depth {nu['mean_depth']!r} "
          f"(max {nu['max_depth']}); accept {nu['accept']!r}; eps "
          f"{nu['eps']!r}")
    print(f"# nuts leg: {nu['wall_s'] * 1e3:.3f} ms (one timed run, key 0); "
          f"min-coord ESS {ess_min:.1f} -> {ess_min / nu['wall_s']:.1f} "
          f"ESS/s; {nu['leaves_a_transition']:.3f} leaves a transition, "
          f"{nu['vag_calls']} value-and-grad calls "
          f"({nu['wall_s'] * 1e3 / nu['vag_calls']:.4f} ms a call) ({card})")
    sys.stdout.flush()
    profile_nuts(device)
    sys.stdout.flush()
    if clock:
        clock.mark("24 NUTS leg")
    pf = check_pf_leg(device)
    pf_s, pf_times = time_pf_leg(device=device)
    print(f"# main path: the spiral ScanKernel through the vmapped "
          f"particle_filter, N={PF_PARTICLES} T={PF_STEPS} float32, "
          f"systematic; launches resample_fused_from_s {pf['launches']}, no "
          f"other kernel; mean position {pf['spiral_gap']!r} from the last "
          f"observation; == its rerun through the plain versions on the "
          f"recorded draws (no kernel launched), bitwise; HMM gate at "
          f"N={PF_PARTICLES}: log_ml multinomial {pf['hmm_multinomial']!r}, "
          f"systematic {pf['hmm_systematic']!r} (grid_rank launches "
          f"{pf['grid_rank_systematic']}; == its rerun through grid_rank's "
          f"plain version on the recorded draws, bitwise), exact "
          f"{pf['exact']!r}")
    print(f"# vmapped spiral filter: median {pf_s * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in pf_times]} ms -> "
          f"{PF_PARTICLES * PF_STEPS / pf_s:.1f} particle-steps/s ({card})")
    if profile:
        profile_run("vmapped spiral filter",
                    lambda: run_pf_spiral(device, 61), pf_s)
    sys.stdout.flush()
    if clock:
        clock.mark("25 vmapped filter")
    mc = check_mcmc_chains(device)
    print(f"# main path: mcmc_chains, drift MH on the conjugate model, "
          f"{MCMC_CHAINS} chains x {MCMC_ITERS}, no kernel launched; mean "
          f"{mc['mean']!r} sd {mc['sd']!r} (0.5, {math.sqrt(0.5):.5f}); "
          f"accept {mc['accept']!r}; {mc['wall_s'] * 1e3:.3f} ms -> "
          f"{MCMC_CHAINS * MCMC_ITERS / mc['wall_s']:.4g} transitions/s "
          f"({card})")
    sys.stdout.flush()
    if clock:
        clock.mark("26 mcmc_chains")


# --------------------------------------------------------------------------
# slice 9: stochastic volatility, PMMH, particle Gibbs, FIVO, the tempered
# SMC samplers and parallel tempering
# --------------------------------------------------------------------------

SV_PARTICLES = 1 << 20
SV_STEPS = 100
SV_ESS = 0.5
SV_GAP = 0.1             # tests/test_stochvol.py's bound on the log-ML
SV_ORACLE_MOVE = 0.01    # the grid oracle at m = 400 vs m = 1600, wider
SV_TIMED_RUNS = 5
# 600 iterations, 150 burn-in (the reference test's 1200 and 300 before,
# cut to keep the script inside its time limit: 64 chains keep 28,800
# draws against the test's 1,800)
PMMH = dict(num_chains=64, num_particles=4096, num_samples=600, burn=150,
            step_size=0.15, steps=10)
# tests/test_pmcmc.py's data: the reference's lgssm_simulate(PRNGKey(0),
# _params(0.7), 10) as the tests compute it (float64)
PMMH_YS = (1.8543003223768244, 1.8803144089710702, 1.102049900121674,
           -1.0271285071015643, -0.9514388130130933, -1.7638284387600267,
           -1.0782675411112455, -0.4312744368291923, -0.4602346485465222,
           -0.0508029016176299)
PMMH_MEAN_GAP = 0.07     # tests/test_pmcmc.py's bounds
PMMH_ACCEPT = (0.05, 0.9)
PMMH_ML_GAP = 0.1
# 750 sweeps, 150 burn-in (the reference's 1500 and 300 before, cut to
# keep the script inside its time limit; the CPU tests run 500 and 100)
PG = dict(steps=6, num_particles=32, num_sweeps=750, burn=150)
PG_GAP = 0.12            # tests/test_pgibbs.py's bound
CSMC = dict(steps=100, num_particles=1 << 16)
CSMC_GAP = 1.0
FIVO = dict(num_particles=256, num_steps=400, learning_rate=0.03,
            batch_size=4)
FIVO_YS = (0.3, 0.5, 0.1, -0.2, 0.4, 0.9, 0.7, 0.2)  # test_batched_filter
FIVO_GRAD_PARTICLES = 1 << 20
FIVO_GRAD_RTOL = 1e-5
SMCS_PARTICLES = 1 << 20
SMCS_YS = (0.8, 1.2, 1.0)                           # tests/test_smc_sampler
PT = dict(num_replicas=6, num_chains=4, num_rounds=400, burn=100)


def normal_pdf(x, mu, sd):
    return np.exp(-0.5 * ((x - mu) / sd) ** 2) / (sd * math.sqrt(2 * math.pi))


def sv_grid_log_ml(ys, m=400, lo=-4.0, hi=2.0):
    """tests/test_stochvol.py:27-47's oracle in float64 numpy: exact
    filtering of SVParams() on an m-point grid of h."""
    from modppl_tpu_torch.models.stochvol import SVParams

    p = SVParams()
    grid = np.linspace(lo, hi, m)
    w = grid[1] - grid[0]
    sd0 = p.sigma / math.sqrt(1 - p.phi * p.phi)
    trans = normal_pdf(grid[None, :], p.mu + p.phi * (grid[:, None] - p.mu),
                       p.sigma) * w
    alpha = normal_pdf(grid, p.mu, sd0) * w
    total = 0.0
    for t, y in enumerate(np.asarray(ys, np.float64)):
        if t > 0:
            alpha = alpha @ trans
        alpha = alpha * normal_pdf(y, 0.0, p.beta * np.exp(grid / 2.0))
        s = alpha.sum()
        total += math.log(s)
        alpha /= s
    return total


_SV_DATA = {}


def sv_data(device):
    """T = SV_STEPS observations of SVParams() from simulate_sv (key 2027)
    on ``device``, float32."""
    from modppl_tpu_torch.models.stochvol import simulate_sv

    if device not in _SV_DATA:
        _SV_DATA[device] = simulate_sv(2027, SV_STEPS, device=device)[1].to(
            torch.float32)
    return _SV_DATA[device]


def run_sv(device, seed, n=SV_PARTICLES, **kwargs):
    """Phase 27's filter: sv_scan_kernel(SVParams()) on the batched tier,
    systematic, ess_threshold SV_ESS."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.vsmc import batched_particle_filter
    from modppl_tpu_torch.models.stochvol import sv_scan_kernel

    ys = sv_data(device)
    return batched_particle_filter(
        seed, sv_scan_kernel(), torch.zeros((), device=device),
        Trie.from_dict({"y": ys[0]}), Trie.from_dict({"y": ys[1:]}), n,
        ess_threshold=SV_ESS, auto_batch=True, device=device, **kwargs)


FILTER_OUTPUTS = ("state", "log_weights", "log_ml", "ancestors", "ess",
                  "resampled")


def require_equal(what, out, plain, keys=FILTER_OUTPUTS):
    for k in keys:
        if not torch.equal(out[k], plain[k]):
            raise AssertionError(f"{what}: {k} differs from its rerun "
                                 "through the plain versions")


def check_sv_leg(device="cuda"):
    """Phase 27: the SV filter at SV_PARTICLES x SV_STEPS with the counters
    at 0: SV_STEPS - 1 launches of kernel 3 (both arms run every step) and
    none other, the log-ML within SV_GAP of the grid oracle (which moves
    less than SV_ORACLE_MOVE at m = 1600 on [-5, 3]), resampling on
    0 < k < SV_STEPS - 1 steps, every output bitwise equal to its rerun
    through the plain versions on the recorded draws."""
    record = []
    out, launches = counted(lambda: run_sv(device, 5, record=record))
    require_launches("sv filter", launches,
                     {"resample_fused_from_s": SV_STEPS - 1})
    ys = sv_data(device).double().cpu().numpy()
    oracle = sv_grid_log_ml(ys)
    fine = sv_grid_log_ml(ys, m=1600, lo=-5.0, hi=3.0)
    fired = int(out["resampled"].sum())
    seen = {"log_ml": float(out["log_ml"]), "oracle": oracle,
            "oracle_fine": fine, "resampled": fired,
            "launches": launches["resample_fused_from_s"]}
    if not (abs(seen["log_ml"] - oracle) <= SV_GAP
            and abs(fine - oracle) < SV_ORACLE_MOVE
            and 0 < fired < SV_STEPS - 1):
        raise AssertionError(f"sv filter: {seen}")
    with plain_versions():
        plain = run_sv(device, 6, replay=record)
    require_equal("sv filter", out, plain)
    return seen


def time_runs(fn, runs, device="cuda"):
    """The median wall time of ``runs`` calls of ``fn(i)`` after a warm-up
    call, synchronised."""
    fn(-1)
    times = []
    for i in range(runs):
        sync(device)
        t0 = time.perf_counter()
        fn(i)
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def pmmh_model(device):
    """tests/test_pmcmc.py:18-36's 1-D LGSSM and data (PMMH_YS), a ~
    U(-0.99, 0.99): ``make_kernel(a_lanes)`` with normal sites, x_t ~
    N(a x_{t-1}, sqrt(0.2)), obs ~ N(x, sqrt(0.3)), x_0 ~ N(0, 1). Returns
    (make_kernel, ys (T,) float32 on ``device``)."""
    from modppl_tpu_torch.dists import normal
    from modppl_tpu_torch.inference.vsmc import ScanKernel
    from modppl_tpu_torch.modeling import gen

    q, r = math.sqrt(0.2), math.sqrt(0.3)

    def make_kernel(a):
        @gen
        def init(h, _s0):
            x = h.sample(normal, (0.0, 1.0), "x")
            h.sample(normal, (x, r), "obs")
            return x

        @gen
        def step(h, t, prev):
            x = h.sample(normal, (a * prev, q), "x")
            h.sample(normal, (x, r), "obs")
            return x

        return ScanKernel(init, step)

    return make_kernel, torch.tensor(PMMH_YS, dtype=torch.float32,
                                     device=device)


def lgssm_1d(a, q, r):
    from modppl_tpu_torch.models.lgssm import make_lgssm

    return make_lgssm([[a]], [[q]], [[1.0]], [[r]], [0.0], [[1.0]],
                      device="cpu")


def pmmh_oracle(ys):
    """The exact posterior mean of a by quadrature over the port's
    float64 kalman_filter (397 points, tests/test_pmcmc.py:43-47), and the
    Kalman log-ML at a = 0.7."""
    from modppl_tpu_torch.inference.kalman import kalman_filter

    y = torch.as_tensor(ys, dtype=torch.float64, device="cpu")[:, None]
    grid = np.linspace(-0.99, 0.99, 397)
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        lml = np.array([float(kalman_filter(lgssm_1d(a, 0.2, 0.3), y,
                                            device="cpu")["log_ml"])
                        for a in grid])
        at_true = float(kalman_filter(lgssm_1d(0.7, 0.2, 0.3), y,
                                      device="cpu")["log_ml"])
    finally:
        torch.set_default_dtype(saved)
    w = np.exp(lml - lml.max())
    return float((grid * w).sum() / w.sum()), at_true


def check_blocked_kernel3(device="cuda"):
    """Kernel 3 on the chain-blocked S at PMMH's shape (C x N = 64 x 4096):
    one launch for every chain, bitwise its plain version; chain C / 2's
    weights at NaN leave every other chain's ancestors and states bitwise
    unchanged."""
    from modppl_tpu_torch.parallel.resample import blocked_resample

    c, n = PMMH["num_chains"], PMMH["num_particles"]
    rng = np.random.default_rng(28)
    lw = torch.from_numpy(rng.standard_normal((c, n)).astype(np.float32))
    lw = (lw - torch.logsumexp(lw, 1, keepdim=True)).to(device)
    u = torch.from_numpy(rng.uniform(size=c).astype(np.float32)).to(device)
    state = torch.from_numpy(rng.standard_normal((c * n, 1)).astype(
        np.float32)).to(device)
    (new, parents), launches = counted(
        lambda: blocked_resample("systematic", lw, state, u))
    require_launches("chain-blocked kernel 3", launches,
                     {"resample_fused_from_s": 1})
    with plain_versions():
        p_new, p_parents = blocked_resample("systematic", lw, state, u)
    if not (torch.equal(new, p_new) and torch.equal(parents, p_parents)):
        raise AssertionError("chain-blocked kernel 3 differs from its plain "
                             "version")
    bad = lw.clone()
    bad[c // 2] = float("nan")
    d_new, d_parents = blocked_resample("systematic", bad, state, u)
    keep = torch.ones(c * n, dtype=torch.bool, device=device)
    keep[c // 2 * n:(c // 2 + 1) * n] = False
    if not (torch.equal(d_parents[keep], parents[keep])
            and torch.equal(d_new[keep], new[keep])):
        raise AssertionError("chain-blocked kernel 3: a NaN chain moved "
                             "another chain's ancestors")


def check_pmmh_leg(device="cuda"):
    """Phase 28: PMMH over C x N = 64 x 4096 lanes a filter with the
    counters at 0: (1 + num_samples) filters x (T - 1) launches of kernel
    3 (one a step for every chain) and none other; the posterior mean of
    a after burn-in within PMMH_MEAN_GAP of the quadrature oracle, every
    chain's accept rate in PMMH_ACCEPT; the estimator at a = 0.7 over 4
    chain keys within PMMH_ML_GAP of the Kalman log-ML. Timed."""
    from modppl_tpu_torch.core.keys import split_keys
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.pmcmc import pmmh, smc_log_ml_fn

    check_blocked_kernel3(device)
    make_kernel, ys = pmmh_model(device)
    exact_mean, exact_ml = pmmh_oracle(PMMH_YS)
    fn = smc_log_ml_fn(make_kernel, torch.zeros((), device=device),
                       Trie.from_dict({"obs": ys[0]}),
                       Trie.from_dict({"obs": ys[1:]}),
                       PMMH["num_particles"], auto_batch=True, device=device)
    steps = PMMH["steps"] - 1
    est, launches = counted(lambda: fn(
        split_keys(11, 4, device), torch.full((4,), 0.7, device=device)))
    require_launches("pmmh estimator", launches,
                     {"resample_fused_from_s": steps})
    est = float(est.double().mean())

    def log_prior(a):
        return torch.where(a.abs() < 0.99, 0.0, -math.inf)

    sync(device)
    t0 = time.perf_counter()
    out, launches = counted(lambda: pmmh(
        1, log_prior, fn, torch.tensor(0.2), num_samples=PMMH["num_samples"],
        num_chains=PMMH["num_chains"], step_size=PMMH["step_size"],
        device=device))
    wall = time.perf_counter() - t0
    require_launches("pmmh", launches, {
        "resample_fused_from_s": (1 + PMMH["num_samples"]) * steps})
    samples = out["samples"][:, PMMH["burn"]:].double()
    acc = out["accept_rate"].cpu()
    seen = {"mean": float(samples.mean()), "exact_mean": exact_mean,
            "accept_min": float(acc.min()), "accept_max": float(acc.max()),
            "estimate": est, "kalman": exact_ml, "wall_s": wall,
            "launches": launches["resample_fused_from_s"]}
    if not (abs(seen["mean"] - exact_mean) < PMMH_MEAN_GAP
            and PMMH_ACCEPT[0] < seen["accept_min"]
            and seen["accept_max"] < PMMH_ACCEPT[1]
            and abs(est - exact_ml) < PMMH_ML_GAP):
        raise AssertionError(f"pmmh: {seen}")
    return seen


def pg_model(device, steps, key):
    """tests/test_pgibbs.py:20-31's LGSSM (A 0.8, Q 0.3, H 1, R 0.4, mu0
    0, P0 1) on ``device``: (params, ys (steps, 1), kernel, init and step
    constraints), data from the port's lgssm_simulate."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.models.lgssm import (
        lgssm_scan_kernel,
        lgssm_simulate,
        make_lgssm,
    )

    one = [[1.0]]
    params = make_lgssm([[0.8]], [[0.3]], one, [[0.4]], [0.0], one,
                        device=device)
    _, ys = lgssm_simulate(key, params, steps)
    return (params, ys, lgssm_scan_kernel(params),
            Trie.from_dict({"obs": ys[0]}), Trie.from_dict({"obs": ys[1:]}))


def pg_exact(ys, smoother=True):
    """The float64 Kalman smoother's (means, sds) of x, or the filter's
    log-ML, on the CPU."""
    from modppl_tpu_torch.inference.kalman import (
        kalman_filter,
        kalman_smoother,
    )
    from modppl_tpu_torch.models.lgssm import make_lgssm

    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        params = make_lgssm([[0.8]], [[0.3]], [[1.0]], [[0.4]], [0.0],
                            [[1.0]], device="cpu")
        y = ys.double().cpu()
        if not smoother:
            return float(kalman_filter(params, y, device="cpu")["log_ml"])
        s = kalman_smoother(params, y, device="cpu")
        return s["means"][:, 0].numpy(), s["covs"][:, 0, 0].sqrt().numpy()
    finally:
        torch.set_default_dtype(saved)


def check_pg_leg(device="cuda"):
    """Phase 29: particle Gibbs with ancestor sampling at the reference's
    gate configuration (PG) with the counters at 0 (no launch): the
    trajectory's means and sds after burn-in within PG_GAP of the Kalman
    smoother's; without ancestor sampling at twice the particles, the last
    step's mean within PG_GAP; then one csmc_sweep at CSMC, log-ML within
    CSMC_GAP of the Kalman filter's. Timed."""
    from modppl_tpu_torch.inference.pgibbs import csmc_sweep, particle_gibbs

    _, ys, kernel, ic, sc = pg_model(device, PG["steps"], 3)
    sync(device)
    t0 = time.perf_counter()
    out, launches = counted(lambda: particle_gibbs(
        1, kernel, torch.zeros(1, device=device), ic, sc,
        latent_init_addrs=("x",), latent_step_addrs=("x",),
        num_particles=PG["num_particles"], num_sweeps=PG["num_sweeps"],
        device=device))
    wall = time.perf_counter() - t0
    require_launches("particle gibbs", launches, {})
    burn = PG["burn"]
    traj = torch.cat([out["init"]["x"][burn:, 0][:, None],
                      out["steps"]["x"][burn:, :, 0]], 1).double().cpu()
    means, sds = pg_exact(ys)
    seen = {"mean_gap": float(np.abs(traj.mean(0).numpy() - means).max()),
            "sd_gap": float(np.abs(traj.std(0).numpy() - sds).max()),
            "wall_s": wall}
    plain, launches = counted(lambda: particle_gibbs(
        3, kernel, torch.zeros(1, device=device), ic, sc,
        latent_init_addrs=("x",), latent_step_addrs=("x",),
        num_particles=2 * PG["num_particles"], num_sweeps=PG["num_sweeps"],
        ancestor_sampling=False, device=device))
    require_launches("particle gibbs without ancestor sampling", launches,
                     {})
    seen["no_as_gap"] = abs(float(plain["steps"]["x"][burn:, -1, 0].double()
                                  .mean()) - float(means[-1]))
    _, ys100, kernel100, ic100, sc100 = pg_model(device, CSMC["steps"], 4)
    sync(device)
    t0 = time.perf_counter()
    sweep, launches = counted(lambda: csmc_sweep(
        2, kernel100, torch.zeros(1, device=device), ic100, sc100,
        {"x": torch.zeros(1, device=device)},
        {"x": torch.zeros((CSMC["steps"] - 1, 1), device=device)},
        CSMC["num_particles"], device=device))
    seen["csmc_wall_s"] = time.perf_counter() - t0
    require_launches("csmc sweep", launches, {})
    seen["csmc_log_ml"] = float(sweep["log_ml"])
    seen["csmc_exact"] = pg_exact(ys100, smoother=False)
    if not (seen["mean_gap"] < PG_GAP and seen["sd_gap"] < PG_GAP
            and seen["no_as_gap"] < PG_GAP
            and abs(seen["csmc_log_ml"] - seen["csmc_exact"]) < CSMC_GAP
            and sweep["ref_steps"]["x"].shape == (CSMC["steps"] - 1, 1)):
        raise AssertionError(f"particle gibbs: {seen}")
    return seen


_FIVO_PROP = {}


def fivo_proposal():
    """tests/test_batched_filter.py:143-148's learnable proposal."""
    from modppl_tpu_torch.dists import normal
    from modppl_tpu_torch.modeling import gen

    if not _FIVO_PROP:
        @gen
        def lg_learnable_proposal(h, t, prev, cons, params):
            y = cons.read("y")
            m = params["w_prev"] * prev + params["w_obs"] * y + \
                params["bias"]
            std = torch.nn.functional.softplus(params["raw_std"])
            h.sample(normal, (m, std), "x")

        _FIVO_PROP["prop"] = lg_learnable_proposal
    return _FIVO_PROP["prop"]


def fivo_inputs(device):
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.vsmc import ScanKernel

    init, step, _ = lg_models()
    ys = torch.tensor(FIVO_YS, dtype=torch.float32, device=device)
    return (ScanKernel(init, step), fivo_proposal(),
            torch.zeros((), device=device), Trie.from_dict({"y": ys[0]}),
            Trie.from_dict({"y": ys[1:]}))


def fivo_params(device, w_prev, w_obs, bias, raw_std):
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in (("w_prev", w_prev), ("w_obs", w_obs),
                         ("bias", bias), ("raw_std", raw_std))}


def check_fivo_leg(device="cuda"):
    """Phase 30: fit_proposal at the reference's configuration (FIVO,
    ess_threshold 0: no resampling, no launch) and its gates
    (tests/test_batched_filter.py:151-187); then the gradient of
    fivo_objective(auto_batch=True, systematic, ess_threshold=1.0), the
    chain-blocked filter fit_proposal trains through at one chain, at
    FIVO_GRAD_PARTICLES with respect to the params: kernel 3 launches in
    it (one a step), the value bitwise equal to the same call through the
    plain versions, the gradient finite, nonzero and within FIVO_GRAD_RTOL
    of the plain run's (the scatter-adds may add in other orders)."""
    from modppl_tpu_torch.core.keys import split
    from modppl_tpu_torch.inference.fivo import fit_proposal, fivo_objective

    kernel, prop, s0, ic, sc = fivo_inputs(device)
    want = lg_kalman_log_ml(FIVO_YS)
    prec = 1.0 / LG_Q ** 2 + 1.0 / LG_R ** 2
    sync(device)
    t0 = time.perf_counter()
    (params, bounds), launches = counted(lambda: fit_proposal(
        0, kernel, prop, fivo_params(device, 0.0, 0.0, 0.0, 0.5), s0, ic, sc,
        FIVO["num_particles"], num_steps=FIVO["num_steps"],
        learning_rate=FIVO["learning_rate"], batch_size=FIVO["batch_size"],
        ess_threshold=0.0, device=device))
    wall = time.perf_counter() - t0
    require_launches("fit_proposal", launches, {})

    def bound_stats(p):
        vals = torch.stack([fivo_objective(
            k, kernel, prop, p, s0, ic, sc, FIVO["num_particles"],
            device=device) for k in split(99, 32)]).double()
        return float(vals.mean()), float(vals.std())

    (mean_tr, std_tr), launches = counted(lambda: bound_stats(params))
    require_launches("fivo bounds", launches, {})
    _, std_init = bound_stats(fivo_params(device, 0.0, 0.0, 0.0, 0.5))
    std = float(torch.nn.functional.softplus(params["raw_std"]))
    seen = {"w_obs": float(params["w_obs"]), "w_obs_opt": 1 / LG_R ** 2 / prec,
            "std": std, "std_opt": 1 / math.sqrt(prec), "mean": mean_tr,
            "kalman": want, "std_trained": std_tr, "std_init": std_init,
            "wall_s": wall, "last_bound": float(bounds[-1])}
    if not (abs(seen["w_obs"] - seen["w_obs_opt"]) <= 0.15
            and abs(std - seen["std_opt"]) <= 0.1
            and std_tr < 0.5 * std_init and abs(mean_tr - want) <= 0.1):
        raise AssertionError(f"fit_proposal: {seen}")

    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}

    def grad_run():
        val = fivo_objective(7, kernel, prop, leaves, s0, ic, sc,
                             FIVO_GRAD_PARTICLES, resampling="systematic",
                             ess_threshold=1.0, auto_batch=True,
                             device=device)
        return val, torch.autograd.grad(val, tuple(leaves.values()))

    sync(device)
    t0 = time.perf_counter()
    (val, grads), launches = counted(grad_run)
    seen["grad_wall_s"] = time.perf_counter() - t0
    require_launches("fivo gradient", launches,
                     {"resample_fused_from_s": len(FIVO_YS) - 1})
    with plain_versions():
        p_val, p_grads = grad_run()
    g, p_g = torch.stack(grads).double(), torch.stack(p_grads).double()
    rel = float(((g - p_g).abs() / p_g.abs().clamp_min(1e-30)).max())
    seen.update(grad_value=float(val.detach()), grad=g.tolist(),
                grad_rel_err=rel,
                grad_launches=launches["resample_fused_from_s"])
    if not (torch.equal(val, p_val) and bool(torch.isfinite(g).all())
            and bool((g != 0).all()) and rel <= FIVO_GRAD_RTOL):
        raise AssertionError(f"fivo gradient through kernel 3: {seen}, "
                             f"plain {float(p_val)!r} {p_g.tolist()}")
    return seen


_NN_MODEL = {}


def nn_model():
    """tests/test_smc_sampler.py:37-41: mu ~ N(0, 1), ys ~ iid N(mu, 0.5)."""
    from modppl_tpu_torch.dists import normal
    from modppl_tpu_torch.dists.iid import iid
    from modppl_tpu_torch.modeling import gen

    if not _NN_MODEL:
        ys3 = iid(normal, 3)

        @gen
        def model(h):
            mu = h.sample(normal, (0.0, 1.0), "mu")
            h.sample(ys3, (mu, 0.5), "ys")
            return mu

        _NN_MODEL["model"] = model
    return _NN_MODEL["model"]


def nn_exact():
    """The conjugate posterior's mean and sd and the exact log-ML."""
    ys = np.array(SMCS_YS)
    prec = 1.0 + 3.0 / 0.25
    cov = 0.25 * np.eye(3) + np.ones((3, 3))
    _, logdet = np.linalg.slogdet(2 * np.pi * cov)
    return ((ys.sum() / 0.25) / prec, 1.0 / math.sqrt(prec),
            float(-0.5 * (logdet + ys @ np.linalg.solve(cov, ys))))


def check_smc_sampler_leg(device="cuda"):
    """Phase 31: the tempered SMC samplers on nn_model at SMCS_PARTICLES
    and parallel tempering at PT, with the counters at 0: one grid_rank
    launch a rung (both arms every rung) and none other for the samplers,
    none for parallel tempering; tests/test_smc_sampler.py's gates. Each
    run timed."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.smc_sampler import (
        adaptive_smc_sampler,
        smc_sampler,
    )
    from modppl_tpu_torch.inference.tempering import parallel_tempering

    obs = Trie.from_dict({"ys": torch.tensor(SMCS_YS, dtype=torch.float32,
                                             device=device)})
    mean, sd, lml = nn_exact()
    model = nn_model()
    seen = {"exact": (mean, sd, lml)}
    runs = {
        "hmc": (lambda: smc_sampler(
            0, model, (), obs, num_particles=SMCS_PARTICLES, num_temps=16,
            num_moves=2, move="hmc", step_size=0.3, num_leapfrog=8,
            device=device), (0.05, 0.06, 0.15)),
        "mala": (lambda: smc_sampler(
            1, model, (), obs, num_particles=SMCS_PARTICLES, num_temps=16,
            num_moves=3, move="mala", step_size=0.3, device=device),
            (0.07, None, 0.2)),
        "adaptive": (lambda: adaptive_smc_sampler(
            4, model, (), obs, num_particles=SMCS_PARTICLES, target_ess=0.9,
            num_moves=2, move="hmc", step_size=0.3, device=device),
            (0.05, None, 0.15)),
    }
    for name, (run, (mean_tol, sd_tol, lml_tol)) in runs.items():
        sync(device)
        t0 = time.perf_counter()
        out, launches = counted(run)
        wall = time.perf_counter() - t0
        rungs = out.get("num_temps", 16)
        require_launches(f"smc_sampler {name}", launches,
                         {"grid_rank": rungs})
        w = torch.exp(out["log_weights"].double())
        mus = out["particles"]["mu"].double()
        m = float((w * mus).sum())
        s = float(((w * (mus - m) ** 2).sum()).sqrt())
        acc = out["accept_rate"][:rungs].double().mean()
        got = {"mean": m, "sd": s, "log_ml": float(out["log_ml"]),
               "accept": float(acc), "rungs": rungs, "wall_s": wall,
               "grid_rank": launches["grid_rank"]}
        seen[name] = got
        ok = (abs(m - mean) <= mean_tol and abs(got["log_ml"] - lml) <= lml_tol
              and (sd_tol is None or abs(s - sd) <= sd_tol))
        if name == "hmc":
            ok = ok and got["accept"] > 0.4
        if name == "adaptive":
            betas = out["betas"][:rungs].double().cpu()
            ok = (ok and 1 < rungs < 100 and bool((betas.diff() > 0).all())
                  and abs(float(betas[-1]) - 1.0) < 1e-6)
        if not ok:
            raise AssertionError(f"smc_sampler {name}: {got}")
    sync(device)
    t0 = time.perf_counter()
    runs["hmc"][0]()
    sync(device)
    seen["hmc"]["rerun_s"] = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    out, launches = counted(lambda: parallel_tempering(
        3, model, (), obs, num_replicas=PT["num_replicas"],
        num_chains=PT["num_chains"], num_rounds=PT["num_rounds"], move="hmc",
        step_size=0.3, num_leapfrog=8, device=device))
    wall = time.perf_counter() - t0
    require_launches("parallel tempering", launches, {})
    mus = out["samples"]["mu"][:, PT["burn"]:].double().reshape(-1)
    got = {"mean": float(mus.mean()), "sd": float(mus.std()),
           "swap": float(out["swap_accept"].double().mean()), "wall_s": wall}
    seen["tempering"] = got
    if not (abs(got["mean"] - mean) <= 0.06 and abs(got["sd"] - sd) <= 0.06
            and got["swap"] > 0.1):
        raise AssertionError(f"parallel tempering: {got}")
    return seen


def slice9_phases(card, profile, device="cuda", clock=None):
    """Phases 27-31 (slice 9), with their lines of output."""
    sv = check_sv_leg(device)
    sv_s, sv_times = time_runs(lambda i: run_sv(device, 40 + i),
                               SV_TIMED_RUNS, device)
    print(f"# main path: the SV filter (SVParams()) N={SV_PARTICLES} "
          f"T={SV_STEPS} float32 through batched_particle_filter(auto_batch="
          f"True), systematic, ess_threshold {SV_ESS}; launches "
          f"resample_fused_from_s {sv['launches']}, no other kernel; "
          f"resampled on {sv['resampled']} steps; log_ml {sv['log_ml']!r} "
          f"grid oracle {sv['oracle']!r} (m=1600 on [-5, 3]: "
          f"{sv['oracle_fine']!r}); == its rerun through the plain versions "
          f"on the recorded draws, bitwise")
    print(f"# sv filter: median {sv_s * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in sv_times]} ms -> "
          f"{SV_PARTICLES * SV_STEPS / sv_s:.4g} particle-steps/s ({card})")
    if profile:
        profile_run("sv filter", lambda: run_sv(device, 61), sv_s)
    sys.stdout.flush()
    if clock:
        clock.mark("27 SV filter")
    pm = check_pmmh_leg(device)
    iters = PMMH["num_samples"]
    print(f"# main path: PMMH {PMMH} on the 1-D LGSSM through "
          f"smc_log_ml_fn(auto_batch=True), one chain-blocked filter of "
          f"{PMMH['num_chains'] * PMMH['num_particles']} lanes a step; "
          f"launches resample_fused_from_s {pm['launches']}, no other "
          f"kernel; chain-blocked S through kernel 3 == plain, bitwise, a "
          f"NaN chain moves no other; posterior mean {pm['mean']!r} exact "
          f"{pm['exact_mean']!r}; accept in [{pm['accept_min']!r}, "
          f"{pm['accept_max']!r}]; estimator at a=0.7 {pm['estimate']!r} "
          f"Kalman {pm['kalman']!r}")
    print(f"# pmmh leg: {pm['wall_s'] * 1e3:.1f} ms for {iters} iterations "
          f"-> {pm['wall_s'] * 1e3 / iters:.3f} ms an iteration, "
          f"{PMMH['num_chains'] * iters / pm['wall_s']:.1f} "
          f"chain-iterations/s ({card})")
    sys.stdout.flush()
    if clock:
        clock.mark("28 PMMH")
    pg = check_pg_leg(device)
    print(f"# main path: particle_gibbs {PG} on the LGSSM, ancestor "
          f"sampling, no kernel launched; trajectory mean gap "
          f"{pg['mean_gap']!r} sd gap {pg['sd_gap']!r} (bound {PG_GAP}); "
          f"without it (N={2 * PG['num_particles']}) the last step's mean "
          f"gap {pg['no_as_gap']!r}; "
          f"csmc_sweep {CSMC}: log_ml {pg['csmc_log_ml']!r} Kalman "
          f"{pg['csmc_exact']!r}")
    print(f"# pgibbs leg: {pg['wall_s'] * 1e3:.1f} ms -> "
          f"{pg['wall_s'] * 1e3 / PG['num_sweeps']:.3f} ms a sweep; "
          f"csmc_sweep {pg['csmc_wall_s'] * 1e3:.1f} ms ({card})")
    sys.stdout.flush()
    if clock:
        clock.mark("29 particle Gibbs")
    fv = check_fivo_leg(device)
    print(f"# main path: fit_proposal {FIVO} on the LG model, no kernel "
          f"launched; w_obs {fv['w_obs']!r} (optimum {fv['w_obs_opt']!r}), "
          f"std {fv['std']!r} (optimum {fv['std_opt']!r}); bound mean "
          f"{fv['mean']!r} Kalman {fv['kalman']!r}; bound sd trained "
          f"{fv['std_trained']!r} initial {fv['std_init']!r}; gradient of "
          f"fivo_objective at N={FIVO_GRAD_PARTICLES} (systematic, "
          f"ess_threshold 1.0): launches resample_fused_from_s "
          f"{fv['grad_launches']}, value {fv['grad_value']!r} == plain "
          f"bitwise, gradient {[round(x, 6) for x in fv['grad']]} within "
          f"{fv['grad_rel_err']!r} relative of plain")
    print(f"# fivo leg: fit_proposal {fv['wall_s'] * 1e3:.1f} ms -> "
          f"{fv['wall_s'] * 1e3 / FIVO['num_steps']:.3f} ms a step; value "
          f"and gradient at N={FIVO_GRAD_PARTICLES} "
          f"{fv['grad_wall_s'] * 1e3:.1f} ms ({card})")
    sys.stdout.flush()
    if clock:
        clock.mark("30 FIVO")
    sm = check_smc_sampler_leg(device)
    for name in ("hmc", "mala", "adaptive"):
        r = sm[name]
        print(f"# main path: smc_sampler {name} on nn_model, "
              f"N={SMCS_PARTICLES}: {r['rungs']} rungs, grid_rank launches "
              f"{r['grid_rank']}, no other kernel; mean {r['mean']!r} sd "
              f"{r['sd']!r} log_ml {r['log_ml']!r} (exact "
              f"{[round(x, 6) for x in sm['exact']]}); accept "
              f"{r['accept']!r}; {r['wall_s'] * 1e3:.1f} ms"
              + (f" (again: {r['rerun_s'] * 1e3:.1f} ms)" if "rerun_s" in r
                 else "") + f" ({card})")
    pt = sm["tempering"]
    print(f"# main path: parallel_tempering {PT}, no kernel launched; cold "
          f"mean {pt['mean']!r} sd {pt['sd']!r}; swap accept {pt['swap']!r}; "
          f"{pt['wall_s'] * 1e3:.1f} ms -> "
          f"{pt['wall_s'] * 1e3 / PT['num_rounds']:.3f} ms a round ({card})")
    if profile:
        profile_slice9(device)
    sys.stdout.flush()
    if clock:
        clock.mark("31 SMC samplers, tempering")


def profile_slice9(device="cuda"):
    """``--profile``'s breakdowns of phases 28-31: one PMMH estimate (an
    iteration's filter, 64 chains), 20 particle-Gibbs sweeps, FIVO's value
    and gradient at 2^20, one MALA smc_sampler at 2^20 and 20 rounds of
    parallel tempering, each against the median of 3 unprofiled runs."""
    from modppl_tpu_torch.core.keys import split_keys
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.fivo import fivo_objective
    from modppl_tpu_torch.inference.pgibbs import particle_gibbs
    from modppl_tpu_torch.inference.pmcmc import smc_log_ml_fn
    from modppl_tpu_torch.inference.smc_sampler import smc_sampler
    from modppl_tpu_torch.inference.tempering import parallel_tempering

    make_kernel, ys = pmmh_model(device)
    est = smc_log_ml_fn(make_kernel, torch.zeros((), device=device),
                        Trie.from_dict({"obs": ys[0]}),
                        Trie.from_dict({"obs": ys[1:]}),
                        PMMH["num_particles"], auto_batch=True, device=device)
    c = PMMH["num_chains"]
    _, pg_kernel, pg_ic, pg_sc = pg_model(device, PG["steps"], 3)[1:]
    kernel, prop, s0, ic, sc = fivo_inputs(device)
    params = {k: v.requires_grad_() for k, v in
              fivo_params(device, 0.3, 0.7, 0.0, -1.0).items()}
    obs = Trie.from_dict({"ys": torch.tensor(SMCS_YS, dtype=torch.float32,
                                             device=device)})

    def fivo_grad():
        val = fivo_objective(7, kernel, prop, params, s0, ic, sc,
                             FIVO_GRAD_PARTICLES, resampling="systematic",
                             ess_threshold=1.0, auto_batch=True,
                             device=device)
        return torch.autograd.grad(val, tuple(params.values()))

    legs = {
        "pmmh estimate (64 x 4096)": lambda i: est(
            split_keys(20 + i, c, device), torch.full((c,), 0.7,
                                                      device=device)),
        "particle gibbs (20 sweeps)": lambda i: particle_gibbs(
            i, pg_kernel, torch.zeros(1, device=device), pg_ic, pg_sc,
            latent_init_addrs=("x",), latent_step_addrs=("x",),
            num_particles=PG["num_particles"], num_sweeps=20, device=device),
        "fivo value and gradient (2^20)": lambda i: fivo_grad(),
        "smc_sampler mala (2^20)": lambda i: smc_sampler(
            i, nn_model(), (), obs, num_particles=SMCS_PARTICLES,
            num_temps=16, num_moves=3, move="mala", step_size=0.3,
            device=device),
        "parallel tempering (20 rounds)": lambda i: parallel_tempering(
            i, nn_model(), (), obs, num_replicas=PT["num_replicas"],
            num_chains=PT["num_chains"], num_rounds=20, step_size=0.3,
            device=device),
    }
    for label, fn in legs.items():
        med, _ = time_runs(fn, 3, device)
        profile_run(label, lambda: fn(99), med)
        sys.stdout.flush()


# --------------------------------------------------------------------------
# slice 10: resumable inference (the checkpointed filters and HMC runner),
# the combinators, profiling
# --------------------------------------------------------------------------

CKPT_EVERY = 3           # the sharded filter's chunk (phase 32)
CKPT_HEAD = 3            # the steps of the interrupted head run
CKPT_TIMED_RUNS = 5
CKPT_IO_REPS = 5
CKPT_VMAPPED_EVERY = 4   # phase 33, tests/test_checkpointed.py's schedule
CKPT_LG_PARTICLES = 4096
CKPT_LG_EVERY = 2
CKPT_LG_GAP = 0.08       # tests/test_checkpointed.py:65-75
CKPT_HMC = dict(num_chains=10_000, num_warmup=100, num_samples=200,
                num_leapfrog=8, checkpoint_every=50)
CKPT_HMC_PROFILED = dict(num_chains=10_000, num_warmup=10, num_samples=20,
                         num_leapfrog=8, checkpoint_every=10)
CKPT_HMC_HEAD = 50
CKPT_HMC_SE = 4.0
CKPT_HMC_SD_GAP = 0.03
CKPT_HMC_RHAT_GAP = 0.05
COND_LANES = 1 << 20
COND_Y = 1.5
COND_SE = 4.0
MAP_ELEMENTS = 1 << 20
MAP_RTOL = 1e-5
SPIRAL_KERNELS = ("stats_cumsum", "positions_cummax", "resample_fused_from_s")


def run_ckpt_sharded(device, path, num_steps=T, resume_from=None, seed=7,
                     mesh=None):
    """Phase 32's filter: the main path's spiral through
    ``checkpointed_sharded_particle_filter``, its first ``num_steps`` - 1
    steps, a checkpoint every CKPT_EVERY steps at ``path``."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.checkpointed import (
        checkpointed_sharded_particle_filter,
    )
    from modppl_tpu_torch.models.spiral import (
        circle_observations,
        spiral_scan_kernel,
    )

    obs = torch.tensor(circle_observations(T), dtype=torch.float32,
                       device=device)
    return checkpointed_sharded_particle_filter(
        mesh, seed, spiral_scan_kernel(),
        torch.zeros(2, dtype=torch.float32, device=device),
        Trie.from_dict({"obs": obs[0]}),
        Trie.from_dict({"obs": obs[1:num_steps]}), N,
        checkpoint_path=path, checkpoint_every=CKPT_EVERY,
        resume_from=resume_from, ess_threshold=1.0, auto_batch=True,
        device=device)


CKPT_OUTPUTS = ("state", "log_weights", "log_ml")


def require_same(what, got, want, keys=CKPT_OUTPUTS):
    for k in keys:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs, bitwise")


def time_ckpt_io(device, path):
    """Bytes of the filter's checkpoint, and the median ms of a save and
    of a restore of its carry (the card's state read back, written with
    ``np.savez``; read, copied to the card), each closed by a sync."""
    import os

    from modppl_tpu_torch.inference.vsmc import SMCState
    from modppl_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    g = torch.Generator(device=device)
    g.manual_seed(3)
    s = SMCState((1 << 64) - 5, torch.randn(N, 2, generator=g, device=device),
                 torch.randn(N, generator=g, device=device),
                 torch.zeros((), device=device), T)
    saves, restores = [], []
    for _ in range(CKPT_IO_REPS):
        sync(device)
        t0 = time.perf_counter()
        save_checkpoint(path, s, step=T - 1)
        saves.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got, _ = restore_checkpoint(path, s)
        sync(device)
        restores.append(time.perf_counter() - t0)
        require_same("checkpoint round trip", vars(got), vars(s),
                     ("state", "log_weights", "log_ml"))
        if got.key != s.key or got.t != s.t:
            raise AssertionError("checkpoint round trip: key or t differ")
    return (os.path.getsize(path + ".npz"), statistics.median(saves) * 1e3,
            statistics.median(restores) * 1e3)


def check_ckpt_sharded(device="cuda"):
    """Phase 32 (see the module docstring). Returns what was seen."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        full, launches = counted(lambda: run_ckpt_sharded(device,
                                                          f"{tmp}/full"))
        want = {k: T - 1 for k in SPIRAL_KERNELS}
        require_launches("checkpointed sharded filter", launches, want)
        one_shot = run_filter(device, N, 7, store_ancestry=False)
        require_same("checkpointed sharded filter vs the one-shot filter",
                     full, one_shot)

        def interrupted():
            run_ckpt_sharded(device, f"{tmp}/head", num_steps=CKPT_HEAD + 1)
            return run_ckpt_sharded(device, f"{tmp}/resumed",
                                    resume_from=f"{tmp}/head")

        resumed, launches = counted(interrupted)
        require_launches("head and resumed runs", launches, want)
        require_same("resumed run vs the uninterrupted one", resumed, full)
        with plain_versions():
            plain = run_ckpt_sharded(device, f"{tmp}/plain",
                                     resume_from=f"{tmp}/head")
        require_same("resumed run vs its plain rerun", plain, resumed)
        nbytes, save_ms, restore_ms = time_ckpt_io(device, f"{tmp}/io")
        # turns: one-shot, checkpointed, checkpointed, one-shot
        walls = {"one_shot": [], "ckpt": []}
        run_ckpt_sharded(device, f"{tmp}/warm", seed=100)
        for name in ("one_shot", "ckpt", "ckpt", "one_shot"):
            for i in range(CKPT_TIMED_RUNS):
                sync(device)
                t0 = time.perf_counter()
                if name == "ckpt":
                    run_ckpt_sharded(device, f"{tmp}/timed", seed=101 + i)
                else:
                    run_filter(device, N, 101 + i, store_ancestry=False)
                sync(device)
                walls[name].append(time.perf_counter() - t0)
    return {"launches": launches, "log_ml": float(full["log_ml"]),
            "bytes": nbytes, "save_ms": save_ms, "restore_ms": restore_ms,
            "ckpt_ms": statistics.median(walls["ckpt"]) * 1e3,
            "one_shot_ms": statistics.median(walls["one_shot"]) * 1e3,
            "ckpt_all": walls["ckpt"], "one_shot_all": walls["one_shot"]}


def run_ckpt_vmapped(device, path, num_steps=PF_STEPS, resume_from=None,
                     seed=7):
    """Phase 33's filter: BASELINE configs[2]'s spiral through
    ``checkpointed_particle_filter``, systematic, a checkpoint every
    CKPT_VMAPPED_EVERY steps."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.checkpointed import (
        checkpointed_particle_filter,
    )
    from modppl_tpu_torch.models.spiral import spiral_scan_kernel

    obs = torch.tensor(pf_observations(), dtype=torch.float32, device=device)
    return checkpointed_particle_filter(
        seed, spiral_scan_kernel(),
        torch.zeros(2, dtype=torch.float32, device=device),
        Trie.from_dict({"obs": obs[0]}),
        Trie.from_dict({"obs": obs[1:num_steps]}), PF_PARTICLES,
        checkpoint_path=path, checkpoint_every=CKPT_VMAPPED_EVERY,
        resume_from=resume_from, resampling="systematic", device=device)


def check_ckpt_vmapped(device="cuda"):
    """Phase 33 (see the module docstring). Returns what was seen."""
    import tempfile

    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.checkpointed import (
        checkpointed_particle_filter,
    )
    from modppl_tpu_torch.inference.vsmc import ScanKernel

    with tempfile.TemporaryDirectory() as tmp:
        full, launches = counted(lambda: run_ckpt_vmapped(device,
                                                          f"{tmp}/full"))
        require_launches("checkpointed vmapped filter", launches,
                         {"resample_fused_from_s": PF_STEPS - 1})
        require_same("checkpointed vmapped filter vs particle_filter", full,
                     run_pf_spiral(device, 7))
        run_ckpt_vmapped(device, f"{tmp}/head",
                         num_steps=CKPT_VMAPPED_EVERY + 1)
        resumed = run_ckpt_vmapped(device, f"{tmp}/resumed",
                                   resume_from=f"{tmp}/head")
        require_same("resumed vmapped run vs the uninterrupted one",
                     resumed, full)
        init, step, _ = lg_models()
        ys = torch.tensor(FIVO_YS, dtype=torch.float32, device=device)
        lg, lg_launches = counted(lambda: checkpointed_particle_filter(
            0, ScanKernel(init, step),
            torch.zeros((), dtype=torch.float32, device=device),
            Trie.from_dict({"y": ys[0]}), Trie.from_dict({"y": ys[1:]}),
            CKPT_LG_PARTICLES, checkpoint_path=f"{tmp}/lg",
            checkpoint_every=CKPT_LG_EVERY, device=device))
        require_launches("checkpointed LG filter", lg_launches,
                         {"resample_fused_from_s": len(FIVO_YS) - 1})
        wall, walls = time_runs(lambda i: run_ckpt_vmapped(
            device, f"{tmp}/timed", seed=101 + i), CKPT_TIMED_RUNS, device)
    exact = lg_kalman_log_ml(FIVO_YS)
    seen = {"launches": launches["resample_fused_from_s"], "wall_s": wall,
            "walls": walls,
            "lg_log_ml": float(lg["log_ml"]), "exact": exact,
            "lg_launches": lg_launches["resample_fused_from_s"]}
    if abs(seen["lg_log_ml"] - exact) > CKPT_LG_GAP:
        raise AssertionError(f"checkpointed vmapped LG filter: {seen}")
    return seen


def make_ckpt_hmc(device, path, config=None, num_samples=None):
    """Phase 34's runner: the conjugate model (mu ~ N(0, 1), x ~ N(mu, 1),
    x = 1) through ``checkpointed_hmc_runner``, float32, at ``config``
    (CKPT_HMC by default)."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.dists import normal
    from modppl_tpu_torch.inference.checkpointed import (
        checkpointed_hmc_runner,
    )
    from modppl_tpu_torch.modeling import gen

    @gen
    def conjugate(h):
        mu = h.sample(normal, (0.0, 1.0), "mu")
        h.sample(normal, (mu, 1.0), "x")

    cfg = dict(CKPT_HMC if config is None else config)
    if num_samples is not None:
        cfg["num_samples"] = num_samples
    return checkpointed_hmc_runner(
        conjugate, (), Trie.from_dict({"x": torch.tensor(1.0,
                                                         device=device)}),
        checkpoint_path=path, setup_key=1, device=device, **cfg)


def check_ckpt_hmc(device="cuda"):
    """Phase 34 (see the module docstring). Returns what was seen."""
    import tempfile

    from modppl_tpu_torch.utils.diagnostics import summarize_mcmc

    with tempfile.TemporaryDirectory() as tmp:
        run = make_ckpt_hmc(device, f"{tmp}/full")
        sync(device)
        t0 = time.perf_counter()
        full, launches = counted(lambda: run(2))
        wall = time.perf_counter() - t0
        require_launches("checkpointed HMC runner", launches, {})

        def interrupted():
            head = make_ckpt_hmc(device, f"{tmp}/cut",
                                 num_samples=CKPT_HMC_HEAD)(2)
            tail = make_ckpt_hmc(device, f"{tmp}/cut")(
                2, resume_from=f"{tmp}/cut")
            return head, tail

        (head, tail), launches = counted(interrupted)
        require_launches("checkpointed HMC head and resume", launches, {})
    for what in ("unconstrained", "accept_prob"):
        if not torch.equal(torch.cat([head[what], tail[what]], 1),
                           full[what]):
            raise AssertionError(f"HMC resume: {what} differs from the "
                                 f"uninterrupted run, bitwise")
    if not torch.equal(tail["step_size"], full["step_size"]):
        raise AssertionError("HMC resume: step_size differs, bitwise")
    s = summarize_mcmc(full)["mu"]
    se = s["std"] / math.sqrt(s["ess"])
    seen = {**s, "se": se, "wall_s": wall,
            "accept": float(full["accept_prob"].double().mean()),
            "eps": float(full["step_size"])}
    if (abs(s["mean"] - 0.5) > CKPT_HMC_SE * se
            or abs(s["std"] - math.sqrt(0.5)) > CKPT_HMC_SD_GAP
            or abs(s["r_hat"] - 1.0) > CKPT_HMC_RHAT_GAP):
        raise AssertionError(f"checkpointed HMC posterior: {seen}")
    return seen


_COND_MODEL = {}


def cond_model():
    """Phase 35's model: p ~ bernoulli(0.5), v from Cond(N(2, 0.1),
    N(-2, 0.1)) on p, y ~ N(v, 1)."""
    if not _COND_MODEL:
        from modppl_tpu_torch.dists import bernoulli, normal
        from modppl_tpu_torch.modeling import gen
        from modppl_tpu_torch.modeling.combinators import Cond

        @gen
        def t_branch(h):
            return h.sample(normal, (2.0, 0.1), "v")

        @gen
        def f_branch(h):
            return h.sample(normal, (-2.0, 0.1), "v")

        branch = Cond(t_branch, f_branch)

        @gen
        def model(h):
            p = h.sample(bernoulli, 0.5, "p")
            v = h.trace(branch, (p,), "br")
            h.sample(normal, (v, 1.0), "y")
            return v

        _COND_MODEL["model"] = model
    return _COND_MODEL["model"]


def run_cond(device, key):
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.importance import importance_sampling

    obs = Trie.from_dict({"y": torch.tensor(COND_Y, device=device)})
    return importance_sampling(key, cond_model(), (), obs, COND_LANES,
                               device=device)


def map_inputs(device):
    """Phase 35's plate: Map(point) over MAP_ELEMENTS elements, mu, x and y
    from numpy's default_rng(35), float32."""
    rng = np.random.default_rng(35)
    mu, x = rng.standard_normal(MAP_ELEMENTS), rng.standard_normal(
        MAP_ELEMENTS)
    y = mu * x + 0.1 * rng.standard_normal(MAP_ELEMENTS)
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (mu, x, y)]


def check_combinators_profiling(device="cuda"):
    """Phase 35 (see the module docstring). Returns what was seen."""
    import tempfile

    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.dists import normal
    from modppl_tpu_torch.modeling import gen
    from modppl_tpu_torch.modeling.map_combinator import Map
    from modppl_tpu_torch.utils.profiling import capture_trace

    (traces, lw, _), launches = counted(lambda: run_cond(device, 35))
    require_launches("Cond under importance sampling", launches, {})
    cond_s, _ = time_runs(lambda i: run_cond(device, 40 + i), 3, device)
    w = torch.exp(lw.double())
    est = float(torch.sum(w * traces.data.read("p").double()))
    s = math.sqrt(1.01)
    f = [math.exp(-0.5 * ((COND_Y - m) / s) ** 2) for m in (2.0, -2.0)]
    exact = f[0] / (f[0] + f[1])
    ess = 1.0 / float(torch.sum(w * w))
    se = math.sqrt(exact * (1.0 - exact) / ess)
    if abs(est - exact) > COND_SE * se:
        raise AssertionError(f"Cond: P(p | y) {est} vs exact {exact} (se "
                             f"{se})")

    @gen
    def point(h, mu, x):
        return h.sample(normal, (mu * x, 0.1), "y")

    mu, x, y = map_inputs(device)
    sync(device)
    t0 = time.perf_counter()
    (tr, wt), launches = counted(lambda: Map(point).generate(
        36, (mu, x), Trie.from_dict({"y": y})))
    map_s = time.perf_counter() - t0
    require_launches("Map generate", launches, {})
    m64, x64, y64 = (a.double().cpu().numpy() for a in (mu, x, y))
    want = float(np.sum(-0.5 * ((y64 - m64 * x64) / 0.1) ** 2
                        - math.log(0.1) - 0.5 * math.log(2 * math.pi)))
    rel = abs(float(wt) - want) / abs(want)
    if rel > MAP_RTOL or tr.retv.shape != (MAP_ELEMENTS,):
        raise AssertionError(f"Map generate: weight {float(wt)} vs {want} "
                             f"(relative {rel})")

    with tempfile.TemporaryDirectory() as tmp:
        with capture_trace(f"{tmp}/trace"):
            run_ckpt_sharded(device, f"{tmp}/ckpt", seed=11)
            sync(device)
        with open(f"{tmp}/trace/trace.json") as fh:
            text = fh.read()
    missing = [name for name in SPIRAL_KERNELS
               if KERNEL_SYMBOLS[name] not in text]
    if missing:
        raise AssertionError(f"capture_trace: the trace names no "
                             f"{missing}")
    return {"p": est, "exact": exact, "se": se, "ess": ess, "cond_s": cond_s,
            "map_weight": float(wt), "map_exact": want, "map_rel": rel,
            "map_s": map_s, "trace_bytes": len(text)}


def slice10_phases(card, profile, device="cuda", clock=None):
    """Phases 32-35 (slice 10), with their lines of output; ``profile``
    adds each new configuration's profiler breakdown."""
    import tempfile

    ck = check_ckpt_sharded(device)
    print(f"# main path: the spiral N={N} T={T} float32 through "
          f"checkpointed_sharded_particle_filter, a checkpoint every "
          f"{CKPT_EVERY} steps; launches {ck['launches']} across a head run "
          f"of {CKPT_HEAD} steps and its resume, {T - 1} each "
          f"uninterrupted, no other kernel; uninterrupted == the one-shot "
          f"filter, resumed == uninterrupted, == its plain rerun (no kernel "
          f"launched), bitwise; log_ml {ck['log_ml']!r}")
    print(f"# checkpointed spiral filter: median {ck['ckpt_ms']:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in ck['ckpt_all']]} ms against the "
          f"one-shot filter's {ck['one_shot_ms']:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in ck['one_shot_all']]} ms; a "
          f"checkpoint {ck['bytes']} bytes, {ck['save_ms']:.3f} ms a save, "
          f"{ck['restore_ms']:.3f} ms a restore (median of {CKPT_IO_REPS}) "
          f"({card})")
    if profile:
        with tempfile.TemporaryDirectory() as tmp:
            profile_run("checkpointed spiral filter", lambda: run_ckpt_sharded(
                device, f"{tmp}/p", seed=201), ck["ckpt_ms"] / 1e3)
    sys.stdout.flush()
    if clock:
        clock.mark("32 checkpointed sharded filter")
    cv = check_ckpt_vmapped(device)
    print(f"# main path: the spiral N={PF_PARTICLES} T={PF_STEPS} through "
          f"checkpointed_particle_filter, a checkpoint every "
          f"{CKPT_VMAPPED_EVERY} steps; launches resample_fused_from_s "
          f"{cv['launches']}, no other kernel; == particle_filter("
          f"store_traces=False), resumed == uninterrupted, bitwise; median "
          f"{cv['wall_s'] * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in cv['walls']]} ms; LG at "
          f"N={CKPT_LG_PARTICLES}, every "
          f"{CKPT_LG_EVERY}: log_ml {cv['lg_log_ml']!r} Kalman "
          f"{cv['exact']!r} (kernel 3 {cv['lg_launches']} launches) ({card})")
    if profile:
        with tempfile.TemporaryDirectory() as tmp:
            profile_run("checkpointed vmapped filter", lambda: (
                run_ckpt_vmapped(device, f"{tmp}/p", seed=61)),
                cv["wall_s"])
    sys.stdout.flush()
    if clock:
        clock.mark("33 checkpointed vmapped filter")
    ch = check_ckpt_hmc(device)
    print(f"# main path: checkpointed_hmc_runner on the conjugate model "
          f"{CKPT_HMC} float32, no kernel launched; head of {CKPT_HMC_HEAD} "
          f"samples + resume == uninterrupted, bitwise (unconstrained, "
          f"accept_prob, step_size); mu mean {ch['mean']!r} (0.5, se "
          f"{ch['se']!r}), sd {ch['std']!r} ({math.sqrt(0.5):.5f}), r_hat "
          f"{ch['r_hat']!r}, ESS {ch['ess']:.1f}; accept {ch['accept']!r}, "
          f"eps {ch['eps']!r}; {ch['wall_s'] * 1e3:.1f} ms ({card})")
    if profile:
        with tempfile.TemporaryDirectory() as tmp:
            run = make_ckpt_hmc(device, f"{tmp}/p", CKPT_HMC_PROFILED)
            med, _ = time_runs(lambda i: run(20 + i), 3, device)
            profile_run("checkpointed HMC runner (10 + 20)",
                        lambda: run(99), med)
    sys.stdout.flush()
    if clock:
        clock.mark("34 checkpointed HMC runner")
    cm = check_combinators_profiling(device)
    print(f"# main path: Cond under importance_sampling at N={COND_LANES} "
          f"lanes, no kernel launched: P(p | y={COND_Y}) {cm['p']!r} exact "
          f"{cm['exact']!r} (se {cm['se']!r}, ESS {cm['ess']:.1f}), "
          f"median {cm['cond_s'] * 1e3:.3f} ms; Map generate over {MAP_ELEMENTS} "
          f"elements, no kernel launched: weight {cm['map_weight']!r} vs "
          f"{cm['map_exact']!r} (relative {cm['map_rel']!r}), "
          f"{cm['map_s'] * 1e3:.1f} ms; capture_trace of phase 32's filter "
          f"names kernels 1-3 ({cm['trace_bytes']} bytes) ({card})")
    if profile:
        profile_run("Cond importance (2^20)", lambda: run_cond(device, 99),
                    cm["cond_s"])
    sys.stdout.flush()
    if clock:
        clock.mark("35 combinators, profiling")


# --------------------------------------------------------------------------
# slice 11: lane draws for every distribution, NUTS on a positive-support
# model, the spiral-LGSSM moment gate through kernel 3, the native trie
# --------------------------------------------------------------------------

LANE_DRAWS = 1 << 20
LANE_DRAW_REPS = 3
LANE_ONE = (0, 12345, LANE_DRAWS - 1)
KS_CRIT = 1.95           # sqrt(N) x the Kolmogorov-Smirnov 0.001 value
CHI2_LEVEL = 0.999
# tests/test_hmc_vi.py:28-32's normal_scale_model, observed at its data
SCALE_YS = (0.5, -1.2, 0.8, 2.0, -0.3)
NUTS_POS = dict(num_chains=10_000, num_warmup=200, num_samples=300,
                max_depth=6)
NUTS_POS_GAP = 0.08      # tests/test_hmc_vi.py:68-76's bound
NUTS_POS_SE = 4.0
# tests/test_spiral_lgssm_moments.py at the reference's N and at 2^20
MOMENT_SIZES = (32768, 1 << 20)
MOMENT_T = 12
MOMENT_ML_GAP = 0.1
MOMENT_MEAN_GAP = 0.02
MOMENT_COV_GAP = 5e-4
MOMENT_SMOOTH_GAP = 0.05
MH_TURN_ROUNDS = 50
MH_TURN_RUNS = 2


def lane_draw_cases(device):
    """(name, dist, params, law) of each distribution with a lane form
    from this slice, ``plate`` over one and ``iid(mvnormal, 3)``: ``law``
    is ("cdf", [(column, scipy law)]) for a continuous one, or ("pmf",
    scipy law) for a discrete one."""
    import scipy.stats as st

    from modppl_tpu_torch.dists import (
        beta,
        binomial,
        dirichlet,
        exponential,
        gamma,
        geometric,
        iid,
        laplace,
        mvnormal,
        negative_binomial,
        plate,
        poisson,
        student_t,
        uniform_discrete,
    )

    f32 = dict(dtype=torch.float32, device=device)
    alpha = (2.0, 3.0, 5.0)
    cov = ((1.0, 0.5), (0.5, 2.0))
    return [
        ("uniform_discrete(-3, 7)", uniform_discrete, (-3, 7),
         ("pmf", st.randint(-3, 8))),
        ("geometric(0.25)", geometric, (0.25,),
         ("pmf", st.geom(0.25, loc=-1))),
        ("poisson(4)", poisson, (4.0,), ("pmf", st.poisson(4.0))),
        ("poisson(40)", poisson, (40.0,), ("pmf", st.poisson(40.0))),
        ("gamma(2, 1)", gamma, (2.0, 1.0),
         ("cdf", [(None, st.gamma(2.0, scale=1.0))])),
        ("gamma(0.5, 2)", gamma, (0.5, 2.0),
         ("cdf", [(None, st.gamma(0.5, scale=2.0))])),
        ("beta(2, 5)", beta, (2.0, 5.0), ("cdf", [(None, st.beta(2, 5))])),
        ("exponential(2)", exponential, (2.0,),
         ("cdf", [(None, st.expon(scale=0.5))])),
        ("laplace(1, 2)", laplace, (1.0, 2.0),
         ("cdf", [(None, st.laplace(1.0, 2.0))])),
        ("student_t(7, 0.5, 1.5)", student_t, (7.0, 0.5, 1.5),
         ("cdf", [(None, st.t(7.0, 0.5, 1.5))])),
        ("binomial(10, 0.4)", binomial, (10, 0.4),
         ("pmf", st.binom(10, 0.4))),
        ("binomial(100, 0.7)", binomial, (100, 0.7),
         ("pmf", st.binom(100, 0.7))),
        ("dirichlet(2, 3, 5)", dirichlet, (torch.tensor(alpha, **f32),),
         ("cdf", [(i, st.beta(a, sum(alpha) - a))
                  for i, a in enumerate(alpha)])),
        ("negative_binomial(3, 0.6)", negative_binomial, (3.0, 0.6),
         ("pmf", st.nbinom(3, 0.6))),
        ("plate(gamma, 8)", plate(gamma, 8), (2.0, 1.0),
         ("cdf", [(None, st.gamma(2.0))])),
        ("iid(mvnormal, 3)", iid(mvnormal, 3),
         (torch.tensor((0.0, 1.0), **f32), cov),
         ("cdf", [((slice(None), 0), st.norm(0.0, 1.0)),
                  ((slice(None), 1), st.norm(1.0, math.sqrt(2.0)))])),
    ]


def law_gate(name, x, law):
    """The draws' distance to their law (float64, on the host): the
    Kolmogorov-Smirnov statistic of each column against KS_CRIT /
    sqrt(n), or the chi-square over the bins of expected count >= 5 (the
    rest pooled into the nearest such bin) against its CHI2_LEVEL
    quantile. Returns what was seen; raises past the bound."""
    import scipy.stats as st

    kind, spec = law
    x = x.double().cpu().numpy()
    if kind == "cdf":
        seen = []
        for col, dist in spec:
            v = (x if col is None else x[..., col] if isinstance(col, int)
                 else x[(Ellipsis,) + col]).reshape(-1)
            d = float(st.kstest(v, dist.cdf).statistic)
            bound = KS_CRIT / math.sqrt(v.size)
            seen.append((d, bound))
            if not d < bound:
                raise AssertionError(f"lane draws {name}: KS {d} over "
                                     f"{bound}")
        return {"ks": [s[0] for s in seen], "ks_bound": seen[0][1]}
    k = x.reshape(-1).astype(np.int64)
    n = k.size
    lo, hi = int(spec.ppf(1e-12)), int(spec.ppf(1 - 1e-12)) + 1
    support = np.arange(lo - 1, hi + 2)
    expected = n * spec.pmf(support)
    keep = expected >= 5.0
    first, last = support[keep][0], support[keep][-1]
    observed = np.bincount(np.clip(k, first, last) - first,
                           minlength=last - first + 1).astype(np.float64)
    exp_bins = n * spec.pmf(np.arange(first, last + 1))
    exp_bins[0] += n * spec.cdf(first - 1)
    exp_bins[-1] += n * spec.sf(last)
    chi2 = float(np.sum((observed - exp_bins) ** 2 / exp_bins))
    bound = float(st.chi2.ppf(CHI2_LEVEL, observed.size - 1))
    if not chi2 < bound:
        raise AssertionError(f"lane draws {name}: chi-square {chi2} over "
                             f"{bound} ({observed.size} bins)")
    return {"chi2": chi2, "chi2_bound": bound, "bins": int(observed.size)}


def check_lane_draws(device="cuda"):
    """Phase 36: each lane form of ``lane_draw_cases`` at LANE_DRAWS lanes
    with the counters at 0 (no launch): the first C lanes of a 2C draw and
    lane i's 1-lane draw (i in LANE_ONE) bitwise the C draw's; the law by
    ``law_gate``; the rounds (most and mean an element) and host reads of
    one draw, and the median ms of LANE_DRAW_REPS draws. Returns {case:
    seen}."""
    from modppl_tpu_torch.core.keys import record_rejection, split_keys

    results = {}
    for name, dist, params, law in lane_draw_cases(device):
        keys = split_keys(36, LANE_DRAWS, device)

        def draw(ks):
            return dist.sample_lanes(ks, params)

        with record_rejection() as rec:
            x, launches = counted(lambda: draw(keys))
        require_launches(f"lane draws {name}", launches, {})
        wide = draw(split_keys(36, 2 * LANE_DRAWS, device))
        if not torch.equal(wide[:LANE_DRAWS], x):
            raise AssertionError(f"lane draws {name}: the first C lanes of "
                                 "a 2C draw differ from the C draw")
        for i in LANE_ONE:
            if not torch.equal(draw(keys[i:i + 1])[0], x[i]):
                raise AssertionError(f"lane draws {name}: lane {i} differs "
                                     "from its 1-lane draw")
        if not bool(torch.isfinite(x.double()).all()):
            raise AssertionError(f"lane draws {name}: not finite")
        seen = law_gate(name, x, law)
        ms, times = time_runs(lambda i: draw(keys), LANE_DRAW_REPS, device)
        seen.update(dtype=str(x.dtype).replace("torch.", ""),
                    shape=list(x.shape), max_rounds=rec.max_rounds,
                    mean_rounds=rec.mean_rounds, reads=rec.reads,
                    ms=ms * 1e3, all_ms=[t * 1e3 for t in times])
        results[name] = seen
    return results


def scale_posterior():
    """E and sd of scale | SCALE_YS under normal_scale_model, by the
    reference test's quadrature (tests/test_hmc_vi.py:68-76)."""
    ys = np.asarray(SCALE_YS)
    grid = np.linspace(1e-3, 10.0, 4000)
    logp = (np.log(grid) - grid
            + sum(-0.5 * (y / grid) ** 2 - np.log(grid) for y in ys))
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mean = float((grid * w).sum())
    return mean, float(math.sqrt((w * (grid - mean) ** 2).sum()))


def check_is_scale(device="cuda"):
    """Phase 37a: ``importance_sampling`` of the gamma-prior scale model
    over NUTS_POS's chain count of lanes, with the counters at 0 (no
    launch): gamma's lane form under the model. Every scale > 0; the
    weighted mean within NUTS_POS_GAP and within NUTS_POS_SE posterior sd
    / sqrt(ESS) of the quadrature oracle, ESS = 1 / sum(w^2). Returns what
    was seen."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.importance import importance_sampling

    model = small_models(device)["scale_model"]
    obs = Trie.from_dict({"ys": torch.tensor(SCALE_YS, dtype=torch.float32,
                                             device=device)})
    n = NUTS_POS["num_chains"]
    sync(device)
    t0 = time.perf_counter()
    (traces, lw, _), launches = counted(lambda: importance_sampling(
        37, model, (), obs, n, device=device))
    sync(device)
    wall = time.perf_counter() - t0
    require_launches("importance sampling scale leg", launches, {})
    scales = traces.data.read("scale").double().cpu()
    w = torch.softmax(lw.double().cpu(), 0)
    exact, sd = scale_posterior()
    ess = 1.0 / float((w * w).sum())
    seen = {"mean": float((w * scales).sum()), "exact": exact, "ess": ess,
            "se_bound": NUTS_POS_SE * sd / math.sqrt(ess),
            "min_scale": float(scales.min()), "wall_s": wall}
    gap = abs(seen["mean"] - exact)
    if scales.shape != (n,) or not seen["min_scale"] > 0 \
            or not gap <= NUTS_POS_GAP or not gap <= seen["se_bound"]:
        raise AssertionError(f"importance sampling scale leg: {seen}")
    return seen


def make_nuts_scale(device, **overrides):
    """``nuts_runner`` on normal_scale_model from the reference's start."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.nuts import nuts_runner

    model = small_models(device)["scale_model"]
    obs = Trie.from_dict({"ys": torch.tensor(SCALE_YS, dtype=torch.float32,
                                             device=device)})
    return nuts_runner(model, (), obs, setup_key=99, device=device,
                       **{**NUTS_POS, **overrides})


def check_nuts_scale(device="cuda"):
    """Phase 37: NUTS on the gamma-prior scale model at NUTS_POS with the
    counters at 0 (no launch), timed: every scale > 0; the pooled mean
    within NUTS_POS_GAP and within NUTS_POS_SE posterior sd / sqrt(ESS)
    of the quadrature oracle; divergences below NUTS_MAX_DIVERGENCE.
    Returns what was seen."""
    import importlib

    nuts_mod = importlib.import_module("modppl_tpu_torch.inference.nuts")
    with counting_vag(nuts_mod) as calls, full_fp32():
        run = make_nuts_scale(device)
        sync(device)
        t0 = time.perf_counter()
        out, launches = counted(lambda: run(0))
        wall = time.perf_counter() - t0
    require_launches("nuts scale leg", launches, {})
    scales = out["samples"]["scale"].double().cpu().numpy()
    _, ess = logreg_summary(out)
    exact, sd = scale_posterior()
    mean = float(scales.mean())
    transitions = NUTS_POS["num_warmup"] + NUTS_POS["num_samples"]
    seen = {"mean": mean, "exact": exact, "se_bound":
            NUTS_POS_SE * sd / math.sqrt(ess.min()), "ess": float(ess.min()),
            "min_scale": float(scales.min()),
            "divergence_rate": float(out["divergences"].double().mean()),
            "accept": float(out["accept_prob"].double().mean()),
            "eps": float(out["step_size"]), "vag_calls": calls[0],
            "leaves_a_transition": run.chains.leaves / transitions,
            "wall_s": wall}
    gap = abs(mean - exact)
    if scales.shape != (NUTS_POS["num_chains"], NUTS_POS["num_samples"]) \
            or not seen["min_scale"] > 0 or not gap <= NUTS_POS_GAP \
            or not gap <= seen["se_bound"] \
            or not seen["divergence_rate"] < NUTS_MAX_DIVERGENCE:
        raise AssertionError(f"nuts scale leg: {seen}")
    return seen


def spiral_lgssm(device, dtype=torch.float32):
    """tests/test_spiral_lgssm_moments.py's augmented-state spiral LGSSM
    (state r, theta, 1; the drift enters theta through the constant), in
    ``dtype`` on ``device``."""
    from modppl_tpu_torch.models.lgssm import LGSSMParams

    eps = 1e-10
    arrays = ([[1.0, 0.0, 0.0], [0.0, 1.0, 0.4], [0.0, 0.0, 1.0]],
              np.diag([0.1 ** 2, 0.2 ** 2, eps]),
              [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], 0.15 ** 2 * np.eye(2),
              [0.5, 0.0, 1.0], np.diag([0.05, 0.3, eps]))
    return LGSSMParams(*(torch.as_tensor(np.asarray(a, np.float64),
                                         dtype=dtype, device=device)
                         for a in arrays))


def moment_data(device):
    """T = MOMENT_T observations simulated from the float64 spiral LGSSM
    (key 0) and its exact filter and smoother, on the host."""
    from modppl_tpu_torch.inference.kalman import (
        kalman_filter_parallel,
        kalman_smoother_parallel,
    )
    from modppl_tpu_torch.models.lgssm import lgssm_simulate

    params64 = spiral_lgssm("cpu", torch.float64)
    _, ys = lgssm_simulate(0, params64, MOMENT_T)
    return (ys, kalman_filter_parallel(params64, ys, device="cpu"),
            kalman_smoother_parallel(params64, ys, device="cpu"))


def run_moments(device, n, seed, ys, **kwargs):
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.vsmc import particle_filter
    from modppl_tpu_torch.models.lgssm import lgssm_scan_kernel

    params = spiral_lgssm(device)
    obs = ys.to(torch.float32).to(device)
    return particle_filter(
        seed, lgssm_scan_kernel(params),
        torch.zeros(3, dtype=torch.float32, device=device),
        Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]}),
        n, resampling="systematic", ess_threshold=1.0, store_traces=True,
        device=device, **kwargs)


def moment_gates(out, exact_f, exact_s):
    """The reference test's gates on one filter's output (float64 on the
    host): log-ML, filtered mean and covariance at T, smoothed means along
    the ancestry. Returns the gaps; raises past a bound."""
    lw = out["log_weights"].double().cpu()
    w = torch.softmax(lw, 0)
    xT = out["state"].double().cpu()
    mean_T = w @ xT
    cov_T = (w[:, None] * (xT - mean_T)).T @ (xT - mean_T)
    states = torch.cat([out["init_traces"].retv[None],
                        out["step_traces"].retv]).double().cpu()
    ancestors = out["ancestors"].long().cpu()
    idx = torch.arange(states.shape[1])
    traj = torch.empty_like(states)
    for t in range(states.shape[0] - 1, -1, -1):
        traj[t] = states[t][idx]
        if t > 0:
            idx = ancestors[t - 1][idx]
    smoothed = torch.einsum("n,tnd->td", w, traj)
    gaps = {"log_ml": abs(float(out["log_ml"]) - float(exact_f["log_ml"])),
            "mean_T": float((mean_T[:2] - exact_f["means"][-1, :2]).abs()
                            .max()),
            "cov_T": float((cov_T[:2, :2] - exact_f["covs"][-1, :2, :2])
                           .abs().max()),
            "smoothed": float((smoothed[:, :2] - exact_s["means"][:, :2])
                              .abs().max())}
    bounds = {"log_ml": MOMENT_ML_GAP, "mean_T": MOMENT_MEAN_GAP,
              "cov_T": MOMENT_COV_GAP, "smoothed": MOMENT_SMOOTH_GAP}
    for k, b in bounds.items():
        if not gaps[k] <= b:
            raise AssertionError(f"spiral LGSSM moments: {k} gap "
                                 f"{gaps[k]} over {b} ({gaps})")
    return gaps


def check_moments(device="cuda"):
    """Phase 38a: the spiral-LGSSM moment gate through the vmapped filter
    (store_traces, systematic) at each N of MOMENT_SIZES with the counters
    at 0: MOMENT_T - 1 launches of kernel 3 and none other, the reference
    test's gates, and every output bitwise equal to its rerun through the
    plain versions on the recorded draws; the peak device memory of the
    run (the stored traces at 2^20 x 12 x 3 float32 are 151 MB); timed.
    Returns {N: seen}."""
    ys, exact_f, exact_s = moment_data(device)
    seen = {}
    for n in MOMENT_SIZES:
        record = []
        torch.cuda.reset_peak_memory_stats() if device == "cuda" else None
        out, launches = counted(lambda: run_moments(device, n, 1, ys,
                                                    record=record))
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        require_launches(f"spiral LGSSM moments N={n}", launches,
                         {"resample_fused_from_s": MOMENT_T - 1})
        gaps = moment_gates(out, exact_f, exact_s)
        with plain_versions():
            plain = run_moments(device, n, 2, ys, replay=record)
        for what in ("state", "log_weights", "log_ml", "ancestors", "ess",
                     "resampled"):
            if not torch.equal(out[what], plain[what]):
                raise AssertionError(f"spiral LGSSM moments N={n}: {what} "
                                     "differs from its rerun through the "
                                     "plain versions")
        for part in ("init_traces", "step_traces"):
            if not torch.equal(out[part].retv, plain[part].retv):
                raise AssertionError(f"spiral LGSSM moments N={n}: {part} "
                                     "differ from the plain rerun's")
        ms, times = time_runs(lambda i: run_moments(device, n, 40 + i, ys),
                              3, device)
        traces_mb = (n * MOMENT_T * 3 * 4) / 1e6
        seen[n] = {"gaps": gaps, "launches": launches[
            "resample_fused_from_s"], "log_ml": float(out["log_ml"]),
            "exact_log_ml": float(exact_f["log_ml"]), "peak_mb": peak / 1e6,
            "traces_mb": traces_mb, "ms": ms * 1e3,
            "all_ms": [t * 1e3 for t in times]}
    return seen


MH_TURN_CODE = r"""
import json, statistics, sys, time, torch
import chip_smoke as cs
from modppl_tpu_torch.core import trie
if {pure}:
    # every name Trie in the package is PureTrie from here on: new tries,
    # function-level imports and isinstance checks alike
    native_cls = trie.Trie
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("modppl_tpu_torch")
                and getattr(mod, "Trie", None) is native_cls):
            mod.Trie = trie.PureTrie
_, _, acc = cs.run_mh_chain({device!r}, 5, 1)
from modppl_tpu_torch.models import hierarchical_model
tr, _ = hierarchical_model.generate(0, (list(cs.IS_XS),),
                                    cs.hierarchical_obs(), device={device!r})
times = []
for i in range({runs}):
    cs.sync({device!r})
    t0 = time.perf_counter()
    gates, coeffs, acc = cs.run_mh_chain({device!r}, {rounds}, 30 + i)
    cs.sync({device!r})
    times.append(time.perf_counter() - t0)
print(json.dumps({{"trie": type(tr.data).__name__, "times": times,
                  "chain": [gates.tolist(), coeffs.tolist(), acc]}}))
"""


def mh_turns(device="cuda"):
    """Phase 38b: MH at BASELINE configs[1]'s schedule on the native trie
    and on ``PureTrie``, each turn a process of its own, in turns pure,
    native, native, pure: MH_TURN_RUNS timed chains of MH_TURN_ROUNDS
    rounds each. A pure turn rebinds every name ``Trie`` of the package
    to ``PureTrie`` before its first trie is made (the address layer is C
    in both). Each turn must report its traces' trie class, and every
    turn's last chain must be the same, value for value. Returns {path:
    [ms a transition, a turn's median]}."""
    import os

    per = MH_TURN_ROUNDS * (MH_DRIFTS + 2)
    out = {"pure": [], "native": [], "turn_s": []}
    chains = []
    for path in ("pure", "native", "native", "pure"):
        code = MH_TURN_CODE.format(runs=MH_TURN_RUNS, rounds=MH_TURN_ROUNDS,
                                   device=device, pure=path == "pure")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError(f"MH turn ({path}) failed:\n{proc.stderr}")
        seen = json.loads(proc.stdout.strip().splitlines()[-1])
        want = "PureTrie" if path == "pure" else "Trie"
        if seen["trie"] != want:
            raise AssertionError(f"MH turn ({path}): traces of "
                                 f"{seen['trie']}, not {want}")
        chains.append(json.dumps(seen["chain"]))
        out[path].append(statistics.median(seen["times"]) / per * 1e3)
        out["turn_s"].append(time.perf_counter() - t0)
    if len(set(chains)) != 1:
        raise AssertionError("MH turns: the pure and native tries gave "
                             "different chains")
    return out


def hand_mixture():
    """A hand-coded GenFn (no @gen body): z ~ bernoulli(0.3), x ~ N(2 if z
    else -1, 1), scored from its constraints, its data the trie."""
    from modppl_tpu_torch.core.gfi import GenFn, Trace
    from modppl_tpu_torch.dists import bernoulli, normal

    class HandMixture(GenFn):
        def generate(self, key, args, constraints, device=None):
            z, x = constraints.read("z"), constraints.read("x")
            p = torch.full((), 0.3, dtype=torch.float64, device=x.device)
            mu = torch.where(z, torch.full_like(p, 2.0),
                             torch.full_like(p, -1.0))
            w = bernoulli.logpdf(z, (p,)) + normal.logpdf(x, (mu, 1.0))
            return Trace(args, constraints, None, w), w

    return HandMixture()


def check_enumerate_hand(device="cuda"):
    """Phase 38c: ``enumerate_posterior`` over ``hand_mixture`` on the card
    with the counters at 0 (no launch): the log evidence and P(z | x = 1)
    within 1e-12 of their closed forms (float64)."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.enumerate import enumerate_posterior

    obs = Trie.from_dict({"x": torch.tensor(1.0, dtype=torch.float64,
                                            device=device)})
    res, launches = counted(lambda: enumerate_posterior(
        hand_mixture(), (), obs, {"z": torch.tensor([False, True],
                                                   device=device)},
        device=device))
    require_launches("enumerate over a hand-coded GenFn", launches, {})
    like = [math.exp(-0.5 * (1.0 - m) ** 2) / math.sqrt(2 * math.pi)
            for m in (-1.0, 2.0)]
    joint = [0.7 * like[0], 0.3 * like[1]]
    log_ml = math.log(sum(joint))
    p1 = joint[1] / sum(joint)
    seen = {"log_ml": float(res["log_ml"]), "exact": log_ml,
            "p_z": float(res["marginals"]["z"][1]), "exact_p_z": p1}
    if not (abs(seen["log_ml"] - log_ml) < 1e-12
            and abs(seen["p_z"] - p1) < 1e-12):
        raise AssertionError(f"enumerate over a hand-coded GenFn: {seen}")
    return seen


def require_native():
    """The native trie and address layer must be active on this machine
    (the package does not import without them; this names them)."""
    from modppl_tpu_torch import native
    from modppl_tpu_torch.core import trie

    if not (native.HAVE_NATIVE and native.HAVE_NATIVE_TRIE
            and trie.Trie.__mro__[2] is native.ctrie.CTrieBase):
        raise AssertionError(f"native layer not active: {native.BUILD_ERROR}")
    return trie.Trie.__mro__[2].__name__


def slice11_phases(card, profile, device="cuda", clock=None):
    """Phases 36-38 (slice 11), with their lines of output; ``profile``
    adds each new configuration's profiler breakdown."""
    base = require_native()
    print(f"# native layer: addrops and ctrie built from "
          f"modppl_tpu_torch/native/ (Trie's node core {base})")
    draws = check_lane_draws(device)
    for name, s in draws.items():
        law = (f"KS {[round(d, 6) for d in s['ks']]} < {s['ks_bound']:.6f}"
               if "ks" in s else f"chi-square {s['chi2']:.2f} < "
               f"{s['chi2_bound']:.2f} over {s['bins']} bins")
        print(f"# lane draws {name} at C={LANE_DRAWS} {s['dtype']} "
              f"{s['shape']}, no kernel launched: == the first C of 2C and "
              f"the 1-lane draws, bitwise; {law}; rounds max "
              f"{s['max_rounds']} mean {s['mean_rounds']:.4f}, host reads "
              f"{s['reads']}; median {s['ms']:.3f} ms of "
              f"{[round(t, 3) for t in s['all_ms']]} ({card})")
    if profile:
        from modppl_tpu_torch.core.keys import split_keys
        from modppl_tpu_torch.dists import gamma

        keys = split_keys(36, LANE_DRAWS, device)
        profile_run("gamma lane draw (2^20)", lambda: gamma.sample_lanes(
            keys, (2.0, 1.0)), draws["gamma(2, 1)"]["ms"] / 1e3)
    sys.stdout.flush()
    if clock:
        clock.mark("36 lane draws")
    im = check_is_scale(device)
    print(f"# main path: importance_sampling of the gamma-prior scale model "
          f"over {NUTS_POS['num_chains']} lanes float32 (gamma's lane form), "
          f"no kernel launched; weighted mean scale {im['mean']!r} "
          f"quadrature {im['exact']!r} (bounds {NUTS_POS_GAP}, "
          f"{im['se_bound']!r} at ESS {im['ess']:.1f}); min scale "
          f"{im['min_scale']!r}; {im['wall_s'] * 1e3:.3f} ms ({card})")
    nu = check_nuts_scale(device)
    print(f"# main path: NUTS on the gamma-prior scale model {NUTS_POS} "
          f"float32 through nuts_runner from the reference's start, no "
          f"kernel launched; "
          f"mean scale {nu['mean']!r} quadrature {nu['exact']!r} (bounds "
          f"{NUTS_POS_GAP}, {nu['se_bound']!r}); min scale "
          f"{nu['min_scale']!r}; divergences {nu['divergence_rate']!r}; "
          f"accept {nu['accept']!r}; eps {nu['eps']!r}")
    print(f"# nuts scale leg: {nu['wall_s'] * 1e3:.3f} ms (one timed run); "
          f"ESS {nu['ess']:.1f} -> {nu['ess'] / nu['wall_s']:.1f} ESS/s; "
          f"{nu['leaves_a_transition']:.3f} leaves a transition, "
          f"{nu['vag_calls']} value-and-grad calls "
          f"({nu['wall_s'] * 1e3 / nu['vag_calls']:.4f} ms a call) ({card})")
    if profile:
        run = make_nuts_scale(device, num_warmup=3, num_samples=3)
        with full_fp32():
            med, _ = time_runs(lambda i: run(20 + i), 2, device)
            profile_run("nuts scale leg (3 + 3)", lambda: run(7), med)
    sys.stdout.flush()
    if clock:
        clock.mark("37 NUTS scale leg")
    mo = check_moments(device)
    for n, s in mo.items():
        print(f"# main path: spiral LGSSM moments N={n} T={MOMENT_T} "
              f"float32 through particle_filter(store_traces=True), "
              f"systematic; launches resample_fused_from_s {s['launches']}, "
              f"no other kernel; gaps {s['gaps']} (bounds {MOMENT_ML_GAP}, "
              f"{MOMENT_MEAN_GAP}, {MOMENT_COV_GAP}, {MOMENT_SMOOTH_GAP}); "
              f"log_ml {s['log_ml']!r} Kalman {s['exact_log_ml']!r}; == its "
              f"rerun through the plain versions on the recorded draws, "
              f"bitwise; peak device memory {s['peak_mb']:.1f} MB "
              f"(stored states {s['traces_mb']:.1f} MB); median "
              f"{s['ms']:.3f} ms of {[round(t, 3) for t in s['all_ms']]} "
              f"({card})")
    if profile:
        ys, _, _ = moment_data(device)
        for n in MOMENT_SIZES:
            profile_run(f"spiral LGSSM moments N={n}", lambda: run_moments(
                device, n, 61, ys), mo[n]["ms"] / 1e3)
    if clock:
        clock.mark("38a spiral LGSSM moments")
    mh = mh_turns(device)
    print(f"# MH at BASELINE configs[1]'s schedule ({MH_TURN_ROUNDS} rounds "
          f"x {MH_TURN_RUNS} a turn), turns pure, native, native, pure: ms "
          f"a transition native {[round(t, 4) for t in mh['native']]}, pure "
          f"{[round(t, 4) for t in mh['pure']]}; each turn's process "
          f"{[round(t, 1) for t in mh['turn_s']]} s ({card})")
    en = check_enumerate_hand(device)
    print(f"# enumerate_posterior over a hand-coded GenFn on the card, no "
          f"kernel launched: log_ml {en['log_ml']!r} exact {en['exact']!r}; "
          f"P(z | x) {en['p_z']!r} exact {en['exact_p_z']!r}")
    sys.stdout.flush()
    if clock:
        clock.mark("38b MH turns, enumerate")


# --------------------------------------------------------------------------
# slice 12: layout invariance and multi-device (phases 39-42)
# --------------------------------------------------------------------------

# gloo ranks sharing the one card: NCCL refuses two ranks on one GPU, so
# the ranks' times are those of four processes on one H100, not of four
# cards
SHARD_WORLD = 4
SHARD_TIMEOUT = 480.0             # the whole group, spawns included
SHARD_COLLECTIVE_TIMEOUT = 240.0  # any one collective
SHARD_TIMED_RUNS = 3
SHARD_HMC = dict(num_chains=10_000, num_warmup=60, num_samples=40)
# a power-of-two run, where the pooled sums' trees are the same at any
# power-of-two dp (10^4 chains over 4 ranks is 2500 a rank, whose local
# trees are not the global tree's subtrees)
SHARD_HMC_POW2 = dict(num_chains=8192, num_warmup=20, num_samples=10)
SHARD_HMC_SE = 4.0
SHARD_GUIDED_SEED = 7
FILTER_DIGESTS = ("state", "log_weights", "log_ml", "ancestors", "ess",
                  "resampled")
GUIDED_DIGESTS = ("state", "log_weights", "log_ml", "ess", "acceptance")
CHAIN_DIGESTS = ("step_size", "unconstrained", "accept_prob")


def digest(t):
    """A short hash of a tensor's dtype, shape and bytes (bitwise equality
    across processes)."""
    import hashlib

    t = torch.as_tensor(t).detach().cpu().contiguous()
    h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


def whole_outputs(mesh, out):
    """A filter's outputs with the shard's per-particle ones gathered whole
    (in shard order; ``mesh`` None: as they are)."""
    res = dict(out)
    if mesh is None:
        return res
    for k in ("state", "log_weights"):
        res[k] = mesh.gather(out[k])
    if out.get("ancestors") is not None:
        res["ancestors"] = mesh.gather(out["ancestors"].t().contiguous()).t()
    return res


def digests_of(out, keys):
    return {k: digest(out[k]) for k in keys if out.get(k) is not None}


def sharded_plain_versions():
    """Kernels 1-4's plain versions where the sharded filter calls them:
    kernels 1-2 everywhere, kernel 3 on one shard, kernel 4 (the parents
    from the gathered S) on several."""
    from modppl_tpu_torch.ops import fused_resample as fr
    from modppl_tpu_torch.ops import grid_positions as gp
    from modppl_tpu_torch.ops import resample as rs
    from modppl_tpu_torch.parallel import resample
    from modppl_tpu_torch.parallel import sharded_smc as smc

    return swapped([(smc, "stats_cumsum", gp.stats_cumsum_plain),
                    (smc, "positions_cummax", gp.positions_cummax_plain),
                    (smc, "grid_rank", rs.grid_rank_plain),
                    (resample, "resample_fused_from_s",
                     fr.resample_fused_plain),
                    (fr, "resample_fused_from_s", fr.resample_fused_plain)])


def shard_hmc_target(device):
    """hmc-hierarchical-d3's target (bench.py:65-125): the static
    hierarchical model on hierarchical_data, the gate observed."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.models.hierarchical_static import (
        make_hierarchical_static,
    )

    xs, ys = hierarchical_data(device)
    return (make_hierarchical_static(10), (xs,),
            Trie.from_dict({"ys": ys, "is_linear": False}))


def shard_chains(mesh, sampler, device, config=None):
    """``shardmap_hmc`` or ``shardmap_chees`` at ``config`` (SHARD_HMC by
    default) over ``mesh``'s dp axis, key 42 (the generic path: no
    kernel)."""
    from modppl_tpu_torch.parallel import distributed

    model, args, obs = shard_hmc_target(device)
    fn = (distributed.shardmap_hmc if sampler == "hmc"
          else distributed.shardmap_chees)
    kw = dict(config or SHARD_HMC, device=device)
    if sampler == "hmc":
        kw["num_leapfrog"] = LEGS["hierarchical"]["num_leapfrog"]
    return fn(mesh, 42, model, args, obs, **kw)


def timed_sharded(fn, mesh, device, runs=SHARD_TIMED_RUNS):
    """Wall ms of ``fn(i)`` on this rank, every rank of ``mesh`` starting
    together (a barrier) and the device synchronised after: one warm-up,
    then ``runs`` timed."""
    from modppl_tpu_torch.parallel.collectives import barrier

    times = []
    for i in range(runs + 1):
        if mesh is not None:
            with mesh:
                barrier("dp")
        sync(device)
        t0 = time.perf_counter()
        fn(i)
        sync(device)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def shard_spiral(mesh, device, **kw):
    """Phase 39's run over ``mesh`` (None: one device): the spiral at
    2^20 x 10, key 7, counted; then its rerun through the plain versions;
    the collectives' counts and the exchanges of the counted run. Returns
    a dict of what the rank saw."""
    from modppl_tpu_torch.parallel import collectives
    from modppl_tpu_torch.parallel import sharded_smc as smc

    collectives.reset_counts()
    smc.exchanges.update(halo=0, ring=0)
    out, launches = counted(lambda: run_filter(device, N, 7, mesh=mesh,
                                               **kw))
    moved = collectives.counts()
    exchanges = dict(smc.exchanges)
    whole = whole_outputs(mesh, out)
    with sharded_plain_versions():
        plain = whole_outputs(mesh, run_filter(device, N, 7, mesh=mesh,
                                               **kw))
    return {"digests": digests_of(whole, FILTER_DIGESTS),
            "plain_digests": digests_of(plain, FILTER_DIGESTS),
            "launches": launches, "moved": moved, "exchanges": exchanges,
            "log_ml": float(out["log_ml"]),
            "resampled": int(out["resampled"].sum())}


def slice12_rank(rank, world, workdir, device, n, num_chains,
                 backend="gloo"):
    """One rank of phases 39-42's group (``python3 chip_smoke.py
    --slice12-rank <rank> <world> <workdir> <device> <N> <chains>
    <backend>``, as ``spawn_shards`` starts it): the dp = 2 (ranks 0-1)
    and dp = world runs of N particles and ``num_chains`` chains, on the
    card this rank shares with the others over gloo, or on its own card
    over nccl (``device="cpu"`` rehearses on the CPU). Rank 0 writes what
    it saw to ``workdir/slice12.json`` and phase 42's chains to
    ``workdir/chains.npz``."""
    global N
    N = int(n)
    SHARD_HMC["num_chains"] = int(num_chains)
    from modppl_tpu_torch.parallel import sharded_smc as smc
    from modppl_tpu_torch.parallel.collectives import barrier
    from modppl_tpu_torch.parallel.mesh import initialize_runtime, make_mesh

    initialize_runtime(f"file://{workdir}/store", world, rank,
                       backend=backend, timeout=SHARD_COLLECTIVE_TIMEOUT)
    meshes = {2: make_mesh(dp=2, ranks=[0, 1]), world: make_mesh(dp=world)}
    seen, chains = {}, {}
    t0 = time.perf_counter()
    for dp, mesh in meshes.items():
        if not mesh.member:
            continue
        s = shard_spiral(mesh, device)
        s["ms"] = timed_sharded(lambda i: run_filter(
            device, N, 101 + i, mesh=mesh, store_ancestry=False), mesh,
            device)
        seen[f"39/dp{dp}"] = s
    seen["39/seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = meshes[world]
    seen[f"40/threshold/dp{world}"] = shard_spiral(mesh, device,
                                                   ess_threshold=0.5)
    seen[f"40/halo1/dp{world}"] = shard_spiral(mesh, device, halo=1)
    if meshes[2].member:
        out, launches = counted(lambda: run_guided(
            device, N, SHARD_GUIDED_SEED, mesh=meshes[2]))
        whole = whole_outputs(meshes[2], out)
        with sharded_plain_versions():
            plain = whole_outputs(meshes[2], run_guided(
                device, N, SHARD_GUIDED_SEED, mesh=meshes[2]))
        seen["40/guided/dp2"] = {
            "digests": digests_of(whole, GUIDED_DIGESTS),
            "plain_digests": digests_of(plain, GUIDED_DIGESTS),
            "launches": launches, "log_ml": float(out["log_ml"]),
            "ms": timed_sharded(lambda i: run_guided(
                device, N, 101 + i, mesh=meshes[2]), meshes[2], device)}
    seen["40/seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if meshes[2].member:
        path = f"{workdir}/ckpt_dp2"
        head, launches = counted(lambda: run_ckpt_sharded(
            device, path, num_steps=CKPT_HEAD + 1, mesh=meshes[2]))
        resumed, more = counted(lambda: run_ckpt_sharded(
            device, path, resume_from=path, mesh=meshes[2]))
        whole = whole_outputs(meshes[2], resumed)
        seen["41/dp2"] = {"digests": digests_of(whole, CKPT_OUTPUTS),
                          "t": int(resumed["t"]),
                          "launches": {k: launches[k] + more[k]
                                       for k in launches}}
    seen["41/seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for sampler in ("hmc", "chees"):
        with mesh:
            barrier("dp")
        c0 = time.perf_counter()
        out, launches = counted(lambda: shard_chains(mesh, sampler, device))
        ms = [(time.perf_counter() - c0) * 1e3]
        for k in CHAIN_DIGESTS:
            v = out[k]
            chains[f"{sampler}/{k}"] = (mesh.gather(v) if v.ndim else v)
        pow2 = shard_chains(mesh, sampler, device, SHARD_HMC_POW2)
        seen[f"42/{sampler}/dp{world}"] = {
            "launches": launches, "ms": ms,
            "pow2": digests_of({k: mesh.gather(pow2[k]) if pow2[k].ndim
                                else pow2[k] for k in CHAIN_DIGESTS},
                               CHAIN_DIGESTS)}
    seen["42/seconds"] = time.perf_counter() - t0
    from modppl_tpu_torch.parallel import collectives

    seen["gloo_cuda_ops"] = sorted(collectives.GLOO_CUDA_OPS)
    seen["exchanges_total"] = dict(smc.exchanges)
    if rank == 0:
        np.savez(f"{workdir}/chains.npz",
                 **{k: v.cpu().numpy() for k, v in chains.items()})
        with open(f"{workdir}/slice12.json", "w") as f:
            json.dump(seen, f)
    # every rank past its last collective before any closes its links
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def spawn_shards(workdir, world=SHARD_WORLD, device="cuda", backend="gloo",
                 timeout=SHARD_TIMEOUT):
    """Run ``slice12_rank`` on ``world`` ranks over ``backend``; every rank
    is killed if the group has not ended within ``timeout`` s. Returns
    (rank 0's json, its chains, the group's seconds)."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--slice12-rank",
         str(r), str(world), workdir, device, str(N),
         str(SHARD_HMC["num_chains"]), backend], env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            left = max(timeout - (time.perf_counter() - t0), 1.0)
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"phases 39-42: the {world} ranks did not end "
                             f"within {timeout} s; every rank killed")
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"phases 39-42: rank {r} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
    with open(f"{workdir}/slice12.json") as f:
        seen = json.load(f)
    with np.load(f"{workdir}/chains.npz") as data:
        chains = {k: data[k] for k in data.files}
    return seen, chains, time.perf_counter() - t0


def require_digests(what, got, want):
    for k, d in want.items():
        if got.get(k) != d:
            raise AssertionError(f"{what}: {k} differs bitwise "
                                 f"({got.get(k)} against {d})")


def kernel_us_at(n_local, n=N):
    """Kernels 1-2's device µs at a shard's rows (n_local / 1024 rows of
    1024) of an N-particle filter, one process, CUDA events, L2 flushed."""
    from modppl_tpu_torch.ops import grid_positions as gp
    from modppl_tpu_torch.parallel import sharded_smc as smc

    lw = make_lw("uniform", n_local, 0, "cuda")
    rows, m = lw.reshape(-1, smc._cdf_block(n)), lw.max()
    cum, totals, _ = gp.stats_cumsum_plain(rows, m)
    offs = torch.cat([totals.new_zeros(1),
                      gp.doubling_cumsum(totals[None, :])[0][:-1]])
    total = offs[-1] + totals[-1]
    u = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    return {"stats_cumsum": 1e3 * time_ms(lambda: gp.stats_cumsum(rows, m)),
            "positions_cummax": 1e3 * time_ms(lambda: gp.positions_cummax(
                cum, offs, total, u, n))}


def pooled_sum_split(device, c, shards, width=7):
    """The largest difference between ``adaptation._pooled_sum`` of a (c,
    width) batch on one device and over ``shards`` shards (each shard's
    tree-partial, then the tree over the partials, as the sharded sum adds
    them): 0 where the local trees are the global tree's subtrees."""
    from modppl_tpu_torch.inference.adaptation import _pooled_sum, _tree_sum

    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(c, width, generator=g, device=device)
    m = c // shards
    split = _tree_sum(torch.stack([_tree_sum(x[i * m:(i + 1) * m])
                                   for i in range(shards)]))
    return float((_pooled_sum(x) - split).abs().max())


def batch_invariance(device, c, c_local):
    """The largest differences between the hierarchical target's batched
    value-and-grad (and the iid plate's sum over its 10 points, the one
    reduction of its log-density) on ``c`` chains and on their first
    ``c_local``: where they are 0 the model is bitwise in the batch
    size."""
    from modppl_tpu_torch.dists import iid, normal
    from modppl_tpu_torch.inference.hmc import _value_and_grad, flat_target

    model, args, obs = shard_hmc_target(device)
    tr, _ = model.generate(42, args, obs, device=device)
    vag = _value_and_grad(flat_target(model, args, tr, obs,
                                      device=device).logprob)
    g = torch.Generator(device=device).manual_seed(0)
    us = torch.randn(c, 3, generator=g, device=device)
    lp, gr = vag(us)
    lp_l, gr_l = vag(us[:c_local].clone())
    xs = args[0]
    mean = us[:, :1] + us[:, 1:2] * xs + us[:, 2:3] * xs * xs
    plate = iid(normal, xs.shape[0])
    s = plate.logpdf(obs["ys"], (mean, 0.1))
    s_l = plate.logpdf(obs["ys"], (mean[:c_local].clone(), 0.1))
    return {"logp": float((lp[:c_local] - lp_l).abs().max()),
            "grad": float((gr[:c_local] - gr_l).abs().max()),
            "iid_sum": float((s[:c_local] - s_l).abs().max())}


def chain_summary(us):
    """(posterior mean (3,), min-coordinate ESS) of (chains, samples, 3)
    draws, float64."""
    from modppl_tpu_torch.utils.diagnostics import ess_autocorr

    us = np.asarray(us, dtype=np.float64)
    ess = np.array([ess_autocorr(us[:, :, j]) for j in range(us.shape[-1])])
    return us.reshape(-1, us.shape[-1]).mean(0), ess


def slice12_phases(card, profile, device="cuda", clock=None,
                   backend="gloo"):
    """Phases 39-42 (slice 12), with their lines of output: the dp = 1
    runs here, the dp = 2 and dp = 4 runs on SHARD_WORLD ranks (spawned
    once for the four phases), every output held bitwise to dp = 1 and
    each rank's run to its plain rerun. With ``backend="gloo"`` (the
    script's) the ranks share this card; with ``"nccl"`` each rank owns
    card ``rank`` (four cards). ``profile`` is accepted for the phase
    groups' common signature; these phases are timed, not profiled."""
    import tempfile

    from modppl_tpu_torch.parallel import sharded_smc as smc
    from modppl_tpu_torch.parallel.mesh import make_mesh

    world = SHARD_WORLD
    t0 = time.perf_counter()
    one = shard_spiral(None, device)
    one["ms"] = timed_sharded(lambda i: run_filter(
        device, N, 101 + i, store_ancestry=False), None, device)
    thr = shard_spiral(None, device, ess_threshold=0.5)
    g_out, g_launches = counted(lambda: run_guided(device, N,
                                                   SHARD_GUIDED_SEED))
    guided = digests_of(whole_outputs(None, g_out), GUIDED_DIGESTS)
    guided_ms = timed_sharded(lambda i: run_guided(device, N, 101 + i), None,
                              device)
    with tempfile.TemporaryDirectory() as tmp:
        ck = run_ckpt_sharded(device, f"{tmp}/full")
    ckpt = digests_of(ck, CKPT_OUTPUTS)
    ref_chains, ref_ms, ref_pow2 = {}, {}, {}
    for sampler in ("hmc", "chees"):
        c0 = time.perf_counter()
        out, launches = counted(lambda: shard_chains(make_mesh(), sampler,
                                                     device))
        ref_ms[sampler] = (time.perf_counter() - c0) * 1e3
        require_launches(f"phase 42 {sampler} dp=1", launches, {})
        ref_chains[sampler] = {k: out[k].cpu().numpy()
                               for k in CHAIN_DIGESTS}
        ref_pow2[sampler] = digests_of(shard_chains(
            make_mesh(), sampler, device, SHARD_HMC_POW2), CHAIN_DIGESTS)
    us_at = {n_local: (kernel_us_at(n_local) if device == "cuda" else {})
             for n_local in (N // 2, N // world)}
    parent_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as workdir:
        seen, chains, group_s = spawn_shards(workdir, world, device,
                                             backend)
    where = (f"{world} {backend} ranks sharing one card" if backend == "gloo"
             else f"{world} {backend} ranks, a card each")

    # phase 39: the sharded spiral, dp = 1, 2, 4
    want = {"stats_cumsum": T - 1, "positions_cummax": T - 1}
    require_launches("phase 39 dp=1", one["launches"],
                     {**want, "resample_fused_from_s": T - 1})
    require_digests("phase 39 dp=1 plain rerun", one["plain_digests"],
                    one["digests"])
    for dp in (2, world):
        s = seen[f"39/dp{dp}"]
        require_launches(f"phase 39 dp={dp}", s["launches"],
                         {**want, "grid_rank": T - 1})
        require_digests(f"phase 39 dp={dp}", s["digests"], one["digests"])
        require_digests(f"phase 39 dp={dp} plain rerun", s["plain_digests"],
                        one["digests"])
        moved = s["moved"]
        per_step = {op: c["bytes"] / (T - 1) for op, c in moved.items()
                    if isinstance(c, dict)}
        if max(c["max_bytes"] for op, c in moved.items()
               if isinstance(c, dict) and op == "all_gather") > 4 * N:
            raise AssertionError(f"phase 39 dp={dp}: an all_gather larger "
                                 f"than the O(N) int32 S: {moved}")
        print(f"# main path: sharded spiral filter N={N} T={T} float32 at "
              f"dp={dp} over {dp} of {where}; launches a "
              f"rank {s['launches']['stats_cumsum']}, "
              f"{s['launches']['positions_cummax']}, grid_rank "
              f"{s['launches']['grid_rank']}, kernel 3 "
              f"{s['launches']['resample_fused_from_s']}; == dp=1 bitwise on "
              f"{list(one['digests'])}, == its plain rerun bitwise; log_ml "
              f"{s['log_ml']!r}; exchanges {s['exchanges']}; bytes a step "
              f"received a rank {per_step}; host copies "
              f"{moved['host_copies']} (under gloo the ppermutes' tensors, "
              f"which its send and recv take only from the host); wall ms "
              f"{[round(t, 3) for t in s['ms']]} (rank 0) ({card})")
    print(f"# main path: the same spiral at dp=1 (mesh None): launches "
          f"{ {k: v for k, v in one['launches'].items() if v} }; log_ml "
          f"{one['log_ml']!r} (phase 4's run, key 7, met its CPU-replay "
          f"gate {LOG_ML_GAP}); wall ms {[round(t, 3) for t in one['ms']]}; "
          f"kernels 1-2 µs at n_local {N // 2}: "
          f"{ {k: round(v, 2) for k, v in us_at[N // 2].items()} }, at "
          f"{N // world}: "
          f"{ {k: round(v, 2) for k, v in us_at[N // world].items()} } "
          f"({card})")
    # phase 40: the other arms
    t40 = seen[f"40/threshold/dp{world}"]
    require_digests(f"phase 40 ess_threshold=0.5 dp={world}", t40["digests"],
                    thr["digests"])
    require_digests(f"phase 40 ess_threshold=0.5 dp={world} plain",
                    t40["plain_digests"], thr["digests"])
    h40 = seen[f"40/halo1/dp{world}"]
    require_digests(f"phase 40 halo=1 dp={world}", h40["digests"],
                    one["digests"])
    if h40["exchanges"]["ring"] != T - 1:
        raise AssertionError(f"phase 40 halo=1: {h40['exchanges']}")
    g40 = seen["40/guided/dp2"]
    require_launches("phase 40 guided dp=1", g_launches,
                     {**want, "resample_fused_from_s": T - 1})
    require_launches("phase 40 guided dp=2", g40["launches"],
                     {**want, "grid_rank": T - 1})
    require_digests("phase 40 guided dp=2", g40["digests"], guided)
    require_digests("phase 40 guided dp=2 plain", g40["plain_digests"],
                    guided)
    print(f"# phase 40: ess_threshold=0.5 at dp={world} == dp=1 bitwise "
          f"({thr['resampled']} of {T - 1} steps resampled; launches a rank "
          f"{ {k: v for k, v in t40['launches'].items() if v} }); halo=1 at "
          f"dp={world} == dp=1 bitwise, exchanges {h40['exchanges']}; "
          f"guided and rejuvenated LG N={N} T={T} at dp=2 == dp=1 bitwise "
          f"on {list(guided)} and its plain rerun, launches a rank "
          f"{ {k: v for k, v in g40['launches'].items() if v} }, log_ml "
          f"{g40['log_ml']!r}; guided wall ms dp=1 "
          f"{[round(t, 3) for t in guided_ms]}, dp=2 "
          f"{[round(t, 3) for t in g40['ms']]} ({card})")
    # phase 41: the checkpointed sharded filter
    c41 = seen["41/dp2"]
    require_digests("phase 41 resumed dp=2", c41["digests"], ckpt)
    require_launches("phase 41 dp=2", c41["launches"],
                     {**want, "grid_rank": T - 1})
    print(f"# phase 41: checkpointed sharded spiral N={N} T={T} at dp=2, a "
          f"checkpoint every {CKPT_EVERY} steps, interrupted after "
          f"{CKPT_HEAD} and resumed: == the uninterrupted dp=1 run bitwise "
          f"on {list(ckpt)}; launches a rank over both "
          f"{ {k: v for k, v in c41['launches'].items() if v} }")
    # phase 42: shardmap_hmc and shardmap_chees
    from modppl_tpu_torch.models.hierarchical_static import (
        exact_hierarchical_posterior,
    )

    xs, ys = (x.numpy() for x in hierarchical_data("cpu"))
    _, _, _, mean, cov, _ = exact_hierarchical_posterior(xs, ys)
    sd = np.sqrt(np.diag(cov))
    c_local = SHARD_HMC["num_chains"] // world
    batch = batch_invariance(device, SHARD_HMC["num_chains"], c_local)
    trees = {c: pooled_sum_split(device, c, world)
             for c in (SHARD_HMC["num_chains"], SHARD_HMC_POW2["num_chains"])}
    for sampler in ("hmc", "chees"):
        s = seen[f"42/{sampler}/dp{world}"]
        require_launches(f"phase 42 {sampler} dp={world}", s["launches"], {})
        require_digests(f"phase 42 {sampler} {SHARD_HMC_POW2} dp={world}",
                        s["pow2"], ref_pow2[sampler])
        ref = ref_chains[sampler]
        same = {k: bool(np.array_equal(chains[f"{sampler}/{k}"], ref[k]))
                for k in CHAIN_DIGESTS}
        diff = {k: float(np.max(np.abs(chains[f"{sampler}/{k}"]
                                       - ref[k]))) for k in CHAIN_DIGESTS}
        gates = {}
        for tag, us in (("dp1", ref["unconstrained"]),
                        (f"dp{world}", chains[f"{sampler}/unconstrained"])):
            m, ess = chain_summary(us)
            bound = SHARD_HMC_SE * sd / math.sqrt(ess.min())
            gates[tag] = {"gap": np.abs(m - mean).tolist(),
                          "bound": bound.tolist()}
            if not bool(np.isfinite(us).all()) or \
                    not (np.abs(m - mean) <= bound).all():
                raise AssertionError(f"phase 42 {sampler} {tag}: posterior "
                                     f"mean {m} exact {mean} bound {bound}")
        exact = "bitwise" if all(same.values()) else (
            f"NOT bitwise: largest differences {diff}; held to the leg's "
            f"posterior gate instead. The op: adaptation._pooled_sum's add "
            f"tree over {c_local} chains a rank is not a subtree of the "
            f"one over {SHARD_HMC['num_chains']} (a (c, 7) batch's sum "
            f"moves by {trees}, one device against {world} shards); the "
            f"target's value-and-grad is bitwise in the batch ({batch})")
        print(f"# phase 42: shardmap_{sampler} on hmc-hierarchical-d3's "
              f"target {SHARD_HMC} float32, dp={world} against dp=1, no "
              f"kernel launched: {exact}; at {SHARD_HMC_POW2} == dp=1 "
              f"bitwise on {list(CHAIN_DIGESTS)}; posterior gates (gap, "
              f"{SHARD_HMC_SE} se bound) {gates}; wall ms dp=1 "
              f"{ref_ms[sampler]:.1f}, dp={world} "
              f"{[round(t, 1) for t in s['ms']]} ({card})")
    print(f"# phases 39-42: dp=1 runs {parent_s:.1f} s; the group of "
          f"{where} {group_s:.1f} s (39: {seen['39/seconds']:.1f}, 40: "
          f"{seen['40/seconds']:.1f}, 41: {seen['41/seconds']:.1f}, 42: "
          f"{seen['42/seconds']:.1f}); gloo ops that take CUDA tensors as "
          f"they are: {seen['gloo_cuda_ops']}")
    sys.stdout.flush()
    if clock:
        clock.mark("39-42 sharded filter, HMC")
    return {"dp1": one, "seen": seen}


SOURCES = {
    "stats_cumsum": ("modppl_tpu_torch/csrc/grid_positions.cu",
                     "modppl_tpu/ops/grid_positions_pallas.py:59"),
    "positions_cummax": ("modppl_tpu_torch/csrc/grid_positions.cu",
                         "modppl_tpu/ops/grid_positions_pallas.py:99"),
    "resample_fused_from_s": ("modppl_tpu_torch/csrc/fused_resample.cu",
                              "modppl_tpu/ops/fused_resample_pallas.py:101"),
    "hmc_warmup_chunk_small": ("modppl_tpu_torch/csrc/hmc_small.cu",
                               "modppl_tpu/ops/leapfrog_vpu_pallas.py:565"),
    "hmc_sample_chunk_small": ("modppl_tpu_torch/csrc/hmc_small.cu",
                               "modppl_tpu/ops/leapfrog_vpu_pallas.py:325"),
    "hmc_warmup_chunk": ("modppl_tpu_torch/csrc/hmc_chunk.cu",
                         "modppl_tpu/ops/leapfrog_pallas.py:529"),
    "hmc_sample_chunk": ("modppl_tpu_torch/csrc/hmc_chunk.cu",
                         "modppl_tpu/ops/leapfrog_pallas.py:599"),
    "grid_rank": ("modppl_tpu_torch/csrc/grid_rank.cu",
                  "modppl_tpu/ops/resample_pallas.py:40"),
    "fused_leapfrog": ("modppl_tpu_torch/csrc/hmc_chunk.cu",
                       "modppl_tpu/ops/leapfrog_pallas.py:81"),
    "hmc_transition_small": ("modppl_tpu_torch/csrc/hmc_small.cu",
                             "modppl_tpu/ops/leapfrog_vpu_pallas.py:165"),
}

# each wrapper's kernel as the profiler names it (the CUDA symbol)
KERNEL_SYMBOLS = {
    "stats_cumsum": "stats_cumsum_kernel",
    "positions_cummax": "positions_cummax_kernel",
    "resample_fused_from_s": "resample_from_s_kernel",
    "hmc_warmup_chunk_small": "warmup_small_kernel",
    "hmc_sample_chunk_small": "sample_small_kernel",
    "hmc_warmup_chunk": "warmup_kernel",
    "hmc_sample_chunk": "sample_kernel",
    "grid_rank": "grid_rank_kernel",
    "fused_leapfrog": "leapfrog_kernel",
    "hmc_transition_small": "transition_small_kernel",
}


# one turn of --turns, run from a tree's root with that tree's code: the
# head, then each group asked for (TURN_GROUPS), then the tail
TURN_HEAD = r"""
import hashlib, json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from modppl_tpu_torch.ops import _build
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

_build.build()
digest = lambda xs: hashlib.sha256(b"".join(
    x.cpu().numpy().tobytes() for x in xs)).hexdigest()[:16]


def on_path(fn, symbols):
    # one profiled run of fn: the card's busy ms, and each symbol's us a
    # launch (None when the profiler lost it)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    per = {}
    for name, symbol in symbols.items():
        hits = [e for e in rows if symbol in e.key]
        per[name] = (sum(e.device_time_total for e in hits)
                     / sum(e.count for e in hits) if hits else None)
    return sum(e.device_time_total for e in rows) / 1e3, per


out = {}
"""

TURN_GROUPS = {"hmc": r"""
from modppl_tpu_torch.ops import leapfrog as lf
from modppl_tpu_torch.ops import leapfrog_small as lfs

warm_small, samp_small = cs.leg_inputs("hierarchical")
warm, samp = cs.leg_inputs("illcond")
lam, b, im, u0 = cs.quad_problem(128, 4096, 70, "cuda")
z, jit, _ = lfs.phase_draws(71, 1, 4096, 128, torch.float32, "cuda")
leap = (u0, z[0] / torch.sqrt(im), 0.1 * jit[0], lam, b, im, 32)
lam, b, im, u0 = cs.quad_problem(3, 10_000, 70, "cuda")
z, jit, u01 = lfs.phase_draws(71, 1, 10_000, 3, torch.float32, "cuda")
trans = (u0, z[0] / torch.sqrt(im), 0.1 * jit[0], u01[0], lam, b, im, 8)
flat = lambda out: (*out[0], *out[1:])
with cs.full_fp32():
    for name, fn, args, reps in (
            ("hmc_warmup_chunk", lf.warmup_chunk, warm, 5),
            ("hmc_sample_chunk", lf.sample_chunk, samp, 5),
            ("fused_leapfrog", lf.fused_leapfrog, leap, 20),
            ("hmc_warmup_chunk_small", lfs.warmup_chunk_small, warm_small,
             5),
            ("hmc_sample_chunk_small", lfs.sample_chunk_small, samp_small,
             5),
            ("hmc_transition_small",
             lambda *a: flat(lfs.hmc_transition_small(*a)), trans, 20)):
        out[name + "_digest"] = digest(fn(*args))
        out[name + "_ms"] = cs.time_ms(lambda: fn(*args), reps=reps, warmup=1)
for leg in ("illcond", "hierarchical"):
    med, times, ess_min, _, _ = cs.time_leg(leg)
    out.update({leg + "_leg_ms": med * 1e3, leg + "_ess_min": ess_min,
                leg + "_leg_runs_ms": [t * 1e3 for t in times]})
for leg in ("illcond", "hierarchical"):
    quad = cs.quad_leg(leg)
    med, times, ess_min, _ = cs.time_quad(leg, quad)
    out.update({f"quad_{leg}_ms": med * 1e3, f"quad_{leg}_ess_min": ess_min,
                f"quad_{leg}_runs_ms": [t * 1e3 for t in times]})
# one profiled hmc_quadratic run at d = 3: kernel 8's us a launch on its
# path, and the card's busy ms
with cs.full_fp32():
    busy, per = on_path(lambda: cs.run_quad("hierarchical", quad, 41),
                        {"k8": "transition_small_kernel"})
out["quad_hierarchical_busy_ms"] = busy
out["hmc_transition_small_path_us"] = per["k8"]
""", "resample": r"""
# kernels 1-4 at N = 2^20 (kernel 3 on the filter's (N, 2) state, digests
# also on concentrated and degenerate weights and in the (C, N) layout at
# C = 7), then one profiled run of each filter: busy ms and each kernel's
# us a launch on its path, beside the filters' median wall ms
from modppl_tpu_torch.ops import fused_resample as fr
from modppl_tpu_torch.ops import grid_positions as gp
from modppl_tpu_torch.ops import resample as rs
from modppl_tpu_torch.parallel import sharded_smc as smc

n = cs.N
u = torch.tensor(0.37, dtype=torch.float32, device="cuda")
gen = torch.Generator(device="cuda").manual_seed(0)
state = torch.randn(n, 2, generator=gen, device="cuda")
state_cn = torch.randn(7, n, generator=gen, device="cuda")
for kind in cs.KINDS:
    lw = cs.make_lw(kind, n, 0, "cuda")
    s, _, _ = smc._det_grid_positions(u, lw, n)
    out[f"rank_{kind}_digest"] = digest(
        (*fr.resample_fused_from_s(s, state, layout="nc"),
         *fr.resample_fused_from_s(s, state_cn), rs.grid_rank(s, n)))
    if kind == "uniform":
        rows, m = lw.reshape(-1, smc._cdf_block(n)), lw.max()
        cum, totals, _ = gp.stats_cumsum_plain(rows, m)
        offs_incl = gp.doubling_cumsum(totals[None, :])[0]
        offs = torch.cat([totals.new_zeros(1), offs_incl[:-1]])
        total = offs_incl[-1]
        cases = (
            ("stats_cumsum", lambda: gp.stats_cumsum(rows, m)),
            ("positions_cummax",
             lambda: gp.positions_cummax(cum, offs, total, u, n)),
            ("resample_fused_from_s",
             lambda: fr.resample_fused_from_s(s, state, layout="nc")),
            ("grid_rank", lambda: (rs.grid_rank(s, n),)))
        for name, fn in cases:
            out[name + "_digest"] = digest(fn())
            out[name + "_ms"] = cs.time_ms(fn)
for label, run, symbols in (
        ("spiral", lambda: cs.run_filter("cuda", n, 201,
                                         store_ancestry=False),
         {k: cs.KERNEL_SYMBOLS[k] for k in ("stats_cumsum",
                                            "positions_cummax",
                                            "resample_fused_from_s")}),
        ("hmm", lambda: cs.run_hmm("cuda", n, 201),
         {"grid_rank": cs.KERNEL_SYMBOLS["grid_rank"]})):
    med, _ = (cs.time_filter if label == "spiral" else cs.time_hmm)()
    busy, per = on_path(run, symbols)
    out[f"{label}_wall_ms"] = med * 1e3
    out[f"{label}_busy_ms"] = busy
    out.update({f"{k}_path_us": v for k, v in per.items()})
"""}

TURN_GROUPS["lanes"] = r"""
# the one-device spiral and guided legs at 2^20 x 10, the filters whose
# draws moved to lane streams: median wall ms of 5 after a warm-up, and one
# profiled run's busy ms
for label, timer, run in (
        ("spiral", cs.time_filter,
         lambda: cs.run_filter("cuda", cs.N, 201, store_ancestry=False)),
        ("guided", cs.time_guided, lambda: cs.run_guided("cuda", cs.N, 201))):
    med, times = timer()
    busy, _ = on_path(run, {})
    out[f"{label}_wall_ms"] = med * 1e3
    out[f"{label}_runs_ms"] = [t * 1e3 for t in times]
    out[f"{label}_busy_ms"] = busy
"""
TURN_TAIL = r"""
print("TURN " + json.dumps(out))
"""


def turns(other, groups=tuple(TURN_GROUPS)):
    """--turns: this tree against ``other`` on one card, in turns other,
    this, this, other; each turn runs the ``groups`` of TURN_GROUPS."""
    import os
    from pathlib import Path

    here = Path(__file__).resolve().parent
    other = Path(other).resolve()
    if not (other / "chip_smoke.py").exists():
        print(f"chip_smoke: {other} holds no chip_smoke.py", file=sys.stderr)
        return 1
    code = TURN_HEAD + "".join(TURN_GROUPS[g] for g in groups) + TURN_TAIL
    rows = []
    for label, tree in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                              capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": str(tree)})
        lines = [x for x in proc.stdout.splitlines() if x.startswith("TURN ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"turn {label} ({tree}) failed")
        rows.append({"turn": label, **json.loads(lines[-1][5:])})
        print(json.dumps(rows[-1]))
        sys.stdout.flush()
    return 0


class PhaseClock:
    """Prints the seconds of each phase group as it ends, and the total."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def mark(self, name):
        now = time.perf_counter()
        print(f"# seconds: phase {name} {now - self.last:.1f} s (total "
              f"{now - self.start:.1f} s)")
        sys.stdout.flush()
        self.last = now


def slice7_phases(card, profile, device="cuda", clock=None):
    """Phases 20-22 (slice 7), with their lines of output; ``profile``
    adds phases 20 and 21's profiler breakdowns."""
    chees_run, chees_out, ch = check_chees_leg(device)
    print(f"# main path: ChEES on the hierarchical model {CHEES} float32 "
          f"through chees_runner(device={device!r}), no kernel launched; "
          f"mean a, b, c {[round(x, 5) for x in ch['means']]} exact "
          f"{[round(x, 5) for x in ch['exact']]} (bound "
          f"{[round(x, 5) for x in ch['bound']]}); accept {ch['accept']!r}; "
          f"tau {ch['tau']!r}; eps {ch['eps']!r}; mean leapfrog "
          f"{ch['mean_leapfrog']!r}; {ch['vag_calls']} value-and-grad calls; "
          f"divergences {ch['divergences']}; min ESS {min(ch['ess']):.1f}")
    check_chees_rerun(device)
    wall = ch["wall_s"]
    print(f"# chees leg: {wall * 1e3:.3f} ms (one timed run, key 0); "
          f"min-coord ESS {min(ch['ess']):.1f} -> {min(ch['ess']) / wall:.1f} "
          f"ESS/s; {wall * 1e3 / ch['vag_calls']:.4f} ms a value-and-grad "
          f"call; key 0 twice bitwise equal at {CHEES_RERUN} ({card})")
    if profile:
        with full_fp32():
            profile_run("chees leg", lambda: chees_run(11), wall)
    sys.stdout.flush()
    if clock:
        clock.mark("20 ChEES leg")
    vi = check_vi_leg(device)
    print(f"# main path: ADVI on logistic regression {VI} float32 through "
          f"advi(device={device!r}), no kernel launched; mu within "
          f"{vi['gap']!r} of the importance-sampling oracle (bound "
          f"{VI_MU_BOUND}; oracle se {vi['oracle_se']!r}); final ELBO "
          f"{vi['final_elbo']!r} <= log evidence {vi['log_evidence']!r}")
    vt = time_vi_leg(device=device)
    print(f"# vi leg: {vt['median_s'] * 1e3:.3f} ms (median of "
          f"{[round(t * 1e3, 3) for t in vt['times']]} ms) -> "
          f"{vt['evals_per_s']:.1f} MC model evals/s; final ELBO "
          f"{vt['final_elbo']:.4f}; "
          f"{vt['median_s'] * 1e3 / VI['num_steps']:.4f} ms a step ({card})")
    if profile:
        data = vi_data(device)
        with full_fp32():
            profile_run("vi leg", lambda: run_vi(device, 11, data),
                        vt["median_s"])
    sys.stdout.flush()
    if clock:
        clock.mark("21 VI leg")
    small = check_small_entries(device)
    for name, seen in small.items():
        rest = {k: v for k, v in seen.items() if k != "ms"}
        print(f"# small entry {name}: {seen['ms']:.1f} ms, no kernel "
              f"launched; {rest} ({card})")
    sys.stdout.flush()
    if clock:
        clock.mark("22 small entries")


def main(argv):
    if argv[:1] == ["--slice12-rank"]:
        return slice12_rank(int(argv[1]), int(argv[2]), *argv[3:8])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    if argv[:1] == ["--turns"]:
        print(f"# card: {card}")
        return turns(argv[1], tuple(argv[2:]) or tuple(TURN_GROUPS))
    print(f"# card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    sys.stdout.flush()

    from modppl_tpu_torch.ops import _build

    clock = PhaseClock()
    path, seconds, log = _build.build()
    print(f"# build: {seconds:.2f} s -> {path.name}")
    for line in log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            print(f"#   {line.strip()}")
    sys.stdout.flush()

    errs = check_kernels("cuda")
    print(f"# kernels == plain versions on the card, bitwise: N in "
          f"{list(CHECK_SIZES)}, weights {list(KINDS)}; kernels 1-2 also at "
          f"N in {list(GRID_SIZES)} and on {GRID_ODD_ROWS} rows of "
          f"{list(GRID_ODD_WIDTHS)}")
    sys.stdout.flush()
    clock.mark("2-3 build, kernels")

    launches, seen = check_main_path("cuda")
    print(f"# main path: spiral filter N={N} T={T} float32 on cuda; "
          f"launches {launches}")
    print("# main path == the same filter through the plain versions on the "
          "card, bitwise")
    print(f"# log_ml GPU {seen['log_ml']!r} CPU {seen['log_ml_cpu']!r} "
          f"gap {seen['log_ml_gap']!r}; ancestors equal per step on "
          f"{[round(a, 6) for a in seen['parent_agreement']]} of the slots")
    sys.stdout.flush()

    median_s, times = time_filter()
    print(f"# filter: median {median_s * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in times]} ms -> "
          f"{N * T / median_s:.1f} particle-steps/s ({card})")
    timings = time_kernels()
    for name, (k_ms, p_ms, l_ms, b_ms) in timings.items():
        print(f"# {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{l_ms:.4f} ms, bound {b_ms:.4f} ms at N={N}")
    if "--profile" in argv:
        profile_run("spiral filter", lambda: run_filter(
            "cuda", N, 201, store_ancestry=False), median_s)
    sys.stdout.flush()
    clock.mark("4-5 spiral filter")

    hmc_errs, agree, bitwise = check_hmc_kernels("cuda")
    print("# HMC d <= 12 kernels == plain versions on the card, bitwise "
          "(d=3 N=10^4 T=500/300, d=12 N=10^4 T=20/60; sampling (d, N, T) "
          f"in {list(SAMPLE_CASES)}; warmup (d, N, T) in "
          f"{list(MANY_SMALL)}); d >= 13 within "
          f"tolerance at d in {[d for d, _ in WIDE_DIMS]}, sampling with "
          f"forced accepts at d={WIDEST[0]}, warmup at d={MANY_CHAINS[0]} "
          f"N={MANY_CHAINS[1]}: accept decisions "
          f"agree {agree}, bitwise equal {bitwise}; max abs err {hmc_errs}; "
          "every kernel run twice, bitwise equal; a divergent chain leaves "
          "the others unchanged")
    sys.stdout.flush()
    hmc_launches, _ = check_hmc_main_path("cuda")
    print(f"# main path: both HMC legs through hmc_runner(device='cuda'), "
          f"fused, quad_check_ok, posterior in bounds; launches "
          f"{hmc_launches}")
    sys.stdout.flush()
    for name, cfg in LEGS.items():
        med, times, ess_min, ess_med, acc = time_leg(name)
        if "--profile" in argv:
            run = make_leg(name, "cuda")
            profile_run(f"HMC leg {name}", lambda: run(11), med)
        n_tr = cfg["num_chains"] * (cfg["num_warmup"] + cfg["num_samples"])
        print(f"# leg {name} {cfg}: median {med * 1e3:.3f} ms of "
              f"{[round(t * 1e3, 3) for t in times]} ms; min-coord ESS "
              f"{ess_min:.1f} (median {ess_med:.1f}) -> {ess_min / med:.1f} "
              f"ESS/s; {n_tr / med:.4g} transitions/s; accept {acc:.3f} "
              f"({card})")
        sys.stdout.flush()
    hmc_timings = time_hmc_kernels()
    for name, (k_ms, p_ms, b_ms, _) in hmc_timings.items():
        print(f"# {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms at its leg's shapes")
    sys.stdout.flush()
    clock.mark("6-8 HMC legs")

    s3_errs = check_slice3_kernels("cuda")
    print(f"# slice 3 kernels on the card: grid_rank == plain bitwise (N in "
          f"{list(RANK_SIZES)}, weights {list(KINDS + EDGE_S)}; (m, num) in "
          f"{list(RANK_M_NUM)}); hmc_transition_small "
          f"== plain bitwise on all outputs (d, N in {list(TRANSITION_CASES)})"
          f"; fused_leapfrog == plain bitwise (d, N in "
          f"{list(LEAPFROG_DIMS)}); every kernel run twice, bitwise equal")
    sys.stdout.flush()
    rank_launches, hmm_seen = check_hmm_leg("cuda")
    print(f"# main path: HMM leg N={N} T={T} (int32 state) through "
          f"vsmc.batched_particle_filter; grid_rank launches {rank_launches}, "
          f"kernel 3 none; log_ml {hmm_seen['log_ml']!r} exact "
          f"{hmm_seen['exact']!r}; == the same filter through grid_rank's "
          f"plain version, bitwise; ess_threshold 0.5 skipped "
          f"{hmm_seen['skipped']} resamples, log_ml gap "
          f"{hmm_seen['gap_adaptive']!r}")
    spiral_ml = check_spiral_vsmc("cuda")
    print(f"# spiral via vsmc.batched_particle_filter: kernel 3 launched "
          f"{T - 1} times, grid_rank none; log_ml {spiral_ml!r}")
    sys.stdout.flush()
    legs = {name: quad_leg(name) for name in LEGS}
    quad_launches = check_quad_legs(legs)
    print(f"# main path: hmc_quadratic on both legs after hmc_runner's "
          f"warmup, posterior in bounds, no divergence at d=3; launches "
          f"{quad_launches}")
    sys.stdout.flush()
    hmm_s, hmm_times = time_hmm()
    print(f"# HMM leg: median {hmm_s * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in hmm_times]} ms -> "
          f"{N * T / hmm_s:.1f} particle-steps/s ({card})")
    if "--profile" in argv:
        profile_run("HMM leg", lambda: run_hmm("cuda", N, 201), hmm_s)
    for name, leg in legs.items():
        med, times, ess_min, acc = time_quad(name, leg)
        if "--profile" in argv:
            with full_fp32():
                profile_run(f"hmc_quadratic {name}",
                            lambda: run_quad(name, leg, 41), med)
        c = LEGS[name]
        n_tr = c["num_chains"] * c["num_samples"]
        print(f"# hmc_quadratic {name} (d={c['dim']}, {c['num_chains']} "
              f"chains, {c['num_samples']} x L={c['num_leapfrog']}): median "
              f"{med * 1e3:.3f} ms of {[round(t * 1e3, 3) for t in times]} "
              f"ms; min-coord ESS {ess_min:.1f} -> {ess_min / med:.1f} ESS/s; "
              f"{n_tr / med:.4g} transitions/s; accept {acc:.3f} ({card})")
        sys.stdout.flush()
    s3_timings = time_slice3_kernels()
    for name, (k_ms, p_ms, l_ms, b_ms, by) in s3_timings.items():
        lib = "" if l_ms is None else f", library {l_ms:.4f} ms"
        print(f"# {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms{lib}, "
              f"bound {b_ms:.4f} ms ({by}) at its main path's shapes")
    clock.mark("9-12 HMM, hmc_quadratic, slice-3 kernels")
    guided_launches, guided_seen = check_guided_leg("cuda")
    print(f"# main path: guided and rejuvenated LG filter N={N} T={T} "
          f"float32 through sharded_batched_particle_filter (locally optimal "
          f"proposal, one move of x a step); launches "
          f"{ {k: guided_launches[k] for k in GUIDED_KERNELS} }, no other "
          f"kernel; log_ml {guided_seen['log_ml']!r} exact Kalman "
          f"{guided_seen['exact']!r} (gap "
          f"{abs(guided_seen['log_ml'] - guided_seen['exact'])!r}); "
          f"acceptance {guided_seen['acceptance']!r} (by step "
          f"{[round(a, 4) for a in guided_seen['acceptance_by_step']]}); == "
          f"the same filter through the plain versions on the recorded "
          f"draws, bitwise")
    sys.stdout.flush()
    guided_s, guided_times = time_guided()
    print(f"# guided leg: median {guided_s * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in guided_times]} ms -> "
          f"{N * T / guided_s:.1f} particle-steps/s ({card})")
    if "--profile" in argv:
        profile_run("guided LG filter", lambda: run_guided("cuda", N, 201),
                    guided_s)
    sys.stdout.flush()
    clock.mark("13-14 guided leg")
    logreg_run, lr_seen = check_logreg_leg("cuda")
    print(f"# main path: logistic regression {LOGREG} float32 through "
          f"hmc_runner(device='cuda'), generic pooled path, no kernel "
          f"launched; posterior mean within {lr_seen['gap']!r} of the "
          f"importance-sampling oracle (allowed {lr_seen['allowed']!r}; "
          f"oracle se {lr_seen['oracle_se']!r}, IS ESS "
          f"{lr_seen['oracle_ess']:.1f}); eps {lr_seen['eps']!r}, accept "
          f"{lr_seen['accept']!r}; same key twice bitwise equal; per-chain "
          f"path {LOGREG_PER_CHAIN} within {lr_seen['per_chain_gap']!r}")
    sys.stdout.flush()
    lr_s, lr_times, lr_ess, lr_ess_med, lr_acc, lr_eps = time_logreg_leg(
        logreg_run)
    n_tr = LOGREG["num_chains"] * (LOGREG["num_warmup"]
                                   + LOGREG["num_samples"])
    print(f"# logreg leg: median {lr_s * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in lr_times]} ms; min-coord ESS "
          f"{lr_ess:.1f} (median {lr_ess_med:.1f}) -> {lr_ess / lr_s:.1f} "
          f"ESS/s; {n_tr / lr_s:.4g} transitions/s; accept {lr_acc:.3f}; "
          f"eps {lr_eps:.5f} ({card})")
    vag_ms, vag_times = time_logreg_vag()
    calls = (LOGREG["num_warmup"] + LOGREG["num_samples"]) \
        * LOGREG["num_leapfrog"] + 1
    print(f"# logreg value-and-grad at {LOGREG['num_chains']} chains: "
          f"{vag_ms:.4f} ms a call (median of "
          f"{[round(t, 4) for t in vag_times]}; {calls} calls a run) "
          f"({card})")
    if "--profile" in argv:
        with full_fp32():
            profile_run("logreg leg", lambda: logreg_run(11), lr_s)
    sys.stdout.flush()
    clock.mark("15-16 logistic leg")
    is_seen = check_is_leg("cuda")
    print(f"# main path: importance_sampling(vectorized=True) on the "
          f"saturated hierarchical model, N={IS_LANES} lanes float32, no "
          f"kernel launched; ESS {is_seen['ess']!r}; log_ml "
          f"{is_seen['log_ml']!r} exact {is_seen['exact']!r} (se "
          f"{is_seen['ml_se']!r}); weighted a, b, c {is_seen['means']} exact "
          f"{is_seen['exact_mean']} (bound {is_seen['bound']}); P(is_linear) "
          f"{is_seen['p_linear']!r}; same key twice bitwise equal; "
          f"{IS_RESAMPLED} resampled indices, mean c "
          f"{is_seen['resampled_c']!r}; eager hierarchical model at "
          f"{IS_EAGER_SAMPLES} samples: log_ml {is_seen['eager_log_ml']!r} "
          f"({is_seen['eager_quadratic']} quadratic)")
    is_s, is_times = time_is_leg()
    print(f"# importance leg: median {is_s * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in is_times]} ms -> "
          f"{IS_LANES / is_s:.4g} lanes/s ({card})")
    if "--profile" in argv:
        profile_run("importance leg", lambda: run_is("cuda", IS_LANES, 301),
                    is_s)
    sys.stdout.flush()
    mh_seen = check_mh_leg("cuda")
    print(f"# main path: MH on the eager hierarchical model, {MH_ROUNDS} "
          f"rounds of 1 jump + {MH_DRIFTS} drifts + 1 regen_mh ({MH_BURN} "
          f"burn-in), no kernel launched; quadratic in "
          f"{mh_seen['quadratic_share']!r} of the kept rounds; mean a, b, c "
          f"{mh_seen['means']} exact {mh_seen['exact_mean']} (gap "
          f"{mh_seen['gap']!r}); accept {mh_seen['accept']!r}; conjugate "
          f"regen_mh ({CONJ_STEPS} steps) mean {mh_seen['conj_mean']!r} sd "
          f"{mh_seen['conj_sd']!r}")
    mh_s, mh_times = time_mh()
    n_tr = MH_TIMED_ROUNDS * (MH_DRIFTS + 2)
    print(f"# MH leg: median {mh_s * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in mh_times]} ms for {n_tr} "
          f"transitions -> {mh_s / n_tr * 1e3:.4f} ms a transition, "
          f"{n_tr / mh_s:.1f} transitions/s ({card})")
    if "--profile" in argv:
        profile_run("MH leg", lambda: run_mh_chain("cuda", MH_TIMED_ROUNDS,
                                                   33), mh_s)
    sys.stdout.flush()
    pf_seen = check_eager_filters("cuda")
    print(f"# main path: ParticleSystem over the hand-coded HMM "
          f"({PF_HMM_PARTICLES} particles, data {list(PF_HMM_DATA)}) and "
          f"the spiral Unfold ({PF_SPIRAL_PARTICLES} particles, "
          f"{PF_SPIRAL_STEPS} steps), no kernel launched; HMM log_ml "
          f"{pf_seen['log_ml']!r} exact {pf_seen['exact']!r}, ESS "
          f"{[round(e, 2) for e in pf_seen['ess']]}; spiral final mean "
          f"{pf_seen['spiral_dist']!r} from the last observation")
    for name, run, n, steps in (
            ("HMM", run_hmm_pf, PF_HMM_PARTICLES, len(PF_HMM_DATA)),
            ("spiral", run_spiral_pf, PF_SPIRAL_PARTICLES, PF_SPIRAL_STEPS)):
        pf_s, pf_times = time_eager_filter(run)
        print(f"# eager {name} filter: median {pf_s * 1e3:.3f} ms of "
              f"{[round(t * 1e3, 3) for t in pf_times]} ms -> "
              f"{n * steps / pf_s:.1f} particle-steps/s ({card})")
        if "--profile" in argv:
            profile_run(f"eager {name} filter", lambda: run("cuda", 61),
                        pf_s)
    sys.stdout.flush()
    clock.mark("17-19 importance, MH, eager filters")
    slice7_phases(card, "--profile" in argv, clock=clock)
    slice8_phases(card, "--profile" in argv, clock=clock)
    slice9_phases(card, "--profile" in argv, clock=clock)
    slice10_phases(card, "--profile" in argv, clock=clock)
    slice11_phases(card, "--profile" in argv, clock=clock)
    slice12_phases(card, "--profile" in argv, clock=clock)
    launches.update(hmc_launches)
    launches.update(quad_launches)
    launches["grid_rank"] = rank_launches
    errs.update(hmc_errs)
    errs.update(s3_errs)

    def row(name):
        if name in timings:
            k_ms, p_ms, l_ms, b_ms = timings[name]
            bound_by = "bytes"
        elif name in s3_timings:
            k_ms, p_ms, l_ms, b_ms, bound_by = s3_timings[name]
        else:
            (k_ms, p_ms, b_ms, bound_by), l_ms = hmc_timings[name], None
        return {"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": launches[name],
                "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": bound_by, "library_ms": l_ms}

    record = {"kernels": [row(name) for name in SOURCES]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
