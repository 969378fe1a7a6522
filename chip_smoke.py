#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

Drives the port's serving path — ``SPH3DModelNet`` of the ModelNet40
dense fast-mode config (B=16, N=10000, full published width, random
weights from a seeded ``torch.Generator``) under ``vote_classify`` —
through the hand-written CUDA kernels, in phases:

1. header: the card's name and power limit, torch, CUDA, scipy and numpy
   versions;
2. build: compile ``sph3d_gcn_torch/csrc/*.cu`` (seconds); each kernel's
   ``-Xptxas -v`` report (registers, spills, shared memory);
3. per-kernel parity and timing: one forward of the plain versions on a
   ``surface_clouds`` batch records the operands of every kernel-wrapped
   call of the main path (``_build.record_calls``); each recorded call is
   replayed through the kernel and its plain version and the two are
   compared (FPS indices, query maps and pool outputs exactly, conv bf16
   outputs within rtol=atol=1e-2), with CUDA-event times of both (the
   kernel's the median of ``REPS`` runs, the plain version's of one).
   Done with the served model's ``"hard"`` windows (these go into the
   per-kernel JSON line); the default ``"plain"`` windows' forward calls
   are replayed within phase 6's train step;
4. serving: 2 batches x 3 votes through ``vote_classify``; logits
   (16, 40) and finite, ``dense_ok`` on every forward, launch counts of
   3 FPS, 6 query, 6 conv and 3 pool per forward; one forward's kernel
   logits against the plain versions' (argmax agreement >= 0.95, logits
   within 1% of their largest magnitude); forward time and points/s with
   both window families;
5. profile: ``torch.profiler`` over forwards of each window family;
   per forward the wall span, the device's busy time (union of kernel
   and copy intervals on the trace timeline) and idle share, and the
   device time by kernel name (:func:`report_trace`).

Serving runs the config's ``family="hard"`` windows (2304/1024/640 rows
at the encoder levels): the vote augmentation rotates each cloud about
z, and the ``"plain"`` windows (1536/896/640), calibrated on unrotated
ellipsoids, do not cover every rotated copy (level-0 slabs of up to 1579
rows were measured on these very votes), so the certificate would fail
and those votes re-run on the per-edge engine (phase 15 serves them so).
Weights do not depend on the windows.

Then the train phases, on the default ``"plain"`` windows of
``modelnet_config(fast=True, dense=True)`` (the JAX bench's training
configuration: no augmentation, so every graph is covered), one
``surface_clouds`` batch with integer labels and seeded weights, through
``classification_step_factory(...).train_step`` (Adam on the staircase
schedule, weight decay):

6. per-kernel parity and timing of the train step: one plain step's
   forward and backward records every kernel-wrapped call (6 conv
   forwards, 3 pool forwards with their argmax, 6 conv backwards, 3 pool
   backwards, 3 FPS, 6 queries); each is replayed through kernel and plain
   version. The pool argmax and the pool gradients must be equal; the
   conv backward's ``dx`` (bf16) within rtol 1e-2 and 1e-3 of its largest
   magnitude (f32 sums in another order, one bf16 rounding), its f32
   filter gradient within 1e-4 of its largest magnitude (sums of up to
   ~10^6 products in another order). These times go into the JSON line.
   Each call's line shows its time beside the library call and the bound
   (share = bound / time); each conv's, pool's, pool backward's, conv
   backward's, query's and edge gather's (and FPS's) is followed by its
   device time (the pool backward's beside ``scatter_add_``'s, the edge
   gather's beside ``torch.gather``'s; the conv backward's three
   kernels summed), and each unpool backward's, whole and its K9 (form
   (b)) alone, in a ``torch.profiler`` trace,
   without the host's time before the launch that a single call's span
   holds (:func:`device_ms`). Every query call's kernel count must equal
   its map's nonzero bytes a row;
7. one kernel step against one plain step from the same state, batch and
   dropout seed, ``dense_ok`` True: loss within 1%; with f32 activations
   (same weights, graphs and masks) every gradient leaf's L2 error within
   2e-3 of the larger of its own norm and the median leaf's norm (sums in
   other orders; a leaf that cancels to a small norm is held to the
   median leaf's absolute error, not to its own magnitude); the same gate
   must reject the bf16 kernel step's gradients put in the f32 step's
   place (a planted fault: its leaves over the limit are printed); with
   the served bf16 activations each leaf's error against the f32
   gradients at most 2x the plain bf16 step's own error on that leaf plus
   0.05 (a bf16 gradient leaf differs from its f32 value by up to tens of
   percent where a batch-norm backward cancels most of its input, in the
   plain version as in the JAX package; the two bf16 versions round at
   the same points, so a 1-ulp difference in an activation is all that
   separates them);
8. determinism: two kernel steps from the same state give bitwise-equal
   loss and gradients, under ``torch.use_deterministic_algorithms(True)``
   (cuBLAS's workspace is fixed before CUDA starts);
9. 12 steps on the fixed batch: finite loss, lower at the end, ``dense_ok``
   on every step, launch counts of exactly 3 FPS, 6 query, 6 conv, 3 pool,
   18 conv-backward (6 calls of 3 kernels: the dfilt partials of each
   query tile, their sum over tiles, dx) and 3 pool-backward per step;
   median step time and
   points/s with the kernels, and one plain step's time;
10. ``cli.profile_step --fast --dense`` on the same config, B=16,
    N=10000 (its own seeded model and the JAX script's batch): a warm
    step, three timed on the host clock, two traced under the profiler
    alone (the step's wall, busy time, idle share and device time by
    kernel from the second), then two traced with the layer spans and
    the call record on (the device time by layer and the bounds from
    the second); launches 8x the step's counts; each kernel's device
    time beside the bound of its calls from ``ops.costs`` (the model
    every bound here comes from).

Then the S3DIS phases: ``SPH3DSceneSeg`` of
``s3dis_config(fast=True, dense=True)`` (B=16, N=8192, full published
width: mlp 64, levels 128/256/256/512, decoder convs up to C_in = 1024,
13 classes; seeded random weights, eval mode) serving synthetic scene
blocks (the port's ``scene_blocks``):

11. per-kernel parity and timing: one plain forward records every
    kernel-wrapped call (4 FPS, 12 queries, 4 growth queries, 16 convs, 4
    pools) and the 4 masked-mean unpools; each kernel call is replayed
    through the kernel and its plain version (maps, growth steps, FPS
    indices and pool values exactly, conv outputs within ``CONV_TOL``),
    and each unpool (plain PyTorch, no kernel of its own) is timed;
12. serving: 32 blocks of 10000 points, inner xy in [0.3, 1.2]^2, through
    ``coverage_eval_blocks`` at B=16, N=8192: every inner point covered,
    finite (P, 13) logits per block, ``dense_ok`` on every forward, launch
    counts of 4 FPS, 12 queries, 4 growth queries, 16 convs and 4 pools
    per forward; one forward's kernel logits against the plain versions'
    (argmax agreement >= 0.95, within 1% of the largest |logit|); forward
    time (CUDA events, median of 5), points/s and blocks/s;
13. profile of the S3DIS forward (:func:`report_trace`).

Then the per-edge engine of ``modelnet_config(fast=True)`` (the JAX
package's classic fallback: bf16, axis sort, edge lists; the same
architecture and width, seeded weights), at B=16, N=10000:

14. per-kernel parity and timing: the 9 edge gathers (K8) of one plain
    forward, replayed through kernel and plain version (bitwise equal);
15. the dense engine's fallback: ``modelnet_config(fast=True, dense=True)``
    with its default windows on the same weights serves phase 4's 2
    batches x 3 votes through ``checked_forward`` and ``vote_classify``;
    the number of votes that fell back, each fallback's logits equal to a
    direct per-edge forward, launches per vote (the dense engine's, plus
    3 FPS and 9 K8 for a vote that fell back);
16. the per-edge forward: launches 3 FPS and 9 K8 per forward, kernel vs
    plain logits (within 1% of the largest |logit|), forward time (CUDA
    events, median of 5), the sphere query's time per level, peak device
    memory, profile;
17. the per-edge train step: the K8 and K9 calls of one plain bf16 step
    and the K9 calls of one plain f32 step replayed (K9 bitwise equal to
    its plain twin, which adds in the same list order; a line with K9's
    goal, its device ms a step), kernel step vs
    plain step (f32 and bf16, as phase 7),
    two kernel steps bitwise equal, 8 steps (launches 3 FPS, 9 K8, 9 K9
    per step, loss falling), step time and peak device memory;
18. profile of the per-edge train step;
19. ``fit()``'s recovery: a batch with half its clouds rotated about z
    fails the default windows' certificate in a dense train step; the
    batch is re-run from the pre-step state through
    ``StepFactory.classic_fallback()``, which must leave the dense model's
    parameters and statistics bitwise equal to a separate per-edge step
    from the same state (under ``torch.use_deterministic_algorithms``).

Then the S3DIS train step: ``SPH3DSceneSeg`` of
``s3dis_config(fast=True, dense=True)`` at B=16, N=8192 (seeded weights),
one batch as ``bench.py`` makes them (``scene_blocks``, random labels
and inner labels), through ``segmentation_step_factory(...,
inner_masked=True).train_step`` (Adam on the staircase schedule):

20. per-kernel parity and timing of the step: one plain step records
    every kernel-wrapped call (the forward's, 16 conv backwards at C_in
    up to 1024, 4 pool backwards at C up to 512) and the 4 unpools and
    their backwards; each kernel call is replayed as in phase 6, and each
    unpool backward (K9's form (b): the window gradients formed from the
    map and summed into the cloud) against its plain version (the same
    sums in the same order) bitwise, timed beside the einsum and
    ``index_put_`` scatter-add that autograd of the window gather would
    run; a line with K9's goals (PERF.md §6, row #15): the four backwards'
    span and device ms;
21. one kernel step against one plain step, f32 and bf16, as phase 7;
22. two kernel steps bitwise equal, as phase 8;
23. 10 steps on the fixed batch: ``dense_ok`` on every step, a falling
    loss, launch counts of exactly 4 FPS, 12 query, 4 growth query, 16
    conv, 4 pool, 48 conv-backward (16 calls of 3 kernels), 4
    pool-backward and 4 K9 (the unpool backwards) per step; median
    step time, points/s, one plain step's time, peak device memory;
24. profile of the S3DIS train step (:func:`report_trace`);
25. ``max_index``: ``dense_max_pool3d(with_index=True)`` on the 4 pool
    operands of phase 20 (rank maps) and one conv map of phase 6 (a bin
    map), through the kernels and the plain versions: values, ids and
    gradients equal, with times, device times and bounds; then K6 on
    adversarial operands (:func:`pool_bwd_stress`: scattered windows and
    one row taking every row of 15 tiles), bitwise equal to its plain
    version and to itself; K4 on adversarial operands
    (:func:`pool_fwd_stress`: rows with no entry, every column selected,
    counts beyond and below the rows' entries, ties, -0 beside +0,
    windows past the cloud's end, C 1-512, every mode and every kernel
    instance, with counts and as a bin map) and K8 on adversarial
    operands (:func:`gather_stress`: C 1-512, features at unaligned
    addresses, K 1 to 64, counts 0 to K, out-of-range indices; the
    per-edge forward's odd widths at full size) and K9 on adversarial
    operands (:func:`gather_bwd_stress`: both forms at C 1-512, f32 and
    bf16 edge gradients, the int8 map and f32 and bf16 weights, rows at
    unaligned addresses, empty lists, one-entry lists, a list of 1000
    edges, window columns selected in all 128 rows, cloud rows in no
    window), bitwise equal to their plain versions and to themselves,
    timed; and K3 and K5 on a crowded
    operand at the step's level-0 shapes (:func:`conv_fwd_stress`,
    :func:`conv_bwd_stress`: 64 selected entries in every query row, as
    real scene blocks have) against their plain versions and themselves,
    timed with their device times and bounds; and K1 on adversarial
    operands (:func:`fps_stress`: npoint 1 and N, all-equal, lattice and
    duplicated points, a 6-channel and a strided database, N at the
    registers' cap and past it, N = 40000 in device memory, B=64 with
    clusters in more than one wave, every instance of the kernel)
    bitwise equal to its plain version; and K2 and K7 on adversarial
    operands (:func:`query_stress`: points at exactly T - 1 ulp, T and
    T + 1 ulp in squared distance of every threshold of radii 0.1-0.8,
    growth rows alive only at the last radius or never, crowded rows past
    K, empty rows, all-sentinel tiles, u_end outside [1, W/128], the
    largest served window), every mode with and without the distance
    map, bitwise equal to their plain versions (counts included), one
    launch a call.

Then the config options that read the queries' distance maps, at full
published width with seeded weights:

26. S3DIS with ``unpool_method="weighted"`` (``s3dis_config(fast=True,
    dense=True)`` with that field changed; its 4 inter graphs ask K7 for
    distance maps), B=16, N=8192: 3 forwards through the kernels (launch
    counts as phase 12), one against the plain versions (argmax agreement
    >= 0.95, within 1% of the largest |logit|, ``dense_ok`` on both), the
    4 weighted unpools timed beside the mean unpool on the same graphs;
27. its train step: kernel step against plain step under phase 21's f32
    gradient gate (which must reject the planted bf16 fault), two kernel
    steps bitwise equal, the 4 weighted unpool backwards (their cloud sums
    through K9) against their plain versions bitwise and timed beside the
    mean unpool's backward on the same gradients, 4 steps with the launch
    counts of phase 23 and a falling loss, profile;
28. ModelNet with ``sample="IDS"`` and ``pool_method="avg"``
    (``modelnet_config(fast=True, dense=True)`` with those fields; the 3
    intra graphs ask K2 for distance maps, the avg pools' backwards sum
    through K9), B=16, N=10000: one kernel train step against the plain
    step from the same state and the same noise draws (one seeded
    generator for the IDS noise and the dropout masks), under phase 7's
    gates; ``dense_ok`` printed, and where the certificate fails a step
    re-runs from its pre-step state through ``classic_fallback()``, as
    JAX's ``fit()`` does (the run says so; nothing is widened); the 3
    avg pools timed beside the rank max pool on the same operands, their
    backwards (K9) against their plain versions; 3 steps with their
    launch counts, profile; one per-edge forward of
    ``modelnet_config(fast=True)`` with the same options (K8 under the
    avg pool: 9 launches, no FPS) against its plain version;
29. one ModelNet forward with ``sample="random"`` through
    ``checked_forward``: finite logits, and a covered dense forward or a
    fallback to the per-edge engine (printed), with its launch counts;
30. (a) distance-map replay: the 6 queries of one phase-28 step (3 with
    maps) and the 4 growth queries of one phase-26 forward through kernel
    and plain version, bitwise (maps, packed maps, growth steps); each
    call with a map again without it (packed map and steps bitwise
    unchanged), with both times, the map's bytes and its bound (bytes
    over 3.35 TB/s).

Then the per-edge engine of ``s3dis_config(fast=True)`` (the dense scene
model's fallback: bf16, axis sort, edge lists, the published width;
seeded weights), at B=16, N=8192:

31. per-kernel parity and timing: the 4 FPS calls and the 24 edge gathers
    (K8: 8 encoder convs, 4 pools, 8 decoder convs, and the 4 unpools,
    whose fine rows gather from coarse clouds, up to (16, 8192, 64, 128))
    of one plain forward, replayed through kernel and plain version
    (bitwise equal);
32. serving: 3 forwards with launch counts of 4 FPS and 24 K8 per
    forward, kernel vs plain logits (within ``LOGIT_TOL`` of the largest
    |logit|, argmax agreement >= 0.95), forward time (CUDA events,
    median of 5), each plain sphere query of a forward timed alone and
    their share of it, peak device memory, profile (device busy, idle
    share);
33. the train step (inner-masked loss, Adam): the K8 and K9 calls of one
    plain bf16 step replayed (K9 bitwise equal to its plain twin), kernel
    step vs plain step (f32 and bf16, as phase 7), two kernel steps
    bitwise equal, 5 steps (launches 4 FPS, 24 K8, 24 K9 per step, loss
    falling), step time, peak device memory, profile;
34. the dense scene model's recovery: a 10000-point block shrunk about
    its center (0.8, 0.6, ... of its size) until its neighbors outrun
    the calibrated windows of ``s3dis_config(fast=True, dense=True)``
    fails the certificate in a train step; the step is re-run from its
    pre-step state through ``StepFactory.classic_fallback()``, which must
    leave the dense model's parameters and statistics bitwise equal to a
    separate per-edge step from the same state (launches 4 FPS, 24 K8, 24
    K9); then the block is served through ``checked_forward`` and
    ``coverage_eval_blocks`` (forwards that fell back counted, the first
    equal to a direct per-edge forward, every inner point covered).

Then the training and evaluation entry points, as a user calls them, on
the card (records in a temporary directory):

35. 64 train and 32 test ``surface_clouds`` of N=10000 written as
    ModelNet-format TFRecords by the port's writer and read back through
    ``data.datasets`` bitwise equal (sizes and times printed);
36. ``cli.train_modelnet.main`` (dense mode, the ``hard`` windows, which
    cover the augmentation's rotated clouds; B=16): one epoch of 4 steps
    and an eval pass of 2 batches; launches exactly 4 x the bare step's
    (``PER_STEP``) plus 2 x ``PER_FORWARD`` (plus a per-edge step or
    forward for a batch its log says re-ran); finite losses; the config
    snapshot, log, ``metrics.jsonl`` and epoch-0 checkpoint written;
    ``fit``'s ms a batch (its own log line) beside the bare
    ``train_step``'s host-clock times on the same batches; a profile of a
    ``fit`` of 4 steps: each ``fit_step`` span's wall, device busy time
    and idle share, and the ``pre_step_copy`` span's device time and
    events;
37. the epoch-0 checkpoint restored into a fresh model bitwise equal to
    the trained one; ``cli.train_modelnet`` run again to 2 epochs
    resumes at epoch 1 (step count 8 after it, launches as phase 36);
38. ``cli.evaluate_modelnet.main`` with 3 votes: 6 forwards, launches
    6 x ``PER_FORWARD`` plus ``PER_WIN_FORWARD`` for each forward re-run
    on the per-edge engine (counted), finite (32, 40) votes written;
39. ``fit`` on phase 34's batch with the shrunk block under
    ``torch.use_deterministic_algorithms(True)``: the log shows the
    classic re-run, the dense model ends bitwise equal to a direct
    per-edge step from the same state, launches one dense and one
    per-edge S3DIS step;
40. ``utils.windows`` on 3 votes of 16 test clouds (vote 0 and 2
    ``vote_augment`` copies), measured as the model builds its graphs
    (sort, then ``normalize_unit_sphere``), the derived windows (10%
    margin) beside the plain and hard ones; each family serves those
    votes (the derived must certify every forward), with its forward
    time; then the S3DIS per-edge train step (``s3dis_config(fast=True)``,
    B=16, N=8192) with and without ``remat_blocks``: loss, gradients and
    statistics bitwise equal, step time and peak device memory of both.

Then the last model families and the scene evaluation, at full
published width with seeded weights (records and scenes written in a
temporary directory):

41. the one-hot ShapeNet train step (``shapenet_config(fast=True,
    dense=True)``, ``SPH3DShapeNetOnehot``, B=32, N=2048, unit-sphere
    normalized ellipsoid surfaces split into their categories' parts,
    ``cls_label`` through ``model_kwargs_keys``): one plain step's calls
    replayed through kernel and plain version (as phase 20, without each
    call's device time), kernel step vs plain step (f32 and bf16, as
    phase 21), two kernel steps bitwise equal, 5 steps (launches K1 4 /
    K2 12 / K7 4 / K3 16 / K4 4 / K5 48 / K6 4 / K9 4 a step, a falling
    loss, ``dense_ok`` each step), step time, peak memory, profile
    (device busy and idle share);
42. ShapeNet records written by the port's writer (64 shapes over the
    16 categories and 16 more chairs of 2600 points, 8 test chairs);
    ``cli.train_shapenet --onehot`` and ``--category chair`` (the class
    rebalancing's 660 shapes) for one epoch at B=32 in dense mode:
    launches as many steps of phase 41's counts, plus a per-edge step for
    each batch its log says re-ran (counted);
43. the per-category model from that checkpoint: one plain forward's
    calls at the eval's B=8 replayed, kernel vs plain logits; then
    ``cli.evaluate_shapenet --category chair`` (11 samples a point, the
    augmented pass): launches K1 4 / K2 12 / K7 4 / K3 16 / K4 4 a
    forward (plus a per-edge forward for each that re-ran), a file a
    shape, its forwards and shapes/s;
44. the RueMonge train step (``ruemonge2014_config(fast=True,
    dense=True)``, ``SPH3DRueMonge``, B=16, N=8192, xyz, normals and rgb,
    the plain mean loss), checked as phase 41;
45. ``cli.train_scene_seg --dataset ruemonge2014`` (dense mode, one
    facade block repeated 100 times: 7 steps, and its eval batch),
    launches as phase 42;
46. the scene evaluation: an S3DIS model's checkpoint and two areas of
    one scene each (15 blocks of about 10000 points, 1.5 m every 0.75 m,
    with ``index_label``; the scene with a full-resolution cloud of twice
    its points); one plain forward's calls at B=8 replayed; then
    ``cli.evaluate_scene_seg`` for each area with ``--scene_dir`` and
    ``--save_blocks`` (forwards, blocks a forward, blocks/s; the saved
    blocks merged again equal to its merged labels; its fold file),
    ``cli.aggregate_folds`` over the two fold files, and the RueMonge
    facade served from phase 45's checkpoint the same way.

Then the datasets' own files through the ``prepare_*`` entry points and
into the models (raw trees written from seeds by
``sph3d_gcn_torch.data.raw_trees`` in a temporary directory):

47. raw trees in the published layouts: ModelNet40's
    ``modelnet40_normal_resampled`` (32 train and 8 test shapes over 8
    classes, 36 of 12000 points and 4 of 10000, the files' own count),
    two S3DIS rooms of 6 x 4 x 3 m with 300000 surface points each, a
    ScanNet train scene (binary PLY, NYU-40 labels, faces) and test scene
    (ascii), 3 ShapeNet categories of 4 shapes, a RueMonge2014 street;
48. ``cli.prepare_modelnet`` on the card at ``--num_point`` 10000 and
    1024: K1 launched once for each shape with more points than asked
    (B = 1, N of the raw shape), every K1 call replayed bitwise against
    the plain FPS (run over each size's clouds stacked; timed at B = 1),
    with its span and device time a shape and its bound;
49. ``cli.prepare_s3dis``, ``prepare_scannet``, ``prepare_shapenet`` and
    ``prepare_ruemonge2014`` (host numpy; seconds each, the S3DIS blocks'
    inner and stored points); every record file of the six preparations
    read by the native reader and the Python reader, records with CRCs
    checked and without, and decoded Examples without (what
    ``data.datasets`` loads): equal records, MiB/s of each;
50. ``cli.train_modelnet`` on the prepared records (dense, hard windows,
    B=16, N=10000): one epoch of 2 steps and its eval batch, launches as
    phase 36 counts them;
51. ``cli.measure_windows --dataset s3dis --data`` on 2 draws of N=8192
    points from each block of the prepared S3DIS area 1 (the windows
    beside ``s3dis_config``'s, calibrated on uniform blocks), forwards of
    B=8 with ``s3dis_config``'s windows on 32 of those draws (how many
    fail the certificate; nothing re-run), then
    ``cli.evaluate_scene_seg --scene_dir --save_blocks`` on that area with
    a seeded checkpoint of the measured windows: launches a forward (and a
    per-edge forward for each that re-ran), the saved blocks merged again
    equal to its merged labels;
52. TF1 bundles of a seeded ``SPH3DModelNet`` (hard windows) and
    ``SPH3DSceneSeg`` at full width under the reference's names
    (``utils.checkpoint_convert.tf_variables``, ``utils.tf1_bundle``),
    loaded by ``convert_checkpoint`` into fresh models on the card: 3
    votes of B=16 and an S3DIS forward (B=16, N=8192) bitwise equal to the
    source models'; write and read seconds.

Then the last reference operator and the parity tools (their card
side runs right after the build; their host side in 3 spawned processes
beside phases 11-52, after the main path's timed phases 3-10, collected
at the end, with each job's span on the script's clock):

53. the cube query (edge 0.2, grid 3, K=64) and the dilated sphere query
    with bins (radius 0.1 x 2.0) at ModelNet level-0 scale (B=16, N=10000
    on ellipsoid surfaces, the M=2500 FPS queries of each cloud), timed:
    the cube query's idx, bin and count bitwise equal to the same call on
    the CPU; the dilated query equal to the undilated one at radius 0.2,
    held against exact (f64) distances on the card (no point kept past,
    or skipped inside, 4e-6 of the threshold ``r - 1e-6``), and against
    the same call on the CPU, whose in-range test's matmul form rounds
    otherwise: at most 1e-3 of the rows differ, each first at a point one
    device keeps and the other does not within 4e-6 of the threshold,
    and the entries both keep have equal bins and distances within 1e-6;
54. the dense engine in f32 (``modelnet_config(fast=True, dense=True)``
    with ``compute_dtype="float32"``) at B=1, N=10000 on the JAX parity
    script's first cloud, sorted beforehand by ``ops.locality.spatial_sort``
    (the model's sort of it asserted the identity), windows measured on
    it (``utils.windows``) and widened if the config's miss it, the
    seeded model's BN statistics calibrated (``cli.parity_check``),
    ``dense_ok`` and the launches of one forward; its logits against the
    NumPy oracle's (``utils.numpy_reference``) at rtol = atol = 1e-4;
55. the same for ``s3dis_config(fast=True, dense=True)`` at N=8192 (K7 in
    its launches);
56. ``cli.parity_check --model modelnet --oracle --batch_size 1`` (the
    default config: the per-edge engine in f32), in this process after
    every other phase.

Then data parallelism (``sph3d_gcn_torch.parallel``), last:

57. a world-1 NCCL group in this process: its all-reduce and all-gather
    on the card, then the ModelNet dense step (bf16, B=16, N=10000,
    seeded weights, dropout on) three times from one state through
    ``classification_step_factory(..., group=...)``, bitwise equal to
    three plain single-process kernel steps (loss, ``dense_ok``, every
    gradient, the final parameters and statistics) under
    ``torch.use_deterministic_algorithms(True)``, launches ``PER_STEP`` a
    step (a group of one runs no collective in a step); then, once phase
    58's ranks are done, steps with and without the group timed
    alternately (the group's cost a step);
58. two ranks sharing the card over gloo with CUDA tensors, spawned
    before phase 56 (``parallel.run_ranks``; beside it they build their
    batches and steps, check each collective the steps use and run each
    step once, then wait for phase 57 and the references to end): each
    runs
    its 8 rows of a ModelNet step (B=16, N=10000) and of an S3DIS
    inner-masked step (B=16, N=8192), f32 activations, held against the
    one-process kernel step on the 16 items (loss within
    ``DP_LOSS_TOL``, each gradient leaf within ``DP_GRAD_TOL`` of the
    larger of its norm and the median leaf's, BN statistics within
    ``DP_STATS_TOL``; the measured errors printed beside them), launches
    ``PER_STEP`` / ``PER_SEG_STEP`` a rank, each rank's step time. Then
    the same two ranks form one point group (``parallel.split_groups``)
    and run the S3DIS dense train step point-sharded (``point_axis``;
    B=16, N=8192, f32; rows 8192, 2048 and 768 split two ways, 384 and
    128 replicated): every K1-K7 and K9 call of one sharded step
    recorded and held against its plain version on the same operands
    (K6's and K9's f32 sums within ``F32_SUM_TOL``), beside phases 56-57
    before the go and before anything is timed (``sp_prepare``); after
    the data-parallel steps (``sp_measure``) the step against the one-process kernel step on the same
    batch and weights (``dp_hold``'s gates, ``halo_ok``, the gathered
    logits within ``SP_LOGIT_TOL``, the Adam update by ``SP_RESOLVED``
    and ``SP_UNRESOLVED``), launches ``PER_SEG_STEP`` a rank; the step's
    ms (median of ``SP_TIMED``), the halo exchanges' count, rows, bytes
    and host ms a step (two ranks sharing one card over gloo, staged
    through the host: not a two-card figure); one bf16 step, finite.

Each replayed K1 call prints its launch plan (cluster size, threads,
points a thread) and its time per greedy step, of the span and of the
device alone.

Every kernel's line in the per-kernel JSON carries its summed times,
errors and launches from one path (``path``: the S3DIS serving forward
for K1, K3 and K4, the weighted-unpool S3DIS forward for K7 and the IDS
ModelNet train step for K2 (both with their distance maps, phase 30),
the S3DIS train step for K5 and K6, the per-edge forward for K8, the
per-edge train step for K9), its bound
(``bound_ms``: per replayed call the larger of its bytes over the card's
memory rate and its operations over the f32 rate, summed; ``bound_by``
names the side that binds most of that sum) and ``library_ms``, the time
of one PyTorch call computing the same function where one exists;
``paths`` holds the same numbers from every path that replayed the
kernel's calls (K1 and K8 on ``s3dis_per_edge_serve``, K8 and K9 on
``s3dis_per_edge_train_step``, beside the paths above), and
``fit_paths`` the kernel's launches on the entry points' runs:
``modelnet_fit`` and ``modelnet_fit_resumed`` (the train steps of one
epoch of phases 36 and 37), ``modelnet_eval_cli`` (phase 38),
``s3dis_fit_fallback`` (phase 39), ``shapenet_onehot_fit`` and
``shapenet_category_fit`` (phase 42), ``shapenet_eval_cli`` (phase 43),
``ruemonge_fit`` (phase 45), ``s3dis_scene_eval_cli`` (both areas),
``ruemonge_scene_eval_cli`` (phase 46), ``modelnet_prep_10000`` and
``modelnet_prep_1024`` (phase 48), ``modelnet_prepared_fit`` (phase 50),
``s3dis_prepared_scene_eval_cli`` (phase 51), ``modelnet_profile_step``
(phase 10), ``cube_dilated_queries`` (phase 53),
``modelnet_oracle_dense`` and ``s3dis_oracle_dense`` (phases 54-55),
``modelnet_oracle_cli`` (phase 56), ``modelnet_dp_world1`` (phase 57)
and ``modelnet_dp_rank0``, ``modelnet_dp_rank1``, ``s3dis_dp_rank0``,
``s3dis_dp_rank1``, ``s3dis_sp_rank0``, ``s3dis_sp_rank1`` (phase 58:
each rank's launches, data-parallel and point-sharded); ``paths``
also holds the replays of ``shapenet_onehot_train_step``,
``shapenet_serve``, ``ruemonge_train_step``, ``s3dis_scene_eval`` (their
launches: the timed steps, the eval CLIs' forwards) and
``modelnet_prep`` (K1's calls of both preparations of phase 48).

Any failure raises and the script exits non-zero. A line before the
last three gives the script's own wall time. The last two lines are the
per-kernel JSON object and the contract line ``{"ok": true,
"device": {...}}``. Run from the repository root: ``python3
chip_smoke.py``.
"""

from __future__ import annotations

import os

# a fixed cuBLAS workspace makes its GEMMs reproducible; it is read when
# CUDA starts, so it is set before torch is imported
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import collections  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sph3d_gcn_torch.ops.costs import (  # noqa: E402
    LAUNCHED_BY,
    MEM_BYTES_PER_S,
    UNPOOLS,
    bound_of,
    valid_edges,
    work,
)
from sph3d_gcn_torch.train.profiling import (  # noqa: E402
    report_trace,
    trace_events,
)

B, N = 16, 10000
BATCHES, VOTES = 2, 3
REPS = 5
# the plain versions' timed runs in the ModelNet forward and train
# replays, dense and per-edge (phases 3, 6, 14 and 16; one run, after a
# warm-up, as the S3DIS replays time them: the plain times only set the
# kernels' speedups)
FWD_PLAIN_REPS = 1
PLAIN_REPS = 1
STEPS = 12
CONV_TOL = 1e-2      # bf16 outputs: f32 sums in another order, one rounding
DX_ATOL = 1e-3       # conv backward dx: of its largest magnitude
DFILT_TOL = 1e-4     # conv backward f32 dfilt: of its largest magnitude
LOGIT_TOL = 1e-2     # of the largest |logit|: bf16 rounding may compound
LOSS_TOL = 1e-2      # kernel step vs plain step, of the loss
# f32 kernel step vs f32 plain step: each gradient leaf's L2 error over the
# larger of its norm and the median leaf's norm. A batch-norm bias of the
# S3DIS decoder sums the upstream gradient over all 131072 points and
# cancels to 4-10% of the median leaf's norm, so sum-order differences
# through 20 layers read up to 9.0e-3 of its own norm (8.7e-4 of the
# median's); the median leaf reads 1e-6.
GRAD_TOL = 2e-3
BF16_GRAD_SLACK, BF16_GRAD_ATOL = 2.0, 0.05   # bf16 steps vs the f32 grads
PER_FORWARD = {"fps": 3, "dense_query": 6, "dense_conv": 6, "rank_pool": 3}
# launches per step: a conv backward (K5) launches three kernels (the
# dfilt partials of each query tile, their sum over tiles, dx)
K5_PER_CALL = 3
PER_STEP = dict(PER_FORWARD, dense_conv_bwd=6 * K5_PER_CALL, rank_pool_bwd=3)
S3_B, S3_N = 16, 8192               # the S3DIS serving batch
S3_BLOCKS, S3_P = 32, 10000         # served blocks and their points
S3_PLAIN_REPS = 1                   # the plain versions of the S3DIS replay
PER_SEG_FORWARD = {"fps": 4, "dense_query": 12, "growth_query": 4,
                   "dense_conv": 16, "rank_pool": 4}
# the unpool backwards sum their window gradients into the cloud by K9
PER_SEG_STEP = dict(PER_SEG_FORWARD, dense_conv_bwd=16 * K5_PER_CALL,
                    rank_pool_bwd=4,
                    window_gather_bwd=4)
S3_STEPS = 10
# the per-edge (windowed) engine: per level 2 conv gathers and 1 pool
# gather (K8), each with its backward (K9) in training
PER_WIN_FORWARD = {"fps": 3, "window_gather": 9}
PER_WIN_STEP = dict(PER_WIN_FORWARD, window_gather_bwd=9)
WIN_STEPS = 8
S3W_STEPS = 4                       # the weighted-unpool S3DIS steps
# the S3DIS per-edge engine: per forward 4 FPS and 24 edge gathers (8
# encoder convs, 4 pools, 8 decoder convs, 4 unpools), each gather with
# its backward (K9) in training
PER_S3PE_FORWARD = {"fps": 4, "window_gather": 24}
PER_S3PE_STEP = dict(PER_S3PE_FORWARD, window_gather_bwd=24)
S3PE_STEPS = 5
# the entry points' phases: ModelNet records (one epoch of fit is
# TRAIN_RECORDS / B steps), the eval CLI's votes, the remat comparison
TRAIN_RECORDS, TEST_RECORDS = 64, 32
FIT_STEPS = TRAIN_RECORDS // B
EVAL_VOTES = 3
REMAT_STEPS = 2
# the ShapeNet and RueMonge paths and the scene evaluation: the one-hot
# train batch (JAX train_shapenet's B=32, N=2048), shapes of 2600 points
# (resampled to 2048), 64 train shapes over the 16 categories and 16 more
# chairs, 8 test chairs served at the eval's B=8; the RueMonge batch
# (B=16, N=8192); the scene eval's batch (JAX's B=8); timed steps and
# CUDA-event runs of these paths' replays
SN_B, SN_N, SN_POINTS = 32, 2048, 2600
SN_TRAIN_SHAPES, SN_CHAIRS, SN_TEST_CHAIRS, SN_EVAL_B = 64, 16, 8, 8
RM_B = 16
EVAL_B = 8
# the preparation phases' raw trees: ModelNet40 shapes of 12000 points
# (every tenth of N, the published files' count) over 8 classes, 32 train
# (2 steps at B) and 8 test; S3DIS rooms, ScanNet scenes and a RueMonge
# street of these many points
PREP_POINTS, PREP_TRAIN, PREP_TEST = 12000, 32, 8
PREP_CLASSES = ("airplane", "bathtub", "bed", "bench", "bookshelf",
                "bottle", "bowl", "car")
PREP_ROOM_POINTS, PREP_SCENE_POINTS, PREP_FACADE_POINTS = (
    300000, 100000, 60000)
PREP_WINDOW_DRAWS = 2   # resamples of each prepared block to measure on
PREP_DEFAULT_CLOUDS = 32  # of them, run on s3dis_config's windows
SEG_STEPS = 5
SEG_REPS = 3
# phases 53-56: the cube and dilated sphere queries at ModelNet level-0
# scale (B, N and M queries), the oracles' tolerance (rtol = atol), the
# parity CLI's own default-config run
QUERY_M = 2500
CUBE_QUERY = {"length": 0.2, "nn_sample": 64, "gridsize": 3}
DILATED_QUERY = {"radius": 0.1, "nn_sample": 64, "kernel": (8, 2, 2),
                 "dilation_rate": 2.0}
# the dilated query against the CPU's, whose in-range test's matmul form
# rounds otherwise: the share of rows that may differ, each first at a
# point within THRESHOLD_BAND of the threshold r - 1e-6 in exact distances
# (the f32 rounding of |q|^2 - 2 q.p + |p|^2 at unit coordinates, over
# 2r), and how far the distances both devices keep may differ
ROW_SHARE = 1e-3
THRESHOLD_BAND = 4e-6
DIST_TOL = 1e-6
ORACLE_TOL = 1e-4
# phases 57-58, data parallelism: the world-1 NCCL steps (bitwise) and the
# alternated timing rounds; the shared-card ranks' gate against the
# one-process step (f32: only the BN statistics' and the gradients' sums
# run in another order; the gradient gate is GRAD_TOL's, whose S3DIS
# decoder BN bias cancels; BN statistics absolute, as a mean near 0 has
# no relative error to speak of) and their time limit
DP_STEPS, DP_TIMED = 3, 3
DP_LOSS_TOL, DP_GRAD_TOL, DP_STATS_TOL = 1e-5, GRAD_TOL, 1e-5
DP_TIMEOUT = 300.0
DP_SIZES = {"modelnet": (B, N), "s3dis": (S3_B, S3_N)}
# phase 58's point-sharded S3DIS step: the two ranks form one point group
# (levels 0-2 of the B=16, N=8192 pyramid split 2 ways, 8192/2048/768
# rows; 384 and 128 run replicated) and hold the one-process f32 step on
# the same batch and weights to DP_*_TOL, its logits within SP_LOGIT_TOL
# of their largest magnitude, and its Adam update as the CPU tests do:
# every entry whose two gradients agree within SP_RESOLVED of the smaller
# within lr * SP_RESOLVED / 4 + 1e-7, the others (a gradient cancelling to
# ~1e-7 may flip its sign) under SP_UNRESOLVED of the entries
SP_POINTS = 2
SP_SHARDED_ROWS = (8192, 2048, 768)
SP_LOGIT_TOL = 1e-4
SP_LR, SP_RESOLVED, SP_UNRESOLVED = 1e-3, 0.1, 1e-3
SP_TIMED = 2
# f32 gradient sums in another order (the sharded step runs in f32): of
# the largest magnitude, a few ulps of the summed terms
F32_SUM_TOL = 1e-5
# (K6's plain version sums by scatter_add_'s atomics; K9's twins add in
# its order, so its sharded calls are held bitwise as every other's)
SP_CHECKS = ("rank_pool_bwd",)
ORACLE_CLI = ["--model", "modelnet", "--oracle", "--batch_size", "1"]
# the path whose run gives each kernel's launches and times in the JSON line
# (K2 and K7 from the option paths, whose queries write distance maps)
PATH_OF = {"fps": "s3dis_serve", "dense_query": "modelnet_ids_train_step",
           "dense_conv": "s3dis_serve", "rank_pool": "s3dis_serve",
           "growth_query": "s3dis_weighted_serve",
           "dense_conv_bwd": "s3dis_train_step",
           "rank_pool_bwd": "s3dis_train_step",
           "window_gather": "modelnet_per_edge_serve",
           "window_gather_bwd": "modelnet_per_edge_train_step"}
SOURCES = {
    "fps": ("sph3d_gcn_torch/csrc/fps.cu",
            "sph3d_gcn_tpu/ops/pallas/fps_kernel.py:44"),
    "dense_query": ("sph3d_gcn_torch/csrc/dense_query.cu",
                    "sph3d_gcn_tpu/ops/pallas/query_kernel.py:245"),
    "dense_conv": ("sph3d_gcn_torch/csrc/dense_conv.cu",
                   "sph3d_gcn_tpu/ops/dense.py:611 and :1132"),
    "rank_pool": ("sph3d_gcn_torch/csrc/rank_pool.cu",
                  "sph3d_gcn_tpu/ops/dense.py:1953"),
    "dense_conv_bwd": ("sph3d_gcn_torch/csrc/dense_conv_bwd.cu",
                       "sph3d_gcn_tpu/ops/dense.py:692 and :1183"),
    "rank_pool_bwd": ("sph3d_gcn_torch/csrc/rank_pool_bwd.cu",
                      "sph3d_gcn_tpu/ops/dense.py:2035"),
    "growth_query": ("sph3d_gcn_torch/csrc/growth_query.cu",
                     "sph3d_gcn_tpu/ops/pallas/query_kernel.py:307"),
    "window_gather": ("sph3d_gcn_torch/csrc/window_gather.cu",
                      "sph3d_gcn_tpu/ops/windowed.py:59"),
    "window_gather_bwd": ("sph3d_gcn_torch/csrc/window_gather_bwd.cu",
                          "sph3d_gcn_tpu/ops/windowed.py:71"),
}


def median_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fns: list, reps: int = REPS) -> list[float | None]:
    """Device time of one call of each of ``fns``: the summed durations
    of the kernels that the call launches (found, as in
    :func:`report_trace`, by the correlation ids of the launches inside
    its ``record_function`` span), median over the calls whose kernels
    the trace holds; None where it holds none. One ``torch.profiler``
    session times them all, ``reps`` rounds after a warm-up call of each.
    Unlike :func:`median_ms` it leaves out the host's time before the
    launch (the wrapper's Python and the launch call), during which a
    single call's CUDA-event span has the device wait."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for i, fn in enumerate(fns):
                with record_function(f"device_ms {i}"):
                    fn()
        torch.cuda.synchronize()
    events = trace_events(prof)
    launches = [(e["ts"], e["args"]["correlation"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})]
    kernels = collections.defaultdict(float)
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["args"]["correlation"]] += e["dur"]
    per_call = collections.defaultdict(list)
    for e in events:
        if (e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("device_ms ")):
            a, b = e["ts"], e["ts"] + e["dur"]
            us = sum(kernels.get(c, 0.0) for t, c in launches if a <= t < b)
            if us > 0:
                per_call[int(e["name"].split()[1])].append(us)
    return [float(np.median(per_call[i])) / 1e3 if per_call[i] else None
            for i in range(len(fns))]


def randomize_bn(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Non-trivial BN statistics and affine terms, from ``gen``."""
    from sph3d_gcn_torch.nn.layers import BatchNorm

    for bn in model.modules():
        if isinstance(bn, BatchNorm):
            c = bn.scale.shape[0]
            with torch.no_grad():
                bn.scale.copy_(0.5 + torch.rand(c, generator=gen))
                bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
                bn.mean.copy_(0.1 * torch.randn(c, generator=gen))
                bn.var.copy_(0.5 + torch.rand(c, generator=gen))


def exact(got: tuple, ref: tuple) -> None:
    """Bitwise equal outputs; an output that is None (a query's map
    not asked for) must be None in both."""
    if not all(r is None if g is None else torch.equal(g, r)
               for g, r in zip(got, ref)):
        raise AssertionError("kernel != plain")


def sums_close(got: tuple, ref: tuple) -> None:
    """Gradient sums (K6, K9): bf16 outputs bitwise equal (both sum in f32
    and round once); f32 outputs within F32_SUM_TOL of the largest
    magnitude, since the plain version's ``scatter_add_`` sums by atomics
    in no fixed order and the kernel in its own."""
    for g, r in zip(got, ref):
        if r.dtype != torch.float32:
            exact((g,), (r,))
            continue
        torch.testing.assert_close(
            g, r, rtol=F32_SUM_TOL,
            atol=F32_SUM_TOL * r.abs().max().item())


def query_exact(got: tuple, ref: tuple) -> None:
    """A query's outputs bitwise equal (:func:`exact`), and the kernel's
    count (its second-to-last output) equal to its map's nonzero bytes a
    row."""
    exact(got, ref)
    packed, count = got[0], got[-2]
    nnz = (packed > 0).sum(-1, dtype=torch.int32).reshape(count.shape)
    if not torch.equal(count, nnz):
        raise AssertionError("count != the map's nonzero bytes a row")


def close(got: tuple, ref: tuple) -> None:
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(), rtol=CONV_TOL,
                                   atol=CONV_TOL)


def conv_grads_close(got: tuple, ref: tuple) -> None:
    """(dx, dfilt): bf16 dx within rtol CONV_TOL and DX_ATOL of its largest
    magnitude; f32 dfilt within DFILT_TOL of its largest magnitude."""
    (dx, dfilt), (dx_p, dfilt_p) = got, ref
    torch.testing.assert_close(
        dx.float(), dx_p.float(), rtol=CONV_TOL,
        atol=DX_ATOL * dx_p.abs().max().item())
    torch.testing.assert_close(
        dfilt, dfilt_p, rtol=DFILT_TOL,
        atol=DFILT_TOL * dfilt_p.abs().max().item())


def versions():
    """Per kernel: (kernel wrapper, plain version, comparison)."""
    from sph3d_gcn_torch.ops import dense as D
    from sph3d_gcn_torch.ops import query as Q
    from sph3d_gcn_torch.ops import sample as S
    from sph3d_gcn_torch.ops import windowed as W

    return {
        "fps": (S.farthest_point_sample_kernel,
                S.farthest_point_sample_plain, exact),
        "dense_query": (Q.dense_query_kernel, Q.dense_query_plain,
                        query_exact),
        "dense_conv": (D.dense_conv_kernel, D.dense_conv_plain, close),
        "rank_pool": (D.rank_pool_kernel, D.rank_pool_plain, exact),
        "dense_conv_bwd": (D.dense_conv_bwd_kernel, D.dense_conv_bwd_plain,
                           conv_grads_close),
        "rank_pool_bwd": (D.rank_pool_bwd_kernel, D.rank_pool_bwd_plain,
                          exact),
        "growth_query": (Q.growth_query_kernel, Q.growth_query_plain,
                         query_exact),
        "window_gather": (W.window_gather_kernel, W.window_gather_plain,
                          exact),
        # the dense window sums' backward: K9's form (b), or its plain
        # version
        "mean_interpolate_bwd": (D.window_mean_bwd, functools.partial(
            D.window_mean_bwd, use_kernels=False), exact),
        "window_gather_bwd": (W.window_gather_bwd_kernel,
                              W.window_gather_bwd_plain, exact),
    }


def library_call(name: str, args: tuple, kw: dict):
    """One PyTorch call computing the same function, as a thunk, or None
    where PyTorch has none (no PyTorch call reads packed window maps). For
    the pool backward it is the ``scatter_add_`` of the plain version, its
    flat row indices computed beforehand (not timed); for K8
    ``torch.gather`` with the lane mask; for K9 ``index_add_`` of every
    edge row into its target (invalid edges into a spare row), in the
    gradient's dtype, its per-edge targets computed beforehand."""
    if name == "window_gather":
        x, idx, count = args
        m_pad = -(-idx.shape[1] // 128) * 128
        pad = (0, 0, 0, m_pad - idx.shape[1])
        idx_p = torch.nn.functional.pad(idx, pad)
        valid = (torch.arange(idx.shape[2], device=idx.device)
                 < torch.nn.functional.pad(count, pad[2:])[..., None])
        flat = idx_p.reshape(x.shape[0], -1, 1).expand(-1, -1, x.shape[2])
        mask = valid.reshape(x.shape[0], -1, 1)
        return lambda: torch.where(mask, torch.gather(x, 1, flat), 0)
    if name == "window_gather_bwd":
        dg, order, starts, num_in = args
        rows = dg.shape[0] * num_in
        n_valid = int(starts[-1].item())
        target = torch.full((order.numel(),), rows, dtype=torch.int64,
                            device=dg.device)
        target[order[:n_valid].long()] = torch.repeat_interleave(
            torch.arange(rows, device=dg.device), starts.diff().long())
        src = dg.reshape(-1, dg.shape[3])
        dx = torch.zeros((rows + 1, dg.shape[3]), dtype=dg.dtype,
                         device=dg.device)
        return lambda: dx.index_add_(0, target, src)
    if name == "mean_interpolate_bwd":
        # what autograd of the window gather did before: the same window
        # gradients, scatter-added into the cloud (index_put_ accumulate)
        from sph3d_gcn_torch.ops import dense as D

        packed, s_blk, dout, num_in = args
        batch, n_t, _, w = packed.shape
        c = dout.shape[2]
        rows, valid, b_of_g = D._window_rows(packed, s_blk, num_in)
        mask = kw.get("weights", packed > 0).reshape(
            batch * n_t, 128, w).float()
        flat = (b_of_g[:, None] * num_in + rows)[valid]
        g = dout.reshape(batch * n_t, 128, c)
        dx = torch.zeros((batch * num_in, c), device=dout.device)
        return lambda: dx.index_put_(
            (flat,), torch.einsum("gtw,gtc->gwc", mask, g)[valid],
            accumulate=True)
    if name != "rank_pool_bwd":
        return None
    s_blk, arg, dout, num_in, _ = args
    batch, _, c = arg.shape
    rows = s_blk.long().repeat_interleave(128, dim=1)[..., None] * 128
    live = arg >= 0
    flat = torch.arange(batch, device=arg.device)[:, None, None] * num_in
    flat = torch.where(live, flat + rows + arg, 0).reshape(-1, c)
    src = torch.where(live, dout, 0).reshape(-1, c)
    dx = torch.zeros((batch * num_in, c), dtype=dout.dtype,
                     device=dout.device)
    return lambda: dx.scatter_add_(0, flat, src)


def describe(name: str, args: tuple, kw: dict) -> str:
    """A recorded call's shapes, for the log."""
    if name == "fps":
        from sph3d_gcn_torch.ops import sample as S

        b, n = args[1].shape[:2]
        plan = S.fps_plan(b, n, S.max_active_clusters)
        return f"{n} -> {args[0]} points, {plan}"
    dist = " +dist" if kw.get("need_dist") else ""
    if name == "dense_query":
        kind = "ranks" if kw["kernel"] is None else "bins"
        return f"{kind} M_pad={args[1].shape[1]} W={kw['window']}{dist}"
    if name == "rank_pool_bwd":
        return f"C={args[1].shape[2]} W={args[4]}"
    if name == "growth_query":
        return (f"ranks M_pad={args[1].shape[1]} W={kw['window']} "
                f"G={kw['growth_steps']}{dist}")
    if name in UNPOOLS:
        return (f"C={args[0].shape[2]} M={args[1].num_query} "
                f"W={args[1].window}")
    if name == "mean_interpolate_bwd":
        return (f"C={args[2].shape[2]} N={args[3]} W={args[0].shape[-1]}"
                + (" weighted" if "weights" in kw else ""))
    if name == "window_gather":
        lanes = args[0].shape[0] * (-(-args[1].shape[1] // 128) * 128) \
            * args[1].shape[2]
        return (f"{str(args[0].dtype)[6:]} C={args[0].shape[2]} "
                f"N={args[0].shape[1]} M={args[1].shape[1]} valid "
                f"{valid_edges(name, args) / lanes:.3f}")
    if name == "window_gather_bwd":
        return (f"{str(args[0].dtype)[6:]} C={args[0].shape[3]} "
                f"N={args[3]} M_pad={args[0].shape[1]} valid "
                f"{valid_edges(name, args) / args[1].numel():.3f}")
    w = args[0].shape[-1]
    if name in ("dense_conv", "dense_conv_bwd"):
        return f"C={args[2].shape[2]} r={args[3].shape[3]} W={w}"
    kind = "bins" if args[2] is None else "ranks"
    return (f"{kind} {str(args[3].dtype)[6:]} C={args[3].shape[2]} W={w}"
            + "".join(f" +{k[5:]}" for k in kw))


class Results:
    """Per-kernel parity errors, times and bounds, summed over the main
    path's calls of one forward (or one train step)."""

    def __init__(self) -> None:
        self.err = collections.defaultdict(float)
        self.ms = collections.defaultdict(float)
        self.plain_ms = collections.defaultdict(float)
        self.library_ms = collections.defaultdict(float)
        self.has_library = set()
        # the pool backward's device time beside its library call's, and
        # the calls that have both (profiler; the single-call spans above
        # hold the host's time too)
        self.device = collections.defaultdict(lambda: [0.0, 0.0, 0])
        self.device_bound = collections.defaultdict(float)
        self.device_queue = []
        self.calls = collections.Counter()
        # the bound's summed time, split by which side binds each call
        self.bound_ms = collections.defaultdict(
            lambda: {"bytes": 0.0, "operations": 0.0})

    def add_bound(self, name, work_done, ms):
        """Add one call's bound; its log text, with the share of the
        bound that the call's ``ms`` reached."""
        t, side = bound_of(work_done)
        data, ops = work_done
        self.bound_ms[name][side] += t
        self.calls[name] += 1
        return (f"bound {t:.4f} ms ({side}: {data / 1e6:.1f} MB, "
                f"{ops / 1e9:.3f} Gop) share {t / ms:.3f}")

    def bound(self, name) -> tuple[float, str]:
        parts = self.bound_ms[name]
        return sum(parts.values()), max(parts, key=parts.get)

    def summary(self, what: str) -> None:
        """Per kernel, the sums over the path's calls: kernel, plain and
        library time, the bound and the kernel's share of it."""
        self.time_device()
        print(f"summary, {what} (sums over its calls; share = bound / "
              f"kernel ms):", flush=True)
        for name in self.calls:
            bound_ms, bound_by = self.bound(name)
            lib = (f"library {self.library_ms[name]:.3f} ms"
                   if name in self.has_library else "library none")
            plain = (f"plain {self.plain_ms[name]:.3f} ms"
                     if name in self.plain_ms else "no kernel")
            print(f"  {name:16s} {self.calls[name]:3d} calls  "
                  f"{self.ms[name]:8.3f} ms  {plain}  {lib}  bound "
                  f"{bound_ms:.4f} ms ({bound_by})  share "
                  f"{bound_ms / self.ms[name]:.3f}", flush=True)
            if name in self.device:
                k_ms, l_ms, n = self.device[name]
                lib = ("library none" if name not in self.has_library
                       else f"library {l_ms:.4f} ms" if l_ms
                       else "library not profiled")
                print(f"  {name:16s} device time (profiler), {n} of "
                      f"{self.calls[name]} calls: kernel {k_ms:.4f} ms  "
                      f"{lib}  share {bound_ms / k_ms:.3f}", flush=True)
        for name, (k_ms, _, n) in self.device.items():
            if name not in self.calls:       # K9 inside the unpool calls
                bound_ms = self.device_bound[name]
                print(f"  {name:16s} device time (profiler), {n} calls: "
                      f"kernel {k_ms:.4f} ms  bound {bound_ms:.4f} ms  "
                      f"share {bound_ms / k_ms:.3f}", flush=True)

    def add_device(self, name, what, kern, lib, work_done,
                   steps=None) -> None:
        """Queue one call's kernel and library call (None where PyTorch
        has none) for :meth:`time_device`; ``steps``: K1's greedy steps,
        for its time a step."""
        self.device_queue.append((name, what, kern, lib, work_done, steps))

    def time_device(self) -> None:
        """The queued calls' device times (:func:`device_ms`, one profiler
        session), each beside its library call's, if any, and its bound."""
        if not self.device_queue:
            return
        fns = [f for q in self.device_queue for f in q[2:4] if f is not None]
        times = iter(device_ms(fns))
        print("device times (profiler; the spans above also hold the "
              "host's time before each launch):", flush=True)
        for name, what, _, lib, work_done, steps in self.device_queue:
            k_ms = next(times)
            l_ms = next(times) if lib is not None else 0.0
            if k_ms is None or l_ms is None:
                print(f"  {name:14s} {what:30s} not measured: the trace "
                      f"holds no kernel of the call", flush=True)
                continue
            acc = self.device[name]
            acc[0] += k_ms
            acc[1] += l_ms
            acc[2] += 1
            self.device_bound[name] += bound_of(work_done)[0]
            lib_text = (f"library {l_ms:.4f} ms" if lib is not None
                        else "library none")
            step = (f"  {k_ms * 1e3 / steps:.3f} us a greedy step"
                    if steps else "")
            print(f"  {name:14s} {what:30s} kernel {k_ms:.4f} ms  "
                  f"{lib_text}  share {bound_of(work_done)[0] / k_ms:.3f}"
                  f"{step}", flush=True)
        self.device_queue = []

    def add(self, name, what, got, ref, ms, plain_ms, check, work_done,
            library_ms=None):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        # equal entries (infinities included) count 0
        err = max(torch.where(g.float() == r.float(), 0.0,
                              (g.float() - r.float()).abs()).max().item()
                  for g, r in zip(got, ref) if g is not None)
        self.err[name] = max(self.err[name], err)
        self.ms[name] += ms
        self.plain_ms[name] += plain_ms
        lib = ""
        if library_ms is not None:
            self.has_library.add(name)
            self.library_ms[name] += library_ms
            lib = (f"  library {library_ms:.3f} ms (kernel/library "
                   f"{ms / library_ms:.2f})")
        bound = self.add_bound(name, work_done, ms)
        print(f"  {name:14s} {what:30s} max_abs_err {err:.3g}  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms{lib}  {bound}",
              flush=True)
        try:
            check(got, ref)
        except AssertionError as e:
            raise AssertionError(f"{name} {what}: {e}") from e


def replay(calls: list, res: Results, expect: dict[str, int],
           plain_reps: int = REPS, reps: int = REPS,
           device: bool = True, checks: dict | None = None) -> None:
    """Replay recorded kernel-wrapped calls through the kernel and its
    plain version: compare the two and time both (and the library call,
    where one exists), each the median of ``reps`` runs (the plain
    version's of ``plain_reps``); ``device`` also queues each call's
    device time (:meth:`Results.time_device`). ``expect`` is the number
    of launches of each kernel the recorded run's calls make (a
    wrapper's ``per_call`` a call). Recorded masked-mean unpools
    (plain PyTorch, no kernel) are timed; their backwards launch K9 and
    are replayed as kernels, with the scatter-add that autograd of the
    window gather would run as their library call. ``checks``: kernel
    name -> its comparison in place of :func:`versions`'s."""
    from sph3d_gcn_torch import _build
    from sph3d_gcn_torch.ops import dense as D
    from sph3d_gcn_torch.ops import windowed as W

    unpool = {"mean_interpolate": D.dense_mean_interpolate,
              "weighted_interpolate": D.dense_weighted_interpolate,
              "avg_pool": D.dense_avg_pool3d}
    seen = {name: 0 for name in expect}
    for name, _, _ in calls:
        if name not in unpool:
            name = LAUNCHED_BY.get(name, name)
            seen[name] = seen.get(name, 0) + _build.KERNELS[name].per_call
    if seen != expect:
        raise AssertionError(f"recorded calls {seen}, want {expect}")
    table = versions()
    for name, check in (checks or {}).items():
        table[name] = table[name][:2] + (check,)
    with torch.no_grad():
        for name, args, kw in calls:
            what = describe(name, args, kw)
            if name in unpool:
                ms = median_ms(lambda: unpool[name](*args), reps)
                res.ms[name] += ms
                print(f"  {name:14s} {what:30s} torch {ms:.3f} ms  "
                      f"{res.add_bound(name, work(name, args, kw), ms)}",
                      flush=True)
                continue
            kern, plain, check = table[name]
            n = min(reps, 3) if name == "fps" else reps
            lib = library_call(name, args, kw)
            ms = median_ms(lambda: kern(*args, **kw), n)
            res.add(name, what, kern(*args, **kw), plain(*args, **kw), ms,
                    median_ms(lambda: plain(*args, **kw),
                              min(n, plain_reps)), check,
                    work(name, args, kw),
                    None if lib is None else median_ms(lib, n))
            if not device:
                if name == "fps":
                    steps = max(args[0] - 1, 1)
                    print(f"  {'':14s} {what:30s} {ms * 1e3 / steps:.3f} "
                          f"us a greedy step (span)", flush=True)
                continue
            if name in ("dense_conv", "rank_pool_bwd", "dense_conv_bwd",
                        "dense_query", "growth_query", "rank_pool",
                        "window_gather", "window_gather_bwd"):
                # K9's library call (index_add_ into a few rows) takes
                # 0.1-0.4 s a call: its span above is enough
                res.add_device(name, what,
                               functools.partial(kern, *args, **kw),
                               None if name == "window_gather_bwd" else lib,
                               work(name, args, kw))
            if name == "mean_interpolate_bwd":
                # the whole backward beside the einsum and scatter-add it
                # replaced, and K9 (form (b)) alone, without the wrapper
                res.add_device(name, what,
                               functools.partial(kern, *args, **kw), lib,
                               work(name, args, kw))
                res.add_device("window_gather_bwd", what, functools.partial(
                    W.window_sum_bwd_kernel, kw.get("weights", args[0]),
                    *args[1:]), None, work(name, args, kw))
            if name == "fps":
                steps = max(args[0] - 1, 1)
                print(f"  {'':14s} {what:30s} {ms * 1e3 / steps:.3f} us a "
                      f"greedy step (span)", flush=True)
                res.add_device(name, what, functools.partial(kern, *args),
                               None, work(name, args, kw), steps)


def k9_line(res: Results, what: str,
            goal: tuple[str, float] | None = None) -> None:
    """K9's times on one path, summed over its calls (PERF.md §6): the
    per-edge steps' K9 span and device ms; a dense step's window-sum
    backwards' span and device ms, whole, and K9's own inside them;
    beside the goal (``span`` or ``device``, at most so many ms), if any."""
    res.time_device()
    dense = "mean_interpolate_bwd" in res.calls
    name = "mean_interpolate_bwd" if dense else "window_gather_bwd"
    times = {"span": res.ms[name]}
    text = f"span {times['span']:.3f} ms"
    if name in res.device:
        times["device"] = res.device[name][0]
        text += f", device {times['device']:.4f} ms"
    if dense and "window_gather_bwd" in res.device:
        text += f" (K9 alone {res.device['window_gather_bwd'][0]:.4f} ms)"
    if goal is not None:
        side, most = goal
        met = side in times and times[side] <= most
        text += f"; goal: {side} at most {most} ms, {'met' if met else 'missed'}"
    print(f"K9 on {what} ({res.calls[name]} calls): {text}", flush=True)


def kernel_parity(model, x: torch.Tensor, res: Results, what: str) -> None:
    """Record the kernel-wrapped calls of one plain forward of ``model`` on
    ``x``, then replay each through the kernel and its plain version."""
    from sph3d_gcn_torch import _build

    with _build.record_calls() as calls, torch.inference_mode():
        model(x, use_kernels=False)
    replay(calls, res, PER_FORWARD, plain_reps=FWD_PLAIN_REPS)
    res.summary(what)


def profile_forward(model, x: torch.Tensor, family: str,
                    reps: int = 3) -> None:
    """``torch.profiler`` over 1 + ``reps`` synchronised forwards; see
    :func:`report_trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(1 + reps):
                with record_function("serve_forward"):
                    model(x)
                    torch.cuda.synchronize()
    report_trace(trace_events(prof), f"{family} forward", reps)


def profile_steps(step_fn, what: str, reps: int = 3) -> None:
    """``torch.profiler`` over 1 + ``reps`` synchronised calls of
    ``step_fn`` (train steps); see :func:`report_trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(1 + reps):
            with record_function("train_step"):
                step_fn()
                torch.cuda.synchronize()
    report_trace(trace_events(prof), what, reps, span="train_step")


def leaf_errors(got: dict, ref: dict, floor: float = 0.0) -> dict:
    """L2 error of each gradient leaf over the larger of the reference
    leaf's norm and ``floor`` (0: the relative L2 error)."""
    return {k: ((got[k] - ref[k]).norm() / max(ref[k].norm().item(), floor)
                ).item() for k in ref}


def compare_steps(grads_of, factory, model32, what: str) -> None:
    """One kernel step against one plain step from the same state, batch
    and dropout seed: the bf16 loss within LOSS_TOL; with f32 activations
    every gradient leaf's error within GRAD_TOL of the larger of its norm
    and the median leaf's norm, a gate that must reject the bf16 kernel
    step's gradients in the f32 step's place (a planted fault); each bf16
    kernel leaf's relative error against the f32 plain gradients within
    BF16_GRAD_SLACK x the bf16 plain leaf's plus BF16_GRAD_ATOL.
    ``grads_of(step)`` gives (metrics, gradients) of one step from the
    fixed state; ``factory(use_kernels, net)`` makes a step on ``net``
    (default: the served bf16 model)."""
    m_k, g_k = grads_of(factory(None))
    m_p, g_p = grads_of(factory(False))
    _, g_k32 = grads_of(factory(None, model32))
    _, g_p32 = grads_of(factory(False, model32))
    loss_k, loss_p = m_k["loss"].item(), m_p["loss"].item()
    med = float(np.median([v.norm().item() for v in g_p32.values()]))
    e32, fault = leaf_errors(g_k32, g_p32, med), leaf_errors(g_k, g_p32, med)
    e_k, e_p = leaf_errors(g_k, g_p32), leaf_errors(g_p, g_p32)
    e_kp = leaf_errors(g_k, g_p)
    bound = {k: BF16_GRAD_SLACK * e_p[k] + BF16_GRAD_ATOL for k in e_p}
    caught = [k for k in fault if not fault[k] <= GRAD_TOL]
    print(f"{what} kernel vs plain: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(bf16); f32 kernel vs f32 plain, L2 error per gradient leaf "
          f"over the larger of its norm and the median leaf's, max / "
          f"median over {len(e32)} leaves: "
          f"{max(e32.values()):.3g} / "
          f"{float(np.median(list(e32.values()))):.3g} "
          f"(tolerance {GRAD_TOL}); relative L2 error, bf16 kernel vs bf16 "
          f"plain {max(e_kp.values()):.3g} / "
          f"{float(np.median(list(e_kp.values()))):.3g}; against the f32 "
          f"gradients: bf16 kernel {max(e_k.values()):.3g}, bf16 plain "
          f"{max(e_p.values()):.3g} (tolerance per leaf "
          f"{BF16_GRAD_SLACK} x plain's + {BF16_GRAD_ATOL})", flush=True)
    print(f"  planted fault, the bf16 kernel step's gradients in the f32 "
          f"kernel step's place: {len(caught)} of {len(fault)} leaves over "
          f"the f32 tolerance, max / median {max(fault.values()):.3g} / "
          f"{float(np.median(list(fault.values()))):.3g}", flush=True)
    for k in sorted(e_kp, key=e_kp.get, reverse=True)[:5]:
        print(f"  bf16 kernel vs plain {e_kp[k]:.3g}, vs f32: kernel "
              f"{e_k[k]:.3g} plain {e_p[k]:.3g}  {k}", flush=True)
    e_rel = leaf_errors(g_k32, g_p32)
    for k in sorted(e32, key=e32.get, reverse=True)[:3]:
        print(f"  f32 kernel vs plain {e32[k]:.3g} (of its own norm "
              f"{e_rel[k]:.3g}), leaf norm / median leaf norm "
              f"{g_p32[k].norm().item() / med:.3g}  {k}", flush=True)
    if abs(loss_k - loss_p) > LOSS_TOL * abs(loss_p):
        raise AssertionError(f"{what}: loss {loss_k} vs plain {loss_p}")
    bad = [k for k in e32 if not e32[k] <= GRAD_TOL]
    bad += [k for k in e_k if not e_k[k] <= bound[k]]
    if bad:
        raise AssertionError(f"{what}: gradient leaves out of tolerance: "
                             f"{bad}")
    if not caught:
        raise AssertionError(f"{what}: the f32 gate passes the bf16 step's "
                             f"gradients: it could not see a fault")


def check_bitwise_steps(grads_of, kernel_step, what: str) -> None:
    """Two kernel steps from the same state give bitwise-equal loss and
    gradients under ``torch.use_deterministic_algorithms(True)``."""
    torch.use_deterministic_algorithms(True)
    try:
        m_1, g_1 = grads_of(kernel_step)
        m_2, g_2 = grads_of(kernel_step)
    finally:
        torch.use_deterministic_algorithms(False)
    same = [k for k in g_1 if torch.equal(g_1[k], g_2[k])]
    print(f"determinism{what}: {len(same)} of {len(g_1)} gradient leaves "
          f"bitwise equal over two kernel steps, loss "
          f"{'equal' if torch.equal(m_1['loss'], m_2['loss']) else 'differs'}"
          f" (torch.use_deterministic_algorithms(True))", flush=True)
    if len(same) != len(g_1) or not torch.equal(m_1["loss"], m_2["loss"]):
        raise AssertionError("two kernel steps gave different gradients")


def check_recovery(what: str, dense_step, direct_step, model, state0: dict,
                   batch: dict, step_args, per_step: dict[str, int]) -> None:
    """``fit()``'s recovery of a batch that fails the dense certificate:
    one dense step (``dense_step``, on the dense twin of ``model``) must
    report ``dense_ok`` False; from the restored pre-step state its
    ``classic_fallback()`` re-runs the batch, which must leave the dense
    model's parameters and statistics bitwise equal to a separate
    per-edge step (``direct_step()``, on ``model`` from ``state0``), with
    ``per_step`` launches; ``step_args()`` gives each step's extra
    arguments (a fresh dropout generator). Under
    ``torch.use_deterministic_algorithms(True)``."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches

    dense = dense_step.model
    owners = (dense, dense_step.optimizer, dense_step.scheduler)
    snapshot = [copy.deepcopy(x.state_dict()) for x in owners]
    torch.use_deterministic_algorithms(True)
    try:
        if bool(dense_step.train_step(batch, *step_args())["dense_ok"]):
            raise AssertionError(f"the {what} passed the dense "
                                 f"certificate: no fallback to exercise")
        for x, state in zip(owners, snapshot):
            x.load_state_dict(state)
        fb = dense_step.classic_fallback()
        reset_kernel_launches()
        m_fb = fb.train_step(batch, *step_args())
        fb_launches = kernel_launches()
        model.load_state_dict(state0)
        m_ref = direct_step().train_step(batch, *step_args())
    finally:
        torch.use_deterministic_algorithms(False)
    after = dense.state_dict()
    same = [k for k, v in model.state_dict().items()
            if torch.equal(v, after[k])]
    print(f"fallback step on the {what}: dense certificate False, re-run "
          f"through classic_fallback(): loss {m_fb['loss'].item():.6f} (a "
          f"separate per-edge step from the same state: "
          f"{m_ref['loss'].item():.6f}), {len(same)} of {len(state0)} "
          f"parameters and statistics of the dense model bitwise equal to "
          f"that step's; launches {fb_launches}", flush=True)
    if (not bool(m_fb["dense_ok"]) or len(same) != len(state0)
            or any(fb_launches[k] != v for k, v in per_step.items())):
        raise AssertionError("the fallback step did not update the dense "
                             "model as a per-edge step does")


def train_phases(dev: torch.device, res: Results
                 ) -> tuple[dict[str, int], tuple, dict[str, int]]:
    """Phases 6-10 (see the module docstring). Returns the launch counts
    of the 20-step run, one recorded conv call's (map, window starts,
    features) for :func:`max_index_replay`, and the launch counts of
    ``cli.profile_step``'s run."""
    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import classification_step_factory

    cfg = modelnet_config(fast=True, dense=True)
    model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(1))
    model = model.to(dev)
    rng = np.random.default_rng(1)
    batch = {
        "points": torch.from_numpy(surface_clouds(rng, B, N)).to(dev),
        "label": torch.from_numpy(
            rng.integers(0, cfg.num_cls, (B,)).astype(np.int64)).to(dev),
    }
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def factory(use_kernels, net=model):
        opt, sch = make_optimizer(
            net.parameters(), "adam",
            exponential_decay_lr(0.001, batch_size=B))
        return classification_step_factory(
            net, opt, sch, weight_decay=cfg.weight_decay,
            use_kernels=use_kernels)

    def dropout_gen():
        return torch.Generator(device=dev).manual_seed(2)

    def grads_of(step):
        """Loss metrics and gradients of one step from ``state0``."""
        step.model.load_state_dict(state0)
        metrics = step.loss_and_grads(batch, dropout_gen())
        if not bool(metrics["dense_ok"]):
            raise AssertionError("dense_ok False on the train batch")
        return metrics, {k: p.grad.clone()
                         for k, p in step.model.named_parameters()}

    plain_step, kernel_step = factory(False), factory(None)
    print(f"train step: plain windows {list(cfg.windows)}, B={B} N={N}, "
          f"Adam on the staircase schedule, weight decay "
          f"{cfg.weight_decay}", flush=True)

    # 6. per-kernel parity of the train step's calls
    print("per-kernel parity, train step (forward + backward, times: "
          "median of CUDA events)", flush=True)
    model.load_state_dict(state0)
    with _build.record_calls() as calls:
        plain_step.loss_and_grads(batch, dropout_gen())
    replay(calls, res, PER_STEP, plain_reps=PLAIN_REPS)
    res.summary("ModelNet train step")
    # kept in host memory until it is replayed, so that it adds nothing
    # to the later phases' peak device memory
    conv_map = next(tuple(a.cpu() for a in args[:3])
                    for name, args, _ in calls if name == "dense_conv")
    del calls

    # 7. the whole step, kernels against plain versions: in f32 (the same
    # weights, graphs and dropout masks) to a tight tolerance, and in bf16
    # anchored to the f32 gradients
    model32 = SPH3DModelNet(dataclasses.replace(
        cfg, compute_dtype="float32")).to(dev)
    compare_steps(grads_of, factory, model32, "train step")
    del model32

    # 8. determinism: bitwise-equal gradients of two kernel steps
    check_bitwise_steps(grads_of, kernel_step, "")

    # 9. steps on the fixed batch
    model.load_state_dict(state0)
    step = factory(None)
    gen = dropout_gen()
    step.train_step(batch, gen)            # warm-up (allocator, cuBLAS)
    model.load_state_dict(state0)
    step = factory(None)
    gen = dropout_gen()
    losses, oks, times = [], [], []
    torch.cuda.synchronize()
    reset_kernel_launches()
    for _ in range(STEPS):
        t0 = time.perf_counter()
        metrics = step.train_step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
        oks.append(metrics["dense_ok"])
    launches = kernel_launches()
    loss = torch.stack(losses).cpu()
    print(f"{STEPS} train steps: loss {loss[0].item():.4f} -> "
          f"{loss[-1].item():.4f} ({[round(v, 3) for v in loss.tolist()]})",
          flush=True)
    print(f"launches over {STEPS} steps: {launches}", flush=True)
    for name, per in PER_STEP.items():
        if launches[name] != per * STEPS:
            raise AssertionError(
                f"{name}: {launches[name]} launches, want {per} per step")
    if not bool(torch.stack(oks).all()):
        raise AssertionError("dense_ok False on a train step")
    if not torch.isfinite(loss).all() or not loss[-1] < loss[0]:
        raise AssertionError(f"loss did not fall: {loss.tolist()}")
    step_ms = float(np.median(times)) * 1e3
    model.load_state_dict(state0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factory(False).train_step(batch, dropout_gen())
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"train step B={B} N={N}, plain windows: {step_ms:.2f} ms "
          f"median of {STEPS} (host clock, synchronised; "
          f"{B * N / step_ms * 1e3:.0f} points/s) with kernels, "
          f"{plain_ms:.2f} ms for one step with the plain versions",
          flush=True)

    # 10. profile of the train step: cli.profile_step on the same config
    # (its own seeded model and batch, the JAX script's): a warm step,
    # three timed, two traced alone and two with the layer spans, the
    # second of each counted
    from sph3d_gcn_torch.cli import profile_step

    del step, plain_step, kernel_step
    reset_kernel_launches()
    prof = profile_step.main(["--fast", "--dense", "--batch_size", str(B),
                              "--top", "12"])
    prof_launches = kernel_launches()
    steps = prof["steps_run"]
    rows = {r["kernel"]: r for r in prof["kernels"]}
    for name, per in PER_STEP.items():
        if (prof_launches[name] != steps * per
                or rows[name]["launches"] != per):
            raise AssertionError(
                f"profile_step: {name} launched {prof_launches[name]} times "
                f"in {steps} steps ({rows[name]['launches']} traced), want "
                f"{per} a step")
    if not prof["dense_ok"] or prof["busy_ms"] is None:
        raise AssertionError("profile_step: dense_ok False or no device "
                             "time")
    return launches, conv_map, prof_launches


def s3dis_phases(dev: torch.device, res: Results) -> dict[str, int]:
    """Phases 11-13 (see the module docstring). Returns the launch counts
    of the serving run."""
    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import s3dis_config
    from sph3d_gcn_torch.data.synthetic import scene_blocks
    from sph3d_gcn_torch.models import SPH3DSceneSeg
    from sph3d_gcn_torch.ops import query as Q
    from sph3d_gcn_torch.train.eval import (
        checked_forward,
        coverage_eval_blocks,
    )

    cfg = s3dis_config(fast=True, dense=True)
    gen = torch.Generator().manual_seed(3)
    model = SPH3DSceneSeg(cfg, generator=gen)
    randomize_bn(model, gen)
    model = model.to(dev).eval()
    levels = range(len(cfg.radius))
    print(f"S3DIS: B={S3_B} N={S3_N}, windows "
          f"{[cfg.enc_window(lv) for lv in levels]} / pool "
          f"{[cfg.pool_window(lv) for lv in levels]} / decoder "
          f"{[cfg.dec_window(lv) for lv in levels]} + margin "
          f"{cfg.dec_margin}, growth {cfg.growth_steps}", flush=True)
    x = torch.from_numpy(scene_blocks(np.random.default_rng(20), S3_B, S3_N)
                         ).to(dev)

    # 11. per-kernel parity of one forward's calls
    print("per-kernel parity, S3DIS forward (times: median of CUDA events)",
          flush=True)
    with _build.record_calls() as calls, torch.inference_mode():
        model(x, use_kernels=False)
    ok_rec = bool(model.dense_ok)
    n_unpool = sum(name == "mean_interpolate" for name, _, _ in calls)
    replay(calls, res, PER_SEG_FORWARD, plain_reps=S3_PLAIN_REPS)
    res.summary("S3DIS forward")
    # how much the decoders' inter graphs grow
    with torch.no_grad():
        for name, args, kw in calls:
            if name == "growth_query":
                _, steps, _, _ = Q.growth_query_kernel(*args, **kw)
                hist = torch.bincount(steps.reshape(-1).long()).tolist()
                print(f"  growth M_pad={args[1].shape[1]}: query rows per "
                      f"growth step 0, 1, ...: {hist}", flush=True)
    del calls
    if not ok_rec or n_unpool != 4:
        raise AssertionError(
            f"recorded S3DIS forward: dense_ok {ok_rec}, {n_unpool} unpools")

    # 12. serving: coverage-vote 32 blocks through the kernels
    pts = scene_blocks(np.random.default_rng(21), S3_BLOCKS, S3_P)
    blocks = [(p, ((p[:, :2] >= 0.3) & (p[:, :2] <= 1.2)).all(-1).astype(
        np.int32)) for p in pts]
    checked = checked_forward(model, dev)
    n_fwd = 0

    def forward(chunk, ids):
        nonlocal n_fwd
        n_fwd += 1
        return checked(chunk, ids)

    torch.cuda.synchronize()
    reset_kernel_launches()
    t0 = time.perf_counter()
    sums = coverage_eval_blocks(forward, blocks, S3_N, S3_B,
                                rng=np.random.default_rng(22))
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    inner_pts = sum(int(inner.sum()) for _, inner in blocks)
    for (p, inner), logit in zip(blocks, sums):
        if logit.shape != (S3_P, cfg.num_cls) or not np.isfinite(logit).all():
            raise AssertionError(f"bad block logits {logit.shape}")
        if not (np.abs(logit[inner == 1]).sum(-1) > 0).all():
            raise AssertionError("an inner point got no logits")
    print(f"served {S3_BLOCKS} blocks of {S3_P} points ({inner_pts} inner, "
          f"all covered) in {n_fwd} forwards, dense_ok on every forward; "
          f"{wall:.3f} s host clock: {S3_BLOCKS / wall:.2f} blocks/s",
          flush=True)
    print(f"launches over {n_fwd} forwards: {launches}", flush=True)
    for name, per in PER_SEG_FORWARD.items():
        if launches[name] != per * n_fwd:
            raise AssertionError(
                f"{name}: {launches[name]} launches, want {per} per forward")

    with torch.inference_mode():
        got = model(x)
        ok_k = bool(model.dense_ok)
        ref = model(x, use_kernels=False)
        ok_p = bool(model.dense_ok)
        fwd_ms = median_ms(lambda: model(x))
    if not (ok_k and ok_p):
        raise AssertionError("dense_ok False on the comparison forward")
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"S3DIS kernel vs plain logits: max_abs_err {diff:.4g}, argmax "
          f"agreement {agree:.4f} (|logits| <= {scale:.3g}, tolerance "
          f"{LOGIT_TOL:g} of that)", flush=True)
    if agree < 0.95:
        raise AssertionError(f"argmax agreement {agree} < 0.95")
    torch.testing.assert_close(got, ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * scale)
    print(f"S3DIS forward B={S3_B} N={S3_N}: {fwd_ms:.2f} ms "
          f"({S3_B * S3_N / fwd_ms * 1e3:.0f} points/s) with kernels",
          flush=True)

    # 13. profile of the S3DIS forward
    profile_forward(model, x, "S3DIS")
    return launches


def s3dis_train_phases(dev: torch.device, res: Results
                       ) -> tuple[dict[str, int], list]:
    """Phases 20-24 (see the module docstring). Returns the launch counts
    of the step run and the recorded pool calls' operands (for
    :func:`max_index_replay`)."""
    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import s3dis_config
    from sph3d_gcn_torch.data.synthetic import scene_blocks
    from sph3d_gcn_torch.models import SPH3DSceneSeg
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import segmentation_step_factory

    cfg = s3dis_config(fast=True, dense=True)
    model = SPH3DSceneSeg(cfg, generator=torch.Generator().manual_seed(6))
    model = model.to(dev)
    # bench.py's S3DIS batches: scene blocks, random labels and inner labels
    rng = np.random.default_rng(40)
    batch = {
        "points": torch.from_numpy(scene_blocks(rng, S3_B, S3_N)).to(dev),
        "label": torch.from_numpy(rng.integers(
            0, cfg.num_cls, (S3_B, S3_N)).astype(np.int64)).to(dev),
        "inner_label": torch.from_numpy(rng.integers(
            0, 2, (S3_B, S3_N)).astype(np.int32)).to(dev),
    }
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def factory(use_kernels, net=model):
        opt, sch = make_optimizer(
            net.parameters(), "adam",
            exponential_decay_lr(0.001, batch_size=S3_B))
        return segmentation_step_factory(net, opt, sch, inner_masked=True,
                                         use_kernels=use_kernels)

    def grads_of(step):
        step.model.load_state_dict(state0)
        metrics = step.loss_and_grads(batch)
        if not bool(metrics["dense_ok"]):
            raise AssertionError("dense_ok False on the S3DIS train batch")
        return metrics, {k: p.grad.clone()
                         for k, p in step.model.named_parameters()}

    print(f"S3DIS train step: B={S3_B} N={S3_N}, inner-masked loss summed "
          f"over the batch, Adam on the staircase schedule", flush=True)

    # 20. per-kernel parity of the step's calls
    print("per-kernel parity, S3DIS train step (forward + backward, times: "
          "median of CUDA events)", flush=True)
    model.load_state_dict(state0)
    with _build.record_calls() as calls:
        factory(False).loss_and_grads(batch)
    n_unpool = [sum(name == u for name, _, _ in calls)
                for u in ("mean_interpolate", "mean_interpolate_bwd")]
    if n_unpool != [4, 4]:
        raise AssertionError(f"recorded unpools and backwards {n_unpool}")
    replay(calls, res, PER_SEG_STEP, plain_reps=S3_PLAIN_REPS)
    res.summary("S3DIS train step")
    k9_line(res, "the S3DIS step's masked-mean unpool backwards",
            ("span", 1.5))
    pool_calls = [tuple(a.cpu() for a in args) for name, args, _ in calls
                  if name == "rank_pool"]     # host memory, as conv_map
    del calls

    # 21. the whole step, kernels against plain versions (f32 and bf16)
    model32 = SPH3DSceneSeg(dataclasses.replace(
        cfg, compute_dtype="float32")).to(dev)
    compare_steps(grads_of, factory, model32, "S3DIS train step")
    del model32

    # 22. determinism
    check_bitwise_steps(grads_of, factory(None), " (S3DIS step)")

    # 23. steps on the fixed batch
    model.load_state_dict(state0)
    factory(None).train_step(batch)        # warm-up (allocator, cuBLAS)
    model.load_state_dict(state0)
    step = factory(None)
    losses, oks, times = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    for _ in range(S3_STEPS):
        t0 = time.perf_counter()
        metrics = step.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
        oks.append(metrics["dense_ok"])
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = torch.stack(losses).cpu()
    print(f"{S3_STEPS} S3DIS train steps: loss {loss[0].item():.4f} -> "
          f"{loss[-1].item():.4f} ({[round(v, 3) for v in loss.tolist()]})",
          flush=True)
    print(f"launches over {S3_STEPS} steps: {launches}", flush=True)
    for name, per in PER_SEG_STEP.items():
        if launches[name] != per * S3_STEPS:
            raise AssertionError(
                f"{name}: {launches[name]} launches, want {per} per step")
    if not bool(torch.stack(oks).all()):
        raise AssertionError("dense_ok False on an S3DIS train step")
    if not torch.isfinite(loss).all() or not loss[-1] < loss[0]:
        raise AssertionError(f"loss did not fall: {loss.tolist()}")
    step_ms = float(np.median(times)) * 1e3
    model.load_state_dict(state0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factory(False).train_step(batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"S3DIS train step B={S3_B} N={S3_N}: {step_ms:.2f} ms median of "
          f"{S3_STEPS} (host clock, synchronised; "
          f"{S3_B * S3_N / step_ms * 1e3:.0f} points/s) with kernels, "
          f"{plain_ms:.2f} ms for one step with the plain versions; peak "
          f"device memory {peak:.2f} GiB", flush=True)

    # 24. profile of the S3DIS train step
    profile_steps(lambda: step.train_step(batch), "S3DIS train step")
    return launches, pool_calls


def max_index_replay(dev: torch.device, pool_calls: list, conv_map: tuple,
                     res: Results) -> None:
    """Phase 25: ``dense_max_pool3d(with_index=True)`` (the op-level
    ``max_index``; the JAX package's whole-window masked max #10 and its
    backward #11) on the 4 pool operands of the S3DIS step (rank maps)
    and one ModelNet conv map (a bin map: every nonzero entry selected),
    through the kernels (K4 with its first attaining column, K6 for the
    gradient) and through the plain versions: values, ``max_index`` and
    the gradient of an integer cotangent (exact sums) must be equal.
    Times: the whole entry with kernels and with plain versions, and the
    gradient's K6 beside its plain version and ``scatter_add_``."""
    from sph3d_gcn_torch.ops import dense as D

    print("max_index replay: dense_max_pool3d(with_index=True), kernels vs "
          "plain versions", flush=True)
    pool_calls = [tuple(a.to(dev) for a in args) for args in pool_calls]
    conv_map = tuple(a.to(dev) for a in conv_map)
    cases = []
    for packed, s_blk, counts, x in pool_calls:
        cases.append(("ranks", D.DenseNeighborhood(
            packed=packed, s_blk=s_blk, count=counts, ok=None,
            num_query=counts.shape[1], num_db=x.shape[1], k_max=127), x))
    packed, s_blk, x = conv_map
    cases.append(("bins", D.DenseNeighborhood(
        packed=packed, s_blk=s_blk,
        count=torch.zeros(s_blk.shape[0], s_blk.shape[1] * 128,
                          dtype=torch.int32, device=x.device),
        ok=None, num_query=s_blk.shape[1] * 128, num_db=x.shape[1]), x))
    gen = torch.Generator(device=x.device).manual_seed(7)
    for kind, g, x in cases:
        x = x.detach()
        what = f"{kind} C={x.shape[2]} W={g.window}"
        with torch.no_grad():
            got = D.dense_max_pool3d(x, g, with_index=True)
            ref = D.dense_max_pool3d(x, g, with_index=True,
                                     use_kernels=False)
            ms = median_ms(lambda: D.dense_max_pool3d(x, g, with_index=True))
            plain_ms = median_ms(lambda: D.dense_max_pool3d(
                x, g, with_index=True, use_kernels=False), 1)
        counts = D.pool_counts(g)
        entry_work = work("rank_pool", (g.packed, g.s_blk, counts, x),
                          {"with_index": True})
        res.add("rank_pool", what + " +index", got, ref, ms, plain_ms, exact,
                entry_work)
        res.add_device("rank_pool", what + " +index", functools.partial(
            D.dense_max_pool3d, x, g, with_index=True), None, entry_work)
        cot = torch.randint(-4, 5, got[0].shape, device=x.device,
                            generator=gen).to(x.dtype)
        grads = []
        for use in (None, False):
            xg = x.clone().requires_grad_()
            D.dense_max_pool3d(xg, g, with_index=True,
                               use_kernels=use)[0].backward(cot)
            grads.append(xg.grad)
        exact((grads[0],), (grads[1],))
        _, arg = D.rank_pool_kernel(g.packed, g.s_blk, counts, x,
                                    with_arg=True)
        # K6 takes the (B, M_pad, C) gradient; the rows past M add nothing
        cot_p = torch.nn.functional.pad(
            cot, (0, 0, 0, arg.shape[1] - cot.shape[1]))
        args = (g.s_blk, arg, cot_p, x.shape[1], g.window)
        lib = library_call("rank_pool_bwd", args, {})
        res.add("rank_pool_bwd", what, D.rank_pool_bwd_kernel(*args),
                grads[1], median_ms(lambda: D.rank_pool_bwd_kernel(*args)),
                median_ms(lambda: D.rank_pool_bwd_plain(*args), 1), exact,
                work("rank_pool_bwd", args, {}), median_ms(lib))
        res.add_device("rank_pool_bwd", what,
                       functools.partial(D.rank_pool_bwd_kernel, *args), lib,
                       work("rank_pool_bwd", args, {}))
    res.summary("max_index replay (rank_pool: the whole entry)")


def pool_bwd_operands(rng, batch: int, num_in: int, n_t: int, window: int,
                      c: int, crowded: bool):
    """K6's adversarial operands, as ``tests/test_torch_pool_bwd.py`` makes
    them: (s_blk, arg, integer-valued f32 dout) as numpy arrays. Windows
    start anywhere in the cloud, 10% of the rows and 5% of the entries
    are empty (-1); ``crowded``: every row of tiles 1..n_t-1 shares tile
    1's window and routes to its last cloud row."""
    n_blk = -(-num_in // 128)
    s_blk = rng.integers(0, n_blk, (batch, n_t)).astype(np.int32)
    reach = np.minimum(window, num_in - s_blk * 128)[..., None, None]
    arg = (rng.random((batch, n_t, 128, c)) * reach).astype(np.int32)
    if crowded:
        s_blk[:, 1:] = s_blk[:, 1:2]
        arg[:, 1:] = reach[:, 1:2] - 1
    empty = rng.random((batch, n_t, 128, 1)) < 0.1
    arg[empty | (rng.random(arg.shape) < 0.05)] = -1
    dout = rng.integers(-4, 5, arg.shape).astype(np.float32)
    shape = (batch, n_t * 128, c)
    return s_blk, arg.reshape(shape), dout.reshape(shape)


def pool_bwd_stress(dev: torch.device) -> None:
    """Phase 25b: K6 on adversarial operands at the S3DIS step's level-0
    size (B=16, 16 tiles, C=128), with a cloud of 8155 rows (no multiple
    of 128) and 2304-row windows (18 blocks): windows scattered over the
    cloud, and a crowded case in which one row per cloud and channel takes
    every row of 15 tiles. K6 must equal its plain version and a second K6
    run bitwise, in f32 and bf16; times and device times beside
    ``scatter_add_``, and the bound."""
    from sph3d_gcn_torch.ops import dense as D

    print("pool backward (K6) on adversarial operands, kernel vs plain "
          "version bitwise:", flush=True)
    rng = np.random.default_rng(11)
    num_in, window = S3_N - 37, 2304
    res = Results()
    for crowded in (False, True):
        ops = pool_bwd_operands(rng, S3_B, num_in, 16, window, 128, crowded)
        for dtype in (torch.float32, torch.bfloat16):
            s_blk, arg, dout = (torch.from_numpy(a).to(dev) for a in ops)
            # int64, as a graph holds s_blk (no conversion in the timing)
            args = (s_blk.long(), arg, dout.to(dtype), num_in, window)
            what = (f"{'crowded' if crowded else 'scattered'} "
                    f"{str(dtype)[6:]} N={num_in} W={window}")
            dx = D.rank_pool_bwd_kernel(*args)
            exact((dx,), (D.rank_pool_bwd_kernel(*args),))
            lib = library_call("rank_pool_bwd", args, {})
            res.add("rank_pool_bwd", what, dx, D.rank_pool_bwd_plain(*args),
                    median_ms(functools.partial(D.rank_pool_bwd_kernel,
                                                *args)),
                    median_ms(functools.partial(D.rank_pool_bwd_plain,
                                                *args), 1),
                    exact, work("rank_pool_bwd", args, {}), median_ms(lib))
            res.add_device("rank_pool_bwd", what,
                           functools.partial(D.rank_pool_bwd_kernel, *args),
                           lib, work("rank_pool_bwd", args, {}))
    res.time_device()


def pool_fwd_operands(rng, batch: int, num_in: int, n_t: int, window: int,
                      c: int):
    """K4's adversarial operands, as ``tests/test_torch_pool_fwd.py`` makes
    them: (packed, s_blk, counts (B, M), x f32) as numpy arrays. Rank
    maps on random columns; the first tile's window at the cloud's start,
    the last one's past its end; rows in turn with no entry, every column
    selected, a count beyond the row's entries, one below them and 127;
    integer features with -0 beside +0, every 7th row normal, every 11th
    from the 5th -inf."""
    m_pad = n_t * 128
    n_blk = -(-num_in // 128)
    s_blk = rng.integers(0, n_blk, (batch, n_t))
    s_blk[:, 0], s_blk[:, -1] = 0, n_blk - 1
    rows = batch * m_pad
    sel = rng.random((rows, window)) < rng.uniform(0.01, 0.08, (rows, 1))
    ranks = np.cumsum(sel, axis=-1) * sel
    packed = np.where(ranks <= 64, ranks, 0).astype(np.int8)
    case = np.arange(rows) % 6
    packed[case == 0] = 0
    packed[case == 1] = np.arange(window) % 127 + 1
    cnt = (packed > 0).sum(-1)
    cnt[case == 1] = 127
    cnt[case == 2] += rng.integers(1, 20, (case == 2).sum())
    cnt[case == 3] = np.maximum(cnt[case == 3] - 3, 0)
    cnt[case == 4] = 127
    counts = cnt.reshape(batch, m_pad)[:, :m_pad - 37].astype(np.int32)
    x = rng.integers(-3, 4, (batch, num_in, c)).astype(np.float32)
    x[(x == 0) & (rng.random(x.shape) < 0.5)] = -0.0
    x[:, ::7] = rng.standard_normal((batch, len(x[0, ::7]), c))
    x[:, 5::11] = -np.inf
    return packed.reshape(batch, n_t, 128, window), s_blk, counts, x


def offset_view(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``x`` whose data starts ``offset`` elements into its
    storage (narrower vectors for the kernels' loads)."""
    flat = torch.cat([x.reshape(-1)[:offset], x.reshape(-1)])
    return flat[offset:].view(x.shape)


def pool_fwd_stress(dev: torch.device) -> None:
    """Phase 25c: K4 on adversarial operands (:func:`pool_fwd_operands`),
    every mode (values only, arg, max_index, both) and every kernel
    instance (each vector width of f32 and bf16, reached through the
    features' address, values-only and tracking), with counts and as a
    bin map (no counts), bitwise equal to its plain version and to a
    second launch; at the S3DIS step's level-0 size (B=16, 16 tiles,
    W=2048, C=128) timed, with device times and the bound."""
    from sph3d_gcn_torch.ops import dense as D

    print("max pool (K4) on adversarial operands, kernel vs plain version "
          "bitwise:", flush=True)
    rng = np.random.default_rng(12)
    modes = ({}, {"with_arg": True}, {"with_index": True},
             {"with_arg": True, "with_index": True})
    reached = set()
    for c in (1, 3, 35, 64, 131, 512):
        ops = pool_fwd_operands(rng, 2, 940, 4, 640, c)
        for dtype in (torch.float32, torch.bfloat16):
            packed, s_blk, counts, x = (torch.from_numpy(a).to(dev)
                                        for a in ops)
            for offset in (0, 1, 2, 4):
                xs = offset_view(x.to(dtype), offset)
                vec = D._pool_vector_bytes(c * xs.element_size(), xs)
                for cnt in (counts, None):
                    for kw in modes:
                        args = (packed, s_blk, cnt, xs)
                        got = D.rank_pool_kernel(*args, **kw)
                        got = got if isinstance(got, tuple) else (got,)
                        ref = D.rank_pool_plain(*args, **kw)
                        exact(got, ref if isinstance(ref, tuple) else (ref,))
                        again = D.rank_pool_kernel(*args, **kw)
                        exact(got, again if isinstance(again, tuple)
                              else (again,))
                        reached.add((str(dtype)[6:], vec, bool(kw)))
    want = {("float32", v, t) for v in (16, 8, 4) for t in (False, True)}
    want |= {("bfloat16", v, t) for v in (16, 8, 4, 2)
             for t in (False, True)}
    if reached != want:
        raise AssertionError(f"K4 instances reached {sorted(reached)}")
    print(f"  {len(reached)} kernel instances (dtype, vector bytes, "
          f"tracking), C 1-512, 4 modes, with and without counts: bitwise",
          flush=True)
    res = Results()
    ops = pool_fwd_operands(rng, S3_B, S3_N - 37, 16, 2048, 128)
    packed, s_blk, counts, x = (torch.from_numpy(a).to(dev) for a in ops)
    for dtype in (torch.float32, torch.bfloat16):
        for kw in ({}, {"with_arg": True}):
            args = (packed, s_blk, counts, x.to(dtype))
            what = describe("rank_pool", args, kw) + " stress"
            res.add("rank_pool", what, D.rank_pool_kernel(*args, **kw),
                    D.rank_pool_plain(*args, **kw),
                    median_ms(functools.partial(D.rank_pool_kernel, *args,
                                                **kw)),
                    median_ms(functools.partial(D.rank_pool_plain, *args,
                                                **kw), 1),
                    exact, work("rank_pool", args, kw))
            res.add_device("rank_pool", what, functools.partial(
                D.rank_pool_kernel, *args, **kw), None,
                work("rank_pool", args, kw))
    res.time_device()


def gather_operands(rng, batch: int, n: int, m: int, k: int, c: int):
    """K8's operands, as ``tests/test_torch_gather_fwd.py`` makes them:
    (feats f32, idx, count) as numpy arrays; indices near a sorted base,
    every 17th row anywhere (some out of range), counts 0 to K."""
    base = np.sort(rng.integers(0, n, (batch, m)), axis=-1)
    idx = base[..., None] + rng.integers(-40, 40, (batch, m, k))
    idx[:, ::17] = rng.integers(-5, n + 5, idx[:, ::17].shape)
    count = rng.integers(0, k + 1, (batch, m))
    count[:, 0], count[:, 1] = 0, k
    feats = rng.standard_normal((batch, n, c)).astype(np.float32)
    return feats, idx.astype(np.int64), count.astype(np.int64)


def gather_stress(dev: torch.device) -> None:
    """Phase 25d: K8 bitwise equal to its plain version at C from 1 to
    512 (rows of 2 to 2048 bytes, most no multiple of 16), f32 and bf16,
    features at 0, 1 and 3 elements past their storage's start, K of 1,
    5 and 64, M no multiple of 128, counts 0 to K, out-of-range indices;
    then at the per-edge forward's level-0 size (16 clouds of 10000
    points, 2500 queries, K = 64, bf16) at its odd widths 35, 67 and 131,
    timed with device times and the bound."""
    from sph3d_gcn_torch.ops import windowed as W

    print("edge gather (K8) on adversarial operands, kernel vs plain "
          "version bitwise:", flush=True)
    rng = np.random.default_rng(13)
    n_ops = 0
    for c in (1, 3, 35, 64, 67, 128, 131, 512):
        for k, m in ((1, 200), (5, 130), (64, 300)):
            feats, idx, count = gather_operands(rng, 2, 700, m, k, c)
            i = torch.from_numpy(idx).to(dev)
            cnt = torch.from_numpy(count).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(feats).to(dtype).to(dev)
                ref = W.window_gather_plain(x, i, cnt)
                for offset in (0, 1, 3):
                    xs = offset_view(x, offset)
                    got = W.window_gather_kernel(xs, i, cnt)
                    exact((got,), (ref,))
                    exact((got,), (W.window_gather_kernel(xs, i, cnt),))
                    n_ops += 1
    print(f"  {n_ops} operands: bitwise", flush=True)
    res = Results()
    for c in (35, 67, 131):
        feats, idx, count = gather_operands(rng, B, N, 2500, 64, c)
        # in range, as the engine's are (torch.gather, the library call,
        # takes no other)
        args = (torch.from_numpy(feats).to(torch.bfloat16).to(dev),
                torch.from_numpy(np.clip(idx, 0, N - 1)).to(dev),
                torch.from_numpy(count).to(dev))
        what = describe("window_gather", args, {}) + " stress"
        lib = library_call("window_gather", args, {})
        res.add("window_gather", what, W.window_gather_kernel(*args),
                W.window_gather_plain(*args),
                median_ms(functools.partial(W.window_gather_kernel, *args)),
                median_ms(functools.partial(W.window_gather_plain, *args),
                          1),
                exact, work("window_gather", args, {}), median_ms(lib))
        res.add_device("window_gather", what, functools.partial(
            W.window_gather_kernel, *args), lib,
            work("window_gather", args, {}))
    res.time_device()


def gather_bwd_stress(dev: torch.device) -> None:
    """Phase 25d': K9 bitwise equal to its plain twins and to itself. Form
    (a) at C from 1 to 512, f32 and bf16 edge gradients at 0, 1 and 3
    elements past their storage's start, over lists with empty rows,
    one-entry rows and a row of 1000 edges; form (b) at the same C on the
    int8 map and f32 and bf16 weights, ``dout`` at the same offsets, a
    window column selected in all 128 rows, a query row selecting its
    whole window, window rows past the cloud and cloud rows in no
    window."""
    from sph3d_gcn_torch.ops import windowed as W

    print("segment sum (K9) on adversarial operands, both forms, kernel vs "
          "plain version bitwise:", flush=True)
    gen = torch.Generator(device=dev).manual_seed(14)
    n_ops = 0
    # form (a): 2 clouds of 700 rows, 2 x 512 x 8 edges
    rows, edges = 2 * 700, 2 * 512 * 8
    key = torch.randint(0, rows, (edges,), generator=gen, device=dev)
    key[torch.rand(edges, generator=gen, device=dev) < 0.2] = rows
    key[(key >= 100) & (key < 120)] = rows       # rows 100-119 empty
    key[:1000] = 7                               # a list of 1000 edges
    key[1000:1010] = torch.arange(110, 120, device=dev)   # one entry each
    order, starts = W.group_by_row(key.to(torch.int32), rows)
    for c in (1, 3, 35, 64, 67, 131, 259, 512):
        dg = torch.randn((2, 512, 8, c), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = dg.to(dtype)
            ref = W.window_gather_bwd_plain(x, order, starts, 700)
            for offset in (0, 1, 3):
                xs = offset_view(x, offset)
                got = W.window_gather_bwd_kernel(xs, order, starts, 700)
                exact((got,), (ref,))
                exact((got,), (W.window_gather_bwd_kernel(
                    xs, order, starts, 700),))
                n_ops += 1
    # form (b): 2 clouds of 700 rows, 4 query tiles, windows of 512
    n_t, window, n = 4, 512, 700
    sel = torch.rand((2, n_t, 128, window), generator=gen, device=dev) < 0.03
    sel[0, 1, :, 5] = True
    sel[1, 2, 9, :] = True
    packed = torch.where(sel, torch.randint(
        1, 30, sel.shape, generator=gen, device=dev), 0).to(torch.int8)
    s_blk = torch.tensor([[0, 0, 1, 2], [0, 1, 1, 1]], device=dev)
    weights = torch.where(sel, torch.rand(sel.shape, generator=gen,
                                          device=dev), 0.0)
    for c in (1, 3, 35, 64, 67, 131, 259, 512):
        dout = torch.randn((2, n_t * 128, c), generator=gen, device=dev)
        for lhs in (packed, weights, weights.bfloat16()):
            ref = W.window_sum_bwd_plain(lhs, s_blk, dout, n)
            for offset in (0, 1, 3):
                ds = offset_view(dout, offset)
                got = W.window_sum_bwd_kernel(lhs, s_blk, ds, n)
                exact((got,), (ref,))
                exact((got,), (W.window_sum_bwd_kernel(
                    lhs, s_blk, ds, n),))
                n_ops += 1
    print(f"  {n_ops} operands: bitwise", flush=True)


def crowded_map(dev: torch.device, gen: torch.Generator) -> tuple:
    """A crowded conv map at the S3DIS step's level-0 shapes (B=16,
    N=8192, 64 query tiles, W=1664, the 33 bins of kernel (8, 2, 2)): 64
    selected entries in every query row's window, as real scene blocks
    fill up to ``nn_uplimit`` = 64 (the synthetic scene maps of the step
    hold about 6). The windows are centred on their tiles, as a sorted
    cloud's are. Returns (packed, s_blk, inv, f_bins)."""
    n_t = n_blk = S3_N // 128
    window, f_bins = 1664, 33
    nbw = window // 128
    s_blk = (torch.arange(n_t, device=dev) - nbw // 2).clamp(
        0, n_blk - nbw).expand(S3_B, n_t).contiguous()
    scores = torch.rand((S3_B, n_t, 128, window), generator=gen, device=dev)
    top = scores.topk(64, dim=-1).indices
    del scores
    bins = torch.randint(1, f_bins + 1, top.shape, generator=gen,
                         device=dev).to(torch.int8)
    packed = torch.zeros((S3_B, n_t, 128, window), dtype=torch.int8,
                         device=dev).scatter_(-1, top, bins)
    inv = torch.full((S3_B, n_t * 128), 1 / 64, device=dev)
    return packed, s_blk, inv, f_bins


def conv_fwd_stress(dev: torch.device) -> None:
    """Phase 25e: K3 on the crowded operand (:func:`crowded_map`), C_in
    64 and 128, r=2, bf16, and C_in 35 (ModelNet's first conv), against
    its plain version under ``close`` and against a second K3 run
    bitwise; times (span and device) and the bound."""
    from sph3d_gcn_torch.ops import dense as D

    print("conv forward (K3) on a crowded operand (64 entries a row), "
          "S3DIS level-0 shapes:", flush=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    packed, s_blk, inv, f_bins = crowded_map(dev, gen)
    res = Results()
    for c in (35, 64, 128):
        x = torch.randn((S3_B, S3_N, c), generator=gen,
                        device=dev).bfloat16()
        filt_b = torch.randn((S3_B, f_bins, c, 2), generator=gen, device=dev)
        args = (packed, s_blk, x, filt_b, inv)
        what = f"crowded bf16 C={c} r=2 W={packed.shape[-1]}"
        got = D.dense_conv_kernel(*args)
        exact(got, D.dense_conv_kernel(*args))
        res.add("dense_conv", what, got, D.dense_conv_plain(*args),
                median_ms(functools.partial(D.dense_conv_kernel, *args)),
                median_ms(functools.partial(D.dense_conv_plain, *args), 1),
                close, work("dense_conv", args, {}))
        res.add_device("dense_conv", what,
                       functools.partial(D.dense_conv_kernel, *args),
                       None, work("dense_conv", args, {}))
    res.time_device()


def conv_bwd_stress(dev: torch.device) -> None:
    """Phase 25f: K5 on the crowded operand (:func:`crowded_map`), C_in 64
    and 128, r=2, bf16, against its plain version under
    ``conv_grads_close`` and against a second K5 run bitwise; times (span
    and device) and the bound."""
    from sph3d_gcn_torch.ops import dense as D

    print("conv backward (K5) on a crowded operand (64 entries a row), "
          "S3DIS level-0 shapes:", flush=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    packed, s_blk, inv, f_bins = crowded_map(dev, gen)
    window = packed.shape[-1]
    res = Results()
    for c in (64, 128):
        x = torch.randn((S3_B, S3_N, c), generator=gen,
                        device=dev).bfloat16()
        filt_b = torch.randn((S3_B, f_bins, c, 2), generator=gen, device=dev)
        dout = torch.randn((S3_B, packed.shape[1] * 128, 2 * c),
                           generator=gen,
                           device=dev).bfloat16()
        args = (packed, s_blk, x, filt_b, inv, dout)
        what = f"crowded bf16 C={c} r=2 W={window}"
        got = D.dense_conv_bwd_kernel(*args)
        exact(got, D.dense_conv_bwd_kernel(*args))
        res.add("dense_conv_bwd", what, got, D.dense_conv_bwd_plain(*args),
                median_ms(functools.partial(D.dense_conv_bwd_kernel, *args)),
                median_ms(functools.partial(D.dense_conv_bwd_plain, *args),
                          1),
                conv_grads_close, work("dense_conv_bwd", args, {}))
        res.add_device("dense_conv_bwd", what,
                       functools.partial(D.dense_conv_bwd_kernel, *args),
                       None, work("dense_conv_bwd", args, {}))
    res.time_device()


def lattice_cloud(batch: int, side: int, rng) -> np.ndarray:
    """(batch, side**3, 3) f32: an integer lattice scaled by 1/8 (exact in
    f32), each cloud in its own order: FPS meets exact distance ties at
    every step."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32) / 8
    return np.stack([g[rng.permutation(len(g))] for _ in range(batch)])


def fps_operands(rng) -> list:
    """K1's adversarial operands: (what, npoint, database as numpy or
    None for the previous case's, plan or None for the default plan)."""
    from sph3d_gcn_torch.ops import sample as S

    rand = rng.random((2, 2000, 3), dtype=np.float32)
    dup = np.repeat(rng.random((2, 2500, 3), dtype=np.float32), 4, axis=1)
    cases = [
        ("npoint = 1", 1, rand, None),
        ("npoint = N", 2000, rand, None),
        ("all-equal points", 300, np.full((2, 3000, 3), 0.5, np.float32),
         None),
        ("lattice, exact ties", 500, lattice_cloud(2, 20, rng), None),
        ("each point 4 times", 2500, dup, None),
        ("6-channel database", 2500,
         rng.random((2, 10000, 6), dtype=np.float32), None),
        ("N at the registers' cap", 1024,
         rng.random((2, S.REGISTER_MAX_POINTS, 3), dtype=np.float32), None),
        ("N past it, in device memory", 1024,
         rng.random((2, S.REGISTER_MAX_POINTS + 1, 3), dtype=np.float32),
         None),
        ("N = 40000, in device memory", 2500,
         rng.random((2, 40000, 3), dtype=np.float32), None),
        ("B=64", 2500, rng.random((64, N, 3), dtype=np.float32), None),
        ("B=64, 8-CTA clusters in waves", 2500, None,
         S.FpsPlan(8, 128, 10)),
    ]
    # every instance of the kernel: each points-a-thread size in a block
    # of one warp, of 4 and in a cluster, on a cloud that leaves some of
    # the last slots padded
    small = lattice_cloud(3, 12, rng)[:, :1500]
    for ppt in S.PPT_SIZES:
        for plan in (S.FpsPlan(1, 32, ppt), S.FpsPlan(1, 128, ppt),
                     S.FpsPlan(4, 128, ppt)):
            n = min(plan.cluster * plan.threads * ppt - 7, 1500)
            cases.append((f"instance {plan}", min(n, 200), small[:, :n],
                          plan))
    for plan in (S.FpsPlan(2, 32, 0), S.FpsPlan(8, 1024, 0)):
        cases.append((f"instance {plan}", 200, small, plan))
    return cases


def fps_stress(dev: torch.device) -> None:
    """Phase 25g: K1 on adversarial operands (:func:`fps_operands`), each
    bitwise equal to its plain version; a 6-channel database is read in
    place, a strided one converted first."""
    from sph3d_gcn_torch.ops import sample as S

    # the counts behind fps_plan's choice of cluster size
    sizes = [S.fit_plan(N, c, S.MAX_CANDIDATES // c, S.PPT_SIZES[-1])
             for c in range(2, S.MAX_CLUSTER + 1)]
    sizes += [S.FpsPlan(c, S.STREAM_THREADS, 0)
              for c in range(2, S.MAX_CLUSTER + 1)]
    print("clusters of K1 the card runs at once (one CTA an SM): "
          + ", ".join(f"{p}: {S.max_active_clusters(p)}" for p in sizes),
          flush=True)
    print("FPS (K1) on adversarial operands, kernel vs plain version "
          "bitwise:", flush=True)
    rng = np.random.default_rng(13)
    prev = None
    for what, npoint, pts, plan in fps_operands(rng):
        t = prev if pts is None else torch.from_numpy(pts).to(dev)
        prev = t
        got = S.farthest_point_sample_kernel(npoint, t, plan)
        ref = S.farthest_point_sample_plain(npoint, t)
        used = plan or S.fps_plan(t.shape[0], t.shape[1],
                                  S.max_active_clusters)
        if not torch.equal(got, ref):
            raise AssertionError(f"K1 {what} ({used}): kernel != plain")
        step = ""
        if used.ppt == 0 and plan is None:
            ms = median_ms(lambda: S.farthest_point_sample_kernel(npoint, t),
                           3)
            step = (f", {ms:.3f} ms, {ms * 1e3 / max(npoint - 1, 1):.3f} us "
                    f"a greedy step (span)")
        print(f"  {what:34s} B={t.shape[0]} N={t.shape[1]} -> {npoint} "
              f"{used}: equal{step}", flush=True)
    strided = prev.transpose(1, 2).contiguous().transpose(1, 2)
    if not torch.equal(S.farthest_point_sample_kernel(600, strided),
                       S.farthest_point_sample_plain(600, strided)):
        raise AssertionError("K1 on a strided database: kernel != plain")
    print("  strided database (converted): equal", flush=True)


def query_stress_calls(dev: torch.device) -> list:
    """K2's and K7's adversarial operands, as (what, name, args, kw):

    - boundaries: 256 query rows on the x axis, 4 apart, each with points
      at exactly T - 1 ulp, T and T + 1 ulp in squared distance of each of
      its thresholds (range, radial bin, self loop; for K7 the nearest
      point at one growth threshold, row m at threshold m % (G+1), 24
      more points beyond it: rows grown by every step, alive only at the
      last radius, never alive), two clouds in random point order;
    - crowded, empty and sentinel tiles: uniform clouds at radius 0.3
      and K = 32 (K reached inside a step; for K7 at once, and at radius
      0.05 rows that grow), half the queries moved out of range, a cloud
      whose database is all sentinels, a query tile of sentinels only,
      drawn window starts and u_end from -1 to W/128 + 2;
    - the largest served window, 2688 rows (ModelNet's hard pool window
      at level 0), B=16 clouds of 10000 points.

    Every K2 operand in the three modes (ranks, bins, grouped bins), each
    with and without the distance map."""
    from sph3d_gcn_torch.data.synthetic import (
        boundary_clouds,
        growth_boundary_clouds,
        query_operands,
        surface_clouds,
    )
    from sph3d_gcn_torch.ops import dense as D
    from sph3d_gcn_torch.ops import query as Q

    rng = np.random.default_rng(14)
    axis2 = torch.tensor([0, 2], dtype=torch.int32, device=dev)
    calls = []

    def operands(*arrays, **kw):
        *ops, window = query_operands(*arrays, **kw)
        return tuple(torch.from_numpy(a).to(dev) for a in ops), window

    def k2(what, args, axis, **kw):
        for kernel, ax, mode in ((None, None, "ranks"), ((8, 2, 2), None,
                                 "bins"), ((8, 2, 2), axis, "grouped")):
            for dist in (False, True):
                calls.append((f"{what}, {mode}{' +dist' if dist else ''}",
                              "dense_query", args + (ax,),
                              dict(kw, kernel=kernel, need_dist=dist)))

    def k7(what, args, **kw):
        for dist in (False, True):
            calls.append((f"{what}{' +dist' if dist else ''}",
                          "growth_query", args, dict(kw, need_dist=dist)))

    for radius in (0.1, 0.2, 0.4, 0.8):
        t_in, t_radial, t_far = Q.query_thresholds(radius, 2)
        args, w = operands(*boundary_clouds((t_in, *t_radial, t_far), 256,
                                            rng))
        k2(f"boundaries r={radius}", args, axis2, radius=radius, k=64,
           window=w)
        for steps in (3, 12):
            db, q, _, _ = growth_boundary_clouds(
                Q.growth_thresholds(radius, steps), 256, rng)
            args, w = operands(db, q)
            k7(f"growth boundaries r={radius} G={steps}", args,
               radius=radius, k=8, window=w, growth_steps=steps)

    cube = rng.random((2, 2000, 3), dtype=np.float32)
    qc = cube[:, :300].copy()
    qc[:, 150:, 0] += 100.0                      # rows with none
    args, w = operands(cube, qc, window=1024, rng=rng)
    args[0][1] = 2e9                             # a sentinel database
    q_p = torch.full((2, 512, 3), 1e9, device=dev)
    q_p[:, :384] = args[1]                       # a sentinel query tile
    args = (args[0], q_p, *(torch.cat([a, a[:, :1]], 1) for a in args[2:]))
    k2("crowded/empty/sentinel", args, torch.tensor([1, 0], dtype=torch.int32,
                                                    device=dev),
       radius=0.3, k=32, window=w)
    k7("crowded/empty/sentinel", args, radius=0.05, k=32, window=w,
       growth_steps=12)
    k7("crowded/empty/sentinel, K at once", args, radius=0.3, k=32,
       window=w, growth_steps=3)

    pts = surface_clouds(rng, 16, N)
    pts = np.take_along_axis(pts, np.argsort(pts[..., :1], 1), 1)
    t = torch.from_numpy(pts).to(dev)
    sub = t[:, ::4].contiguous()
    for what, db, qq, kernel in (("W=2688 pool", t, sub, None),
                                 ("W=2688 intra", t, t, (8, 2, 2))):
        plan = D.plan_dense_query(db, qq, 0.1, kernel, 2688)
        args = (plan.db_p, plan.q_p, plan.s_blk, plan.u_end, plan.axis)
        for dist in (False, True):
            calls.append((f"{what}{' +dist' if dist else ''}", "dense_query",
                          args, dict(radius=0.1, k=64, kernel=kernel,
                                     window=plan.window, need_dist=dist)))
    plan = D.plan_dense_query(sub, t, 0.1, None, 2688, growth_steps=3)
    k7("W=2688 growth", (plan.db_p, plan.q_p, plan.s_blk, plan.u_end),
       radius=0.1, k=64, window=plan.window, growth_steps=3)
    return calls


def query_stress(dev: torch.device) -> None:
    """Phase 25h: K2 and K7 on adversarial operands
    (:func:`query_stress_calls`), each bitwise equal to its plain version
    (maps, counts, growth steps, distance maps), its count equal to its
    map's nonzero bytes a row, one launch a call; times at the largest
    window."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches

    print("dense queries (K2, K7) on adversarial operands, kernel vs plain "
          "version bitwise:", flush=True)
    table = versions()
    with torch.no_grad():
        for what, name, args, kw in query_stress_calls(dev):
            kern, plain, check = table[name]
            reset_kernel_launches()
            got = kern(*args, **kw)
            if kernel_launches()[name] != 1:
                raise AssertionError(f"{name} {what}: "
                                     f"{kernel_launches()[name]} launches")
            try:
                check(got, plain(*args, **kw))
            except AssertionError as e:
                raise AssertionError(f"{name} {what}: {e}") from e
            n = int(got[-2].sum().item())
            ms = ""
            if what.startswith("W=2688"):
                ms = f", {median_ms(lambda: kern(*args, **kw)):.3f} ms"
            print(f"  {name:12s} {what:42s} equal ({n} selected{ms})",
                  flush=True)


def windowed_phases(dev: torch.device, batches: list[np.ndarray],
                    res_fwd: Results, res_step: Results
                    ) -> tuple[dict, dict]:
    """Phases 14-19 (see the module docstring): the per-edge engine of
    ``modelnet_config(fast=True)`` and the dense engine's fallback to it;
    ``batches`` are the vote-serving batches of phase 4. Returns the
    launch counts of the per-edge serving run and of the per-edge train
    run."""
    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.data import augment as aug
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.models.common import classic_clone
    from sph3d_gcn_torch.ops import windowed as W
    from sph3d_gcn_torch.ops.neighbor import build_sphere_neighbor_and_bins
    from sph3d_gcn_torch.train.eval import checked_forward, vote_classify
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import classification_step_factory

    cfg = modelnet_config(fast=True)
    gen = torch.Generator().manual_seed(4)
    model = SPH3DModelNet(cfg, generator=gen)
    randomize_bn(model, gen)
    model = model.to(dev).eval()
    levels = range(len(cfg.radius))
    print(f"per-edge engine: modelnet_config(fast=True), B={B} N={N}, conv "
          f"windows {[cfg.enc_window(lv) for lv in levels]} / pool "
          f"{[cfg.pool_window(lv) for lv in levels]} (the kernels do not "
          f"depend on them)", flush=True)
    rng = np.random.default_rng(30)
    x = torch.from_numpy(surface_clouds(rng, B, N)).to(dev)

    def gathers(calls, names=("window_gather", "window_gather_bwd")):
        return [c for c in calls if c[0] in names]

    # 14. per-kernel parity: one plain forward's K8 calls
    print("per-kernel parity, per-edge forward (times: median of CUDA "
          "events)", flush=True)
    with _build.record_calls() as calls, torch.inference_mode():
        model(x, use_kernels=False)
    replay(gathers(calls), res_fwd, {"window_gather": 9},
           plain_reps=FWD_PLAIN_REPS)
    res_fwd.summary("ModelNet per-edge forward")
    del calls

    # 15. the dense engine's fallback: default-window vote serving
    dense = SPH3DModelNet(modelnet_config(fast=True, dense=True)).to(dev)
    dense.load_state_dict(model.state_dict())
    dense.eval()
    clone = classic_clone(dense)
    checked = checked_forward(dense, dev)
    fell, per_vote = [], []

    def forward(points):
        reset_kernel_launches()
        logits = checked(points)
        launches = kernel_launches()
        back = not bool(dense.dense_ok)
        fell.append(back)
        per_vote.append(launches["window_gather"])
        want = dict(PER_FORWARD, window_gather=0)
        if back:
            want["fps"] += PER_WIN_FORWARD["fps"]
            want["window_gather"] = PER_WIN_FORWARD["window_gather"]
            with torch.inference_mode():
                direct = clone(torch.as_tensor(points, device=dev))
            if not np.array_equal(direct.float().cpu().numpy(), logits):
                raise AssertionError("fallback logits != direct per-edge "
                                     "forward")
        got = {k: launches.get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"vote launches {got}, want {want}")
        return logits

    t0 = time.perf_counter()
    for bi, batch in enumerate(batches):
        votes = vote_classify(forward, batch, num_votes=VOTES,
                              rng=np.random.default_rng(100 + bi))
        if votes.shape != (B, cfg.num_cls) or not np.isfinite(votes).all():
            raise AssertionError(f"bad vote logits {votes.shape}")
    wall = time.perf_counter() - t0
    print(f"default-window vote serving: {BATCHES} batches x {VOTES} votes, "
          f"{sum(fell)} of {len(fell)} forwards fell back to the per-edge "
          f"engine (votes {[i for i, f in enumerate(fell) if f]}), each "
          f"fallback's logits equal to a direct per-edge forward on the "
          f"same weights, K8 launches per vote {per_vote}; {wall:.3f} s "
          f"host clock", flush=True)
    if not any(fell[1:VOTES]) and not any(fell[VOTES + 1:]):
        raise AssertionError("no rotated vote fell back: the fallback "
                             "was not exercised")
    del dense, clone, checked

    # 16. the per-edge forward through the kernels
    reset_kernel_launches()
    n_fwd = 4
    with torch.inference_mode():
        for _ in range(n_fwd):
            got = model(x)
        torch.cuda.synchronize()
        fwd_launches = kernel_launches()
        ref = model(x, use_kernels=False)
        fwd_ms = median_ms(lambda: model(x))
        plain_fwd_ms = median_ms(lambda: model(x, use_kernels=False),
                                 reps=3)
    print(f"launches over {n_fwd} per-edge forwards: {fwd_launches}",
          flush=True)
    for name, per in PER_WIN_FORWARD.items():
        if fwd_launches[name] != per * n_fwd:
            raise AssertionError(f"{name}: {fwd_launches[name]} launches, "
                                 f"want {per} per forward")
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"per-edge kernel vs plain logits: max_abs_err {diff:.4g}, argmax "
          f"agreement {agree:.4f} (|logits| <= {scale:.3g}, tolerance "
          f"{LOGIT_TOL:g} of that)", flush=True)
    torch.testing.assert_close(got, ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * scale)
    # the sphere query with bins of each level, alone (the levels' clouds
    # stand in as prefixes of the batch: the query's cost is in N and M)
    query_ms = []
    with torch.inference_mode():
        for lv in levels:
            pts = x[:, :N // 4 ** lv].contiguous()
            query_ms.append(median_ms(lambda: build_sphere_neighbor_and_bins(
                pts, pts, cfg.radius[lv], cfg.nn_uplimit[lv], cfg.kernel)))
    print(f"per-edge sphere query + bins per level: "
          f"{[round(t, 3) for t in query_ms]} ms, {sum(query_ms):.2f} ms "
          f"per forward (CUDA events, median)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model(x)
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"per-edge forward B={B} N={N}: {fwd_ms:.2f} ms "
          f"({B * N / fwd_ms * 1e3:.0f} points/s) with kernels, "
          f"{plain_fwd_ms:.2f} ms with the plain versions (CUDA events, "
          f"median); peak device memory {fwd_peak:.2f} GiB", flush=True)
    profile_forward(model, x, "per-edge")

    # 17. the per-edge train step
    model.train()
    labels = torch.from_numpy(np.random.default_rng(31).integers(
        0, cfg.num_cls, (B,)).astype(np.int64)).to(dev)
    batch = {"points": x, "label": labels}
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def factory(use_kernels, net=model):
        opt, sch = make_optimizer(
            net.parameters(), "adam",
            exponential_decay_lr(0.001, batch_size=B))
        return classification_step_factory(
            net, opt, sch, weight_decay=cfg.weight_decay,
            use_kernels=use_kernels)

    def dropout_gen():
        return torch.Generator(device=dev).manual_seed(5)

    def grads_of(step):
        step.model.load_state_dict(state0)
        metrics = step.loss_and_grads(batch, dropout_gen())
        return metrics, {k: p.grad.clone()
                         for k, p in step.model.named_parameters()}

    model32 = SPH3DModelNet(dataclasses.replace(
        cfg, compute_dtype="float32")).to(dev)
    print("per-kernel parity, per-edge train step (K8 and K9 calls of one "
          "plain bf16 step, then K9 of one plain f32 step)", flush=True)
    model.load_state_dict(state0)
    with _build.record_calls() as calls:
        factory(False).loss_and_grads(batch, dropout_gen())
    replay(gathers(calls), res_step,
           {"window_gather": 9, "window_gather_bwd": 9},
           plain_reps=PLAIN_REPS)
    # the backward's inverse edge lists: one build per neighbourhood (a
    # level's two convs share theirs), timed alone
    nbhs = {id(args[1]): args for name, args, _ in calls
            if name == "window_gather"}
    built = {id(args[1]) for name, args, _ in calls
             if name == "window_gather_bwd"}
    if len(nbhs) != 6 or len(built) != len(nbhs):
        raise AssertionError(f"{len(built)} edge-list builds for "
                             f"{len(nbhs)} neighbourhoods, want 6 and 6")
    lists_ms = [median_ms(lambda a=a: W.edge_lists(a[1], a[2],
                                                   a[0].shape[1]))
                for a in nbhs.values()]
    print(f"inverse edge lists: {len(built)} builds per step, "
          f"{[round(t, 3) for t in lists_ms]} ms, {sum(lists_ms):.3f} ms "
          f"per step (CUDA events, median)", flush=True)
    model32.load_state_dict(state0)
    with _build.record_calls() as calls:
        factory(False, model32).loss_and_grads(batch, dropout_gen())
    res32 = Results()
    replay(gathers(calls, ("window_gather_bwd",)), res32,
           {"window_gather_bwd": 9}, plain_reps=PLAIN_REPS)
    res_step.err["window_gather_bwd"] = max(
        res_step.err["window_gather_bwd"], res32.err["window_gather_bwd"])
    res_step.summary("ModelNet per-edge train step (bf16)")
    res32.summary("K9 of the per-edge f32 train step")
    k9_line(res_step, "the ModelNet per-edge bf16 step", ("device", 0.97))
    k9_line(res32, "the ModelNet per-edge f32 step")
    del calls

    compare_steps(grads_of, factory, model32, "per-edge train step")
    del model32
    check_bitwise_steps(grads_of, factory(None), " (per-edge)")

    model.load_state_dict(state0)
    step = factory(None)
    gen = dropout_gen()
    step.train_step(batch, gen)            # warm-up
    model.load_state_dict(state0)
    step = factory(None)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    for _ in range(WIN_STEPS):
        t0 = time.perf_counter()
        metrics = step.train_step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    step_launches = kernel_launches()
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = torch.stack(losses).cpu()
    print(f"{WIN_STEPS} per-edge train steps: loss {loss[0].item():.4f} -> "
          f"{loss[-1].item():.4f}; launches {step_launches}", flush=True)
    for name, per in PER_WIN_STEP.items():
        if step_launches[name] != per * WIN_STEPS:
            raise AssertionError(f"{name}: {step_launches[name]} launches, "
                                 f"want {per} per step")
    if not torch.isfinite(loss).all() or not loss[-1] < loss[0]:
        raise AssertionError(f"loss did not fall: {loss.tolist()}")
    step_ms = float(np.median(times)) * 1e3
    model.load_state_dict(state0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factory(False).train_step(batch, dropout_gen())
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"per-edge train step B={B} N={N}: {step_ms:.2f} ms median of "
          f"{WIN_STEPS} (host clock, synchronised; "
          f"{B * N / step_ms * 1e3:.0f} points/s) with kernels, "
          f"{plain_ms:.2f} ms for one step with the plain versions; peak "
          f"device memory {step_peak:.2f} GiB", flush=True)

    # 18. profile of the per-edge train step
    profile_steps(lambda: step.train_step(batch, gen), "per-edge train step")

    # 19. fit()'s recovery: a half-rotated batch fails the dense
    # certificate; the batch is re-run from the pre-step state through
    # StepFactory.classic_fallback(), on the dense model's parameters
    dense = SPH3DModelNet(modelnet_config(fast=True, dense=True)).to(dev)
    dense.load_state_dict(state0)
    # the JAX policy rotates half of a batch about z; draw rotations until
    # one leaves a cloud outside the default windows (a certificate costs
    # one inference forward)
    for tries, seed in enumerate(range(32, 64), 1):
        rot = x.cpu().numpy().copy()
        rot[B // 2:] = aug.rotate_point_cloud(rot[B // 2:],
                                              np.random.default_rng(seed))
        rot = torch.from_numpy(rot).to(dev)
        with torch.inference_mode():
            dense.eval()(rot)
        if not bool(dense.dense_ok):
            break
    else:
        raise AssertionError("no half-rotated batch failed the dense "
                             "certificate: no fallback to exercise")
    print(f"half-rotated batch: rotation seed {seed} fails the dense "
          f"certificate ({tries} drawn)", flush=True)
    check_recovery("half-rotated batch", factory(None, dense),
                   lambda: factory(None), model, state0,
                   {"points": rot, "label": labels},
                   lambda: (dropout_gen(),), PER_WIN_STEP)
    return fwd_launches, step_launches


def s3dis_weighted_phases(dev: torch.device, res: Results
                          ) -> tuple[dict[str, int], list]:
    """Phases 26-27 (see the module docstring): S3DIS with the weighted
    unpool. Returns the launch counts of the served forwards and the
    recorded growth-query calls (with distance maps) of one forward."""
    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import s3dis_config
    from sph3d_gcn_torch.data.synthetic import scene_blocks
    from sph3d_gcn_torch.models import SPH3DSceneSeg
    from sph3d_gcn_torch.ops import dense as D
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import segmentation_step_factory

    cfg = dataclasses.replace(s3dis_config(fast=True, dense=True),
                              unpool_method="weighted")
    gen = torch.Generator().manual_seed(8)
    model = SPH3DSceneSeg(cfg, generator=gen)
    randomize_bn(model, gen)
    model = model.to(dev).eval()
    x = torch.from_numpy(scene_blocks(np.random.default_rng(50), S3_B, S3_N)
                         ).to(dev)
    print(f"S3DIS, weighted unpool: B={S3_B} N={S3_N}, inter graphs with "
          f"distance maps", flush=True)

    # 26. the served forward: kernels against plain versions
    with _build.record_calls() as calls, torch.inference_mode():
        ref = model(x, use_kernels=False)
    ok_p = bool(model.dense_ok)
    growth = [c for c in calls if c[0] == "growth_query"]
    unpools = [c for c in calls if c[0] == "weighted_interpolate"]
    if (len(growth), len(unpools)) != (4, 4) or not all(
            kw.get("need_dist") for _, _, kw in growth):
        raise AssertionError(f"recorded {len(growth)} growth queries and "
                             f"{len(unpools)} weighted unpools, want 4 and "
                             f"4, all queries with distance maps")
    del calls
    n_fwd = 3
    torch.cuda.synchronize()
    reset_kernel_launches()
    with torch.inference_mode():
        for _ in range(n_fwd):
            got = model(x)
        torch.cuda.synchronize()
        launches = kernel_launches()
        ok_k = bool(model.dense_ok)
        fwd_ms = median_ms(lambda: model(x))
    print(f"launches over {n_fwd} weighted-unpool forwards: {launches}",
          flush=True)
    for name, per in PER_SEG_FORWARD.items():
        if launches[name] != per * n_fwd:
            raise AssertionError(
                f"{name}: {launches[name]} launches, want {per} per forward")
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"S3DIS weighted kernel vs plain logits: dense_ok {ok_k} / "
          f"{ok_p}, max_abs_err {diff:.4g}, argmax agreement {agree:.4f} "
          f"(|logits| <= {scale:.3g}, tolerance {LOGIT_TOL:g} of that); "
          f"forward {fwd_ms:.2f} ms with kernels", flush=True)
    if not (ok_k and ok_p) or agree < 0.95:
        raise AssertionError("weighted S3DIS forward: certificate or argmax")
    torch.testing.assert_close(got, ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * scale)
    print("weighted unpool forward beside the mean unpool on the same "
          "graphs and features (torch, CUDA events, median):", flush=True)
    with torch.no_grad():
        for _, args, kw in unpools:
            w_ms = median_ms(lambda: D.dense_weighted_interpolate(*args))
            m_ms = median_ms(lambda: D.dense_mean_interpolate(*args))
            res.ms["weighted_interpolate"] += w_ms
            res.ms["mean_interpolate"] += m_ms
            name = "weighted_interpolate"
            print(f"  {describe(name, args, kw):30s} weighted {w_ms:.3f} "
                  f"ms  mean {m_ms:.3f} ms  weighted "
                  f"{res.add_bound(name, work(name, args, kw), w_ms)}",
                  flush=True)
    print(f"  sums: weighted {res.ms['weighted_interpolate']:.3f} ms, mean "
          f"{res.ms['mean_interpolate']:.3f} ms", flush=True)
    del unpools

    # 27. the train step: kernel step against plain step, determinism,
    # steps with their launches, the unpool backwards
    rng = np.random.default_rng(51)
    batch = {
        "points": torch.from_numpy(scene_blocks(rng, S3_B, S3_N)).to(dev),
        "label": torch.from_numpy(rng.integers(
            0, cfg.num_cls, (S3_B, S3_N)).astype(np.int64)).to(dev),
        "inner_label": torch.from_numpy(rng.integers(
            0, 2, (S3_B, S3_N)).astype(np.int32)).to(dev),
    }
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def factory(use_kernels, net=model):
        opt, sch = make_optimizer(
            net.parameters(), "adam",
            exponential_decay_lr(0.001, batch_size=S3_B))
        return segmentation_step_factory(net, opt, sch, inner_masked=True,
                                         use_kernels=use_kernels)

    def grads_of(step):
        step.model.load_state_dict(state0)
        metrics = step.loss_and_grads(batch)
        if not bool(metrics["dense_ok"]):
            raise AssertionError("dense_ok False on the weighted S3DIS "
                                 "train batch")
        return metrics, {k: p.grad.clone()
                         for k, p in step.model.named_parameters()}

    model32 = SPH3DSceneSeg(dataclasses.replace(
        cfg, compute_dtype="float32")).to(dev)
    compare_steps(grads_of, factory, model32, "S3DIS weighted train step")
    del model32
    check_bitwise_steps(grads_of, factory(None), " (S3DIS weighted step)")

    model.load_state_dict(state0)
    with _build.record_calls() as calls:
        factory(None).loss_and_grads(batch)
    bwd = [c for c in calls if c[0] == "mean_interpolate_bwd"]
    del calls
    if len(bwd) != 4 or not all("weights" in kw for _, _, kw in bwd):
        raise AssertionError(f"{len(bwd)} weighted unpool backwards, want 4")
    print("weighted unpool backward (K9) against its plain "
          "version, and the mean unpool's backward on the same gradients:",
          flush=True)
    replay(bwd, res, {"window_gather_bwd": 4}, plain_reps=1)
    k9_line(res, "the S3DIS step's weighted unpool backwards")
    with torch.no_grad():
        mean_bwd = sum(median_ms(lambda a=args: D.window_mean_bwd(*a))
                       for _, args, _ in bwd)
    print(f"  backward sums: weighted {res.ms['mean_interpolate_bwd']:.3f} "
          f"ms, mean {mean_bwd:.3f} ms", flush=True)
    del bwd

    model.load_state_dict(state0)
    step = factory(None)
    step.train_step(batch)                 # warm-up
    model.load_state_dict(state0)
    step = factory(None)
    losses, times = [], []
    torch.cuda.synchronize()
    reset_kernel_launches()
    for _ in range(S3W_STEPS):
        t0 = time.perf_counter()
        metrics = step.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    step_launches = kernel_launches()
    loss = torch.stack(losses).cpu()
    print(f"{S3W_STEPS} weighted S3DIS train steps: loss "
          f"{[round(v, 3) for v in loss.tolist()]}, step "
          f"{float(np.median(times)) * 1e3:.2f} ms median (host clock, "
          f"synchronised); launches {step_launches}", flush=True)
    for name, per in PER_SEG_STEP.items():
        if step_launches[name] != per * S3W_STEPS:
            raise AssertionError(f"{name}: {step_launches[name]} launches, "
                                 f"want {per} per step")
    if not torch.isfinite(loss).all() or not loss[-1] < loss[0]:
        raise AssertionError(f"loss did not fall: {loss.tolist()}")
    profile_steps(lambda: step.train_step(batch), "S3DIS weighted step")
    return launches, growth


def modelnet_option_phases(dev: torch.device, res: Results
                           ) -> tuple[dict[str, int], list]:
    """Phase 28 (see the module docstring): ModelNet with IDS sampling and
    the avg pool. Returns the launch counts of the train steps and the
    recorded dense-query calls of one step."""
    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.ops import dense as D
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import classification_step_factory

    options = dict(sample="IDS", pool_method="avg")
    cfg = dataclasses.replace(modelnet_config(fast=True, dense=True),
                              **options)
    gen = torch.Generator().manual_seed(9)
    model = SPH3DModelNet(cfg, generator=gen)
    randomize_bn(model, gen)
    model = model.to(dev)
    rng = np.random.default_rng(60)
    batch = {
        "points": torch.from_numpy(surface_clouds(rng, B, N)).to(dev),
        "label": torch.from_numpy(
            rng.integers(0, cfg.num_cls, (B,)).astype(np.int64)).to(dev),
    }
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    print(f"ModelNet, IDS sampling and avg pool: B={B} N={N}, windows "
          f"{list(cfg.windows)}; the IDS noise and the dropout masks from "
          f"one seeded generator, the same draws for every step compared",
          flush=True)

    def factory(use_kernels, net=model):
        opt, sch = make_optimizer(
            net.parameters(), "adam",
            exponential_decay_lr(0.001, batch_size=B))
        return classification_step_factory(
            net, opt, sch, weight_decay=cfg.weight_decay,
            use_kernels=use_kernels)

    def noise_gen():
        return torch.Generator(device=dev).manual_seed(10)

    fell = []

    def guarded(step, gen):
        """One step's forward and backward, re-run from the pre-step state
        through classic_fallback() when the certificate fails (as JAX's
        fit() does)."""
        before = {k: v.clone() for k, v in step.model.state_dict().items()}
        seed = gen.get_state()
        metrics = step.loss_and_grads(batch, gen)
        fell.append(not bool(metrics["dense_ok"]))
        if fell[-1]:
            step.model.load_state_dict(before)
            gen.set_state(seed)
            metrics = step.classic_fallback().loss_and_grads(batch, gen)
        return metrics

    def grads_of(step):
        step.model.load_state_dict(state0)
        metrics = guarded(step, noise_gen())
        return metrics, {k: p.grad.clone()
                         for k, p in step.model.named_parameters()}

    model32 = SPH3DModelNet(dataclasses.replace(
        cfg, compute_dtype="float32")).to(dev)
    compare_steps(grads_of, factory, model32, "ModelNet IDS/avg train step")
    del model32
    print(f"ModelNet IDS/avg: dense_ok {not fell[0]} on the train batch"
          + (" (the certificate failed on the config's windows: each step "
             "re-ran through classic_fallback())" if fell[0] else ""),
          flush=True)
    model.load_state_dict(state0)
    with _build.record_calls() as calls:
        factory(None).loss_and_grads(batch, noise_gen())
    queries = [c for c in calls if c[0] == "dense_query"]
    pools = [c for c in calls if c[0] == "avg_pool"]
    pool_bwd = [c for c in calls if c[0] == "mean_interpolate_bwd"]
    del calls
    if len(queries) != 6 or sum(bool(kw.get("need_dist"))
                                for _, _, kw in queries) != 3:
        raise AssertionError("want 6 dense queries, 3 with distance maps")
    if (len(pools), len(pool_bwd)) != (3, 3):
        raise AssertionError(f"{len(pools)} avg pools and {len(pool_bwd)} "
                             f"backwards recorded on the dense engine, "
                             f"want 3 and 3")
    print("dense avg pool forward beside the rank max pool (K4) on the same "
          "graphs and features (CUDA events, median):", flush=True)
    with torch.no_grad():
        for _, args, kw in pools:
            a_ms = median_ms(lambda: D.dense_avg_pool3d(*args))
            m_ms = median_ms(lambda: D.dense_max_pool3d(*args))
            res.ms["avg_pool"] += a_ms
            res.ms["max_pool"] += m_ms
            bound = res.add_bound("avg_pool", work("avg_pool", args, kw),
                                  a_ms)
            print(f"  {describe('avg_pool', args, kw):30s} avg "
                  f"{a_ms:.3f} ms  max {m_ms:.3f} ms  avg {bound}",
                  flush=True)
    print(f"  sums: avg {res.ms['avg_pool']:.3f} ms, max "
          f"{res.ms['max_pool']:.3f} ms", flush=True)
    print("dense avg pool backward (K9) against its plain "
          "version:", flush=True)
    replay(pool_bwd, res, {"window_gather_bwd": 3}, plain_reps=1)
    k9_line(res, "the ModelNet IDS step's avg-pool backwards")
    del pools, pool_bwd

    model.load_state_dict(state0)
    step = factory(None)
    gen = noise_gen()
    n_steps, times, losses = 3, [], []
    torch.cuda.synchronize()
    reset_kernel_launches()
    fell.clear()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        metrics = guarded(step, gen)
        step.optimizer.step()
        step.scheduler.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    launches = kernel_launches()
    n_fb = sum(fell)
    per_dense = {"fps": 0, "dense_query": 6, "dense_conv": 6,
                 "rank_pool": 0, "dense_conv_bwd": 6 * K5_PER_CALL,
                 "rank_pool_bwd": 0}
    want = {k: v * n_steps for k, v in per_dense.items()}
    # a dense step's backward sums its 3 avg pools into the cloud by K9; a
    # step that fell back ran the dense forward, then the per-edge
    # engine's 9 gathers and their 9 backwards
    want["dense_conv_bwd"] -= 6 * K5_PER_CALL * n_fb
    want["window_gather"] = 9 * n_fb
    want["window_gather_bwd"] = 3 * (n_steps - n_fb) + 9 * n_fb
    loss = torch.stack(losses).cpu()
    print(f"{n_steps} ModelNet IDS/avg train steps ({n_fb} through the "
          f"fallback): loss {[round(v, 4) for v in loss.tolist()]}, step "
          f"{float(np.median(times)) * 1e3:.2f} ms median (host clock, "
          f"synchronised); launches {launches}", flush=True)
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"launches {got}, want {want}")
    if not torch.isfinite(loss).all():
        raise AssertionError(f"non-finite loss: {loss.tolist()}")

    def one_step():
        guarded(step, gen)
        step.optimizer.step()
        step.scheduler.step()

    profile_steps(one_step, "ModelNet IDS/avg step")

    # the per-edge engine with the same options: K8 under the avg pool
    pe = SPH3DModelNet(dataclasses.replace(modelnet_config(fast=True),
                                           **options)).to(dev).eval()
    pe.load_state_dict(state0)
    x = batch["points"]
    with torch.inference_mode():
        reset_kernel_launches()
        got = pe(x, generator=noise_gen())
        torch.cuda.synchronize()
        pe_launches = kernel_launches()
        ref = pe(x, use_kernels=False, generator=noise_gen())
        pe_ms = median_ms(lambda: pe(x, generator=noise_gen()))
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"per-edge IDS/avg forward: kernel vs plain logits max_abs_err "
          f"{diff:.4g} (|logits| <= {scale:.3g}), {pe_ms:.2f} ms with "
          f"kernels; launches {pe_launches}", flush=True)
    if pe_launches["window_gather"] != 9 or pe_launches["fps"] != 0:
        raise AssertionError(f"per-edge launches {pe_launches}")
    torch.testing.assert_close(got, ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * scale)
    return launches, queries


def random_sample_phase(dev: torch.device) -> None:
    """Phase 29: one served ModelNet forward with random sampling (with
    replacement) through ``checked_forward``: finite logits, and either a
    covered dense forward or a fallback to the per-edge engine."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.train.eval import checked_forward

    cfg = dataclasses.replace(modelnet_config(fast=True, dense=True),
                              sample="random")
    gen = torch.Generator().manual_seed(11)
    model = SPH3DModelNet(cfg, generator=gen)
    randomize_bn(model, gen)
    model = model.to(dev).eval()
    pts = surface_clouds(np.random.default_rng(70), B, N)
    torch.manual_seed(12)
    reset_kernel_launches()
    logits = checked_forward(model, dev)(pts)
    launches = kernel_launches()
    covered = bool(model.dense_ok)
    print(f"ModelNet random sampling: dense certificate {covered}"
          + ("" if covered else ", served by the per-edge engine")
          + f"; logits {logits.shape} finite "
          f"{bool(np.isfinite(logits).all())}; launches {launches}",
          flush=True)
    want = {"fps": 0, "dense_query": 6, "dense_conv": 6, "rank_pool": 3,
            "window_gather": 0 if covered else 9}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"random-sampling launches {launches}, want "
                             f"{want}")
    if logits.shape != (B, cfg.num_cls) or not np.isfinite(logits).all():
        raise AssertionError("bad random-sampling logits")


def dist_map_replay(calls: list, res: Results) -> None:
    """Phase 30 (a): every recorded query call of the option paths through
    its kernel and its plain version (the distance map bitwise, the
    packed map and growth steps too), and each call with a map once more
    without it: the packed map and steps bitwise unchanged, the kernel's
    time without the map, the map's bytes and its bound (bytes over the
    card's memory rate)."""
    table = versions()
    bare_ms = collections.defaultdict(float)     # the map calls without it
    map_bound = collections.defaultdict(float)
    print("distance-map replay (K2, K7; times: median of CUDA events)",
          flush=True)
    with torch.no_grad():
        for name, args, kw in calls:
            kern, plain, check = table[name]
            what = describe(name, args, kw)
            got = kern(*args, **kw)
            res.add(name, what, got, plain(*args, **kw),
                    median_ms(lambda: kern(*args, **kw)),
                    median_ms(lambda: plain(*args, **kw), 1), check,
                    work(name, args, kw))
            res.add_device(name, what, functools.partial(kern, *args, **kw),
                           None, work(name, args, kw))
            if not kw.get("need_dist"):
                continue
            bare = {k: v for k, v in kw.items() if k != "need_dist"}
            alone = kern(*args, **bare)
            exact(got[:-1] + (None,), alone)
            ms = median_ms(lambda: kern(*args, **bare))
            map_bytes = got[-1].numel() * got[-1].element_size()
            bound = map_bytes / MEM_BYTES_PER_S * 1e3
            bare_ms[name] += ms
            map_bound[name] += bound
            print(f"    without the map {ms:.3f} ms (packed, count"
                  f"{' and steps' if name == 'growth_query' else ''} "
                  f"bitwise unchanged); the map {map_bytes / 1e6:.1f} MB, its "
                  f"bound {bound:.4f} ms", flush=True)
    for name in ("dense_query", "growth_query"):
        if res.calls[name]:
            print(f"  {name}: {res.calls[name]} calls, {res.ms[name]:.3f} ms "
                  f"with the maps, {bare_ms[name]:.3f} ms for the calls "
                  f"with a map without it; the maps' bound "
                  f"{map_bound[name]:.4f} ms", flush=True)
    res.summary("distance-map replay (K2: one ModelNet IDS step's queries; "
                "K7: one weighted S3DIS forward's)")


def s3dis_per_edge_phases(dev: torch.device, res_fwd: Results,
                          res_step: Results) -> tuple[dict, dict, tuple]:
    """Phases 31-34 (see the module docstring): the per-edge engine of
    ``s3dis_config(fast=True)`` and the dense scene model's fallback to
    it. Returns the launch counts of the serving run and of the train
    run, and phase 34's batch with the shrunk block and the state its
    step started from."""
    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import s3dis_config
    from sph3d_gcn_torch.data.synthetic import scene_blocks
    from sph3d_gcn_torch.models import SPH3DSceneSeg
    from sph3d_gcn_torch.models.common import classic_clone
    from sph3d_gcn_torch.ops.neighbor import (
        build_sphere_neighbor,
        build_sphere_neighbor_and_bins,
    )
    from sph3d_gcn_torch.train.eval import (
        checked_forward,
        coverage_eval_blocks,
    )
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import segmentation_step_factory

    # without remat_blocks (the config's default at N=8192), so its
    # numbers stay comparable; phase 40 times the step with and without it
    cfg = dataclasses.replace(s3dis_config(fast=True), remat_blocks=False)
    gen = torch.Generator().manual_seed(10)
    model = SPH3DSceneSeg(cfg, generator=gen)
    randomize_bn(model, gen)
    model = model.to(dev).eval()
    levels = range(len(cfg.radius))
    print(f"S3DIS per-edge engine: s3dis_config(fast=True), B={S3_B} "
          f"N={S3_N}, conv windows {[cfg.enc_window(lv) for lv in levels]} "
          f"/ decoder {[cfg.dec_window(lv) for lv in levels]} (the kernels "
          f"do not depend on them)", flush=True)
    rng = np.random.default_rng(70)
    x = torch.from_numpy(scene_blocks(rng, S3_B, S3_N)).to(dev)

    def gathers(calls, names=("fps", "window_gather", "window_gather_bwd")):
        return [c for c in calls if c[0] in names]

    # 31. per-kernel parity: one plain forward's FPS and K8 calls (the 4
    # unpools gather fine rows from coarse clouds)
    print("per-kernel parity, S3DIS per-edge forward (times: median of "
          "CUDA events)", flush=True)
    with _build.record_calls() as calls, torch.inference_mode():
        model(x, use_kernels=False)
    replay(gathers(calls), res_fwd, PER_S3PE_FORWARD,
           plain_reps=S3_PLAIN_REPS)
    res_fwd.summary("S3DIS per-edge forward")
    del calls

    # 32. serving through the kernels
    reset_kernel_launches()
    n_fwd = 3
    with torch.inference_mode():
        for _ in range(n_fwd):
            got = model(x)
        torch.cuda.synchronize()
        fwd_launches = kernel_launches()
        ref = model(x, use_kernels=False)
        fwd_ms = median_ms(lambda: model(x))
        plain_fwd_ms = median_ms(lambda: model(x, use_kernels=False),
                                 reps=1)
    print(f"launches over {n_fwd} S3DIS per-edge forwards: {fwd_launches}",
          flush=True)
    for name, per in PER_S3PE_FORWARD.items():
        if fwd_launches[name] != per * n_fwd:
            raise AssertionError(f"{name}: {fwd_launches[name]} launches, "
                                 f"want {per} per forward")
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"S3DIS per-edge kernel vs plain logits: max_abs_err {diff:.4g}, "
          f"argmax agreement {agree:.4f} (|logits| <= {scale:.3g}, "
          f"tolerance {LOGIT_TOL:g} of that)", flush=True)
    if agree < 0.95:
        raise AssertionError(f"argmax agreement {agree} < 0.95")
    torch.testing.assert_close(got, ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * scale)
    # the plain sphere queries of one forward, alone (prefixes of the
    # batch stand in for the levels' clouds: the query's cost is in N and
    # M): each encoder level's and decoder level's intra graph with bins,
    # and each decoder's inter graph (fine queries, coarse database)
    sizes = [S3_N] + list(cfg.num_sample)
    query_ms = {"encoder intra": [], "decoder intra": [],
                "decoder inter": []}
    with torch.inference_mode():
        for lv in levels:
            fine = x[:, :sizes[lv], :3].contiguous()
            coarse = x[:, :sizes[lv + 1], :3].contiguous()
            r, k = cfg.radius[lv], cfg.nn_uplimit[lv]
            query_ms["encoder intra"].append(median_ms(
                lambda: build_sphere_neighbor_and_bins(fine, fine, r, k,
                                                       cfg.kernel)))
            query_ms["decoder intra"].append(median_ms(
                lambda: build_sphere_neighbor_and_bins(coarse, coarse, r, k,
                                                       cfg.kernel)))
            query_ms["decoder inter"].append(median_ms(
                lambda: build_sphere_neighbor(coarse, fine, r, k)))
    total_q = sum(sum(v) for v in query_ms.values())
    print("per-edge sphere queries (CUDA events, median), by encoder "
          "level: " + "; ".join(f"{k} {[round(t, 3) for t in v]} ms"
                                for k, v in query_ms.items())
          + f"; {total_q:.2f} ms a forward, {total_q / fwd_ms:.3f} of it",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model(x)
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"S3DIS per-edge forward B={S3_B} N={S3_N}: {fwd_ms:.2f} ms "
          f"({S3_B * S3_N / fwd_ms * 1e3:.0f} points/s) with kernels, "
          f"{plain_fwd_ms:.2f} ms with the plain versions (CUDA events, "
          f"median); peak device memory {fwd_peak:.2f} GiB", flush=True)
    profile_forward(model, x, "S3DIS per-edge")

    # 33. the per-edge train step
    model.train()
    batch = {
        "points": x,
        "label": torch.from_numpy(rng.integers(
            0, cfg.num_cls, (S3_B, S3_N)).astype(np.int64)).to(dev),
        "inner_label": torch.from_numpy(rng.integers(
            0, 2, (S3_B, S3_N)).astype(np.int32)).to(dev),
    }
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def factory(use_kernels, net=model):
        opt, sch = make_optimizer(
            net.parameters(), "adam",
            exponential_decay_lr(0.001, batch_size=S3_B))
        return segmentation_step_factory(net, opt, sch, inner_masked=True,
                                         use_kernels=use_kernels)

    def grads_of(step):
        step.model.load_state_dict(state0)
        metrics = step.loss_and_grads(batch)
        return metrics, {k: p.grad.clone()
                         for k, p in step.model.named_parameters()}

    print("per-kernel parity, S3DIS per-edge train step (the K8 and K9 "
          "calls of one plain bf16 step)", flush=True)
    model.load_state_dict(state0)
    with _build.record_calls() as calls:
        factory(False).loss_and_grads(batch)
    replay(gathers(calls, ("window_gather", "window_gather_bwd")), res_step,
           {"window_gather": 24, "window_gather_bwd": 24},
           plain_reps=S3_PLAIN_REPS)
    res_step.summary("S3DIS per-edge train step (bf16)")
    k9_line(res_step, "the S3DIS per-edge bf16 step", ("device", 0.90))
    del calls

    model32 = SPH3DSceneSeg(dataclasses.replace(
        cfg, compute_dtype="float32")).to(dev)
    compare_steps(grads_of, factory, model32, "S3DIS per-edge train step")
    del model32
    check_bitwise_steps(grads_of, factory(None), " (S3DIS per-edge step)")

    model.load_state_dict(state0)
    factory(None).train_step(batch)        # warm-up
    model.load_state_dict(state0)
    step = factory(None)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    for _ in range(S3PE_STEPS):
        t0 = time.perf_counter()
        metrics = step.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    step_launches = kernel_launches()
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = torch.stack(losses).cpu()
    print(f"{S3PE_STEPS} S3DIS per-edge train steps: loss "
          f"{[round(v, 3) for v in loss.tolist()]}; launches "
          f"{step_launches}", flush=True)
    for name, per in PER_S3PE_STEP.items():
        if step_launches[name] != per * S3PE_STEPS:
            raise AssertionError(f"{name}: {step_launches[name]} launches, "
                                 f"want {per} per step")
    if not torch.isfinite(loss).all() or not loss[-1] < loss[0]:
        raise AssertionError(f"loss did not fall: {loss.tolist()}")
    step_ms = float(np.median(times)) * 1e3
    model.load_state_dict(state0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factory(False).train_step(batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"S3DIS per-edge train step B={S3_B} N={S3_N}: {step_ms:.2f} ms "
          f"median of {S3PE_STEPS} (host clock, synchronised; "
          f"{S3_B * S3_N / step_ms * 1e3:.0f} points/s) with kernels, "
          f"{plain_ms:.2f} ms for one step with the plain versions; peak "
          f"device memory {step_peak:.2f} GiB", flush=True)
    profile_steps(lambda: step.train_step(batch), "S3DIS per-edge step")

    # 34. the dense scene model's recovery: a block shrunk about its
    # center until its neighbors outrun the calibrated windows fails the
    # dense certificate; the step is re-run from its pre-step state
    # through StepFactory.classic_fallback(), and the block is served
    # through checked_forward and coverage_eval_blocks
    dense = SPH3DSceneSeg(s3dis_config(fast=True, dense=True)).to(dev)
    dense.load_state_dict(state0)
    dense.eval()
    with torch.inference_mode():
        dense(x)
    if not bool(dense.dense_ok):
        raise AssertionError("the unshrunk batch fails the dense "
                             "certificate")
    block = scene_blocks(np.random.default_rng(71), 1, S3_P)[0]
    center = (block[:, :3].max(0) + block[:, :3].min(0)) / 2
    for tries, scale in enumerate((0.8, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1), 1):
        shrunk = block.copy()
        shrunk[:, :3] = center + (block[:, :3] - center) * np.float32(scale)
        pts = x.clone()
        pts[0] = torch.from_numpy(shrunk[:S3_N]).to(dev)
        with torch.inference_mode():
            dense(pts)
        if not bool(dense.dense_ok):
            break
    else:
        raise AssertionError("no shrunk block failed the dense "
                             "certificate: no fallback to exercise")
    print(f"a block of {S3_P} points shrunk to {scale} of its size about "
          f"its center fails the dense certificate ({tries} drawn)",
          flush=True)
    shrunk_batch = dict(batch, points=pts)
    check_recovery("batch with the shrunk block", factory(None, dense),
                   lambda: factory(None), model, state0, shrunk_batch,
                   tuple, PER_S3PE_STEP)
    dense.load_state_dict(state0)
    dense.eval()
    clone = classic_clone(dense)
    checked = checked_forward(dense, dev)
    fell = []

    def forward(chunk, ids):
        logits = checked(chunk, ids)
        back = not bool(dense.dense_ok)
        if back and not any(fell):
            with torch.inference_mode():
                direct = clone(torch.as_tensor(chunk, device=dev))
            if not np.array_equal(direct.float().cpu().numpy(), logits):
                raise AssertionError("fallback logits != direct per-edge "
                                     "forward")
        fell.append(back)
        return logits

    inner = ((block[:, :2] >= 0.3) & (block[:, :2] <= 1.2)).all(-1)
    t0 = time.perf_counter()
    (sums,) = coverage_eval_blocks(forward, [(shrunk, inner.astype(
        np.int32))], S3_N, S3_B, rng=np.random.default_rng(72))
    wall = time.perf_counter() - t0
    if (sums.shape != (S3_P, cfg.num_cls) or not np.isfinite(sums).all()
            or not (np.abs(sums[inner]).sum(-1) > 0).all()):
        raise AssertionError("bad logits for the shrunk block")
    print(f"the shrunk block served through coverage_eval_blocks: "
          f"{sum(fell)} of {len(fell)} forwards fell back to the per-edge "
          f"engine (the first equal to a direct per-edge forward), every "
          f"inner point covered; {wall:.3f} s host clock", flush=True)
    if not any(fell):
        raise AssertionError("no forward of the shrunk block fell back")
    return fwd_launches, step_launches, (shrunk_batch, state0)


def fit_launches(launches: dict[str, int], log: str, steps: int,
                 evals: int, what: str, per_step: dict = PER_STEP,
                 per_forward: dict = PER_FORWARD,
                 fb_step: dict = PER_WIN_STEP,
                 fb_forward: dict = PER_WIN_FORWARD) -> dict[str, int]:
    """Checks one epoch of ``fit``'s launch counts: ``steps`` dense steps
    of ``per_step`` and ``evals`` eval forwards of ``per_forward`` (the
    ModelNet model's by default), plus a per-edge step (``fb_step``) or
    forward (``fb_forward``) for each batch that ``log`` (the epoch's
    lines) says re-ran on the classic engine. Returns the train steps'
    share."""
    reruns = [line for line in log.splitlines()
              if "re-running via the classic engine" in line]
    fb_train = sum(" batch " in line for line in reruns)
    fb_eval = sum(" eval " in line for line in reruns)
    train = {k: steps * per_step.get(k, 0) + fb_train * fb_step.get(k, 0)
             for k in launches}
    want = {k: train[k] + evals * per_forward.get(k, 0)
            + fb_eval * fb_forward.get(k, 0) for k in launches}
    print(f"{what}: launches {launches}; {fb_train} of {steps} train and "
          f"{fb_eval} of {evals} eval batches re-ran on the per-edge "
          f"engine", flush=True)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    return train


def seg_factory(cfg, remat: bool, state: dict, dev: torch.device):
    """An S3DIS segmentation step factory (Adam on the staircase schedule,
    the inner-masked loss) on ``cfg`` with ``remat_blocks=remat``, its
    model loaded with ``state``."""
    from sph3d_gcn_torch.models import SPH3DSceneSeg
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import segmentation_step_factory

    net = SPH3DSceneSeg(dataclasses.replace(cfg, remat_blocks=remat)).to(dev)
    net.load_state_dict(state)
    return segmentation_step_factory(net, *make_optimizer(
        net.parameters(), "adam",
        exponential_decay_lr(0.001, batch_size=S3_B)), inner_masked=True)


def entry_point_phases(dev: torch.device, shrunk: tuple) -> dict:
    """Phases 35-40 (see the module docstring): the training and
    evaluation entry points. ``shrunk`` is phase 34's (batch whose
    shrunk block fails the dense certificate, pre-step state). Returns
    the launch counts of the fit and eval-CLI paths."""
    from torch.profiler import ProfilerActivity, profile

    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.cli import evaluate_modelnet, train_modelnet
    from sph3d_gcn_torch.configs import modelnet_config, s3dis_config
    from sph3d_gcn_torch.data import tfrecord
    from sph3d_gcn_torch.data.datasets import (
        load_modelnet_records,
        modelnet_batches,
    )
    from sph3d_gcn_torch.data.synthetic import scene_blocks, surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg
    from sph3d_gcn_torch.models.common import normalize_unit_sphere
    from sph3d_gcn_torch.train.augment_policies import modelnet_train_augment
    from sph3d_gcn_torch.train.checkpoint import Checkpointer
    from sph3d_gcn_torch.train.eval import vote_augment, vote_classify
    from sph3d_gcn_torch.train.loop import fit, step_generator, to_device
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import classification_step_factory
    from sph3d_gcn_torch.utils.windows import (
        derive_config_windows,
        measure_requirements,
    )

    runs = {}
    evals = -(-TEST_RECORDS // B)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)

        # 35. ModelNet-format records, written and read back
        rng = np.random.default_rng(350)
        clouds = {"train": surface_clouds(rng, TRAIN_RECORDS, N),
                  "test": surface_clouds(rng, TEST_RECORDS, N)}
        t0 = time.perf_counter()
        for split, pts in clouds.items():
            path = root / f"{split}.tfrecord"
            with tfrecord.TFRecordWriter(path) as w:
                for i, c in enumerate(pts):
                    # stored in the reference's xzy order: the loader swaps
                    w.write_example({"xyz_raw": c[:, [0, 2, 1]].tobytes(),
                                     "label": np.int64(i % 40)})
            (root / f"{split}_files.txt").write_text(f"{path}\n")
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        records = {}
        for split, pts in clouds.items():
            records[split] = load_modelnet_records(
                [str(root / f"{split}.tfrecord")])
            (whole,) = modelnet_batches(records[split], len(pts),
                                        shuffle=False)
            if not (np.array_equal(whole["points"], pts) and np.array_equal(
                    whole["label"], np.arange(len(pts)) % 40)):
                raise AssertionError(f"{split} records read back unequal")
        read_s = time.perf_counter() - t0
        size = sum((root / f"{s}.tfrecord").stat().st_size for s in clouds)
        crc = ("numpy" if tfrecord._crc32c is tfrecord.crc32c
               else "google_crc32c")
        print(f"records: {TRAIN_RECORDS} train and {TEST_RECORDS} test "
              f"ModelNet clouds of {N} points written with the port's "
              f"writer ({size / 2 ** 20:.1f} MiB, {write_s:.3f} s, crc32c "
              f"by {crc}) and read back bitwise equal ({read_s:.3f} s)",
              flush=True)

        # 36. cli.train_modelnet on the card: one epoch and its eval
        log = root / "log"
        argv = ["--data_dir", str(root), "--log_dir", str(log), "--mode",
                "dense", "--family", "hard", "--batch_size", str(B),
                "--num_input", str(N)]
        reset_kernel_launches()
        t0 = time.perf_counter()
        model = train_modelnet.main(argv + ["--max_epoch", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = (log / "log_train.txt").read_text()
        runs["modelnet_fit"] = fit_launches(
            kernel_launches(), text, FIT_STEPS, evals,
            f"cli.train_modelnet, 1 epoch of {FIT_STEPS} steps and "
            f"{evals} eval batches")
        scalars = [json.loads(x) for x in
                   (log / "metrics.jsonl").read_text().splitlines()]
        fit_ms = scalars[0]["ms_per_batch"]
        for name in ("config.json", "log_train.txt", "metrics.jsonl",
                     "ckpt/0.pt"):
            if not (log / name).is_file():
                raise AssertionError(f"cli.train_modelnet wrote no {name}")
        if not (np.isfinite(scalars[0]["train_loss"])
                and np.isfinite(scalars[1]["eval_loss"])):
            raise AssertionError(f"non-finite loss: {scalars}")
        print(f"cli.train_modelnet: {wall:.2f} s host clock (records "
              f"loaded, model built, {FIT_STEPS} steps, eval, checkpoint); "
              f"train loss {scalars[0]['train_loss']:.4f}, eval loss "
              f"{scalars[1]['eval_loss']:.4f}", flush=True)

        cfg = model.config
        gen = np.random.default_rng((0, 0))
        host_batches = []
        for batch in modelnet_batches(records["train"], B, rng=gen):
            pts, label = modelnet_train_augment(batch["points"],
                                                batch["label"], gen)
            host_batches.append({"points": pts, "label": label})

        def fresh_factory():
            net = SPH3DModelNet(cfg).to(dev)
            net.load_state_dict(model.state_dict())
            return classification_step_factory(
                net, *make_optimizer(net.parameters(), "adam",
                                     exponential_decay_lr(0.001, B)),
                weight_decay=cfg.weight_decay)

        bare = fresh_factory()
        dev_batches = [to_device(b, dev) for b in host_batches]
        times = []
        for i, batch in enumerate(dev_batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bare.train_step(batch, step_generator(0, i, dev))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"fit: {fit_ms:.2f} ms a batch (its log line: the mean of "
              f"{FIT_STEPS} steps, the first included: the copy to the "
              f"device, the pre-step copy, the step, the host reads of "
              f"loss, certificate and logits) against the bare train_step "
              f"on device batches: mean {np.mean(times):.2f} ms, median "
              f"{np.median(times):.2f} ms, each {[round(t, 2) for t in times]}"
              f" (host clock, synchronised, the first included)", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fit(fresh_factory(), lambda epoch: iter(host_batches), None, B,
                1, str(root / "profiled"))
        events = trace_events(prof)
        report_trace(events, "fit step", FIT_STEPS - 1, span="fit_step")
        report_trace(events, "fit pre-step copy", FIT_STEPS - 1,
                     span="pre_step_copy", top=4)
        del bare, dev_batches, events, prof

        # 37. resume to epoch 2: the restored model equals the saved one
        restored = SPH3DModelNet(cfg).to(dev)
        epoch = Checkpointer(log).restore_variables(restored)
        saved = model.state_dict()
        same = [k for k, v in restored.state_dict().items()
                if torch.equal(v, saved[k])]
        print(f"checkpoint of epoch {epoch}: {len(same)} of {len(saved)} "
              f"parameters and statistics restored bitwise equal",
              flush=True)
        if epoch != 0 or len(same) != len(saved):
            raise AssertionError("the checkpoint did not restore the model")
        del restored
        reset_kernel_launches()
        train_modelnet.main(argv + ["--max_epoch", "2"])
        text = (log / "log_train.txt").read_text()
        if "resumed from epoch 0" not in text:
            raise AssertionError("cli.train_modelnet did not resume")
        runs["modelnet_fit_resumed"] = fit_launches(
            kernel_launches(), text[text.index("**** EPOCH 001"):],
            FIT_STEPS, evals, "cli.train_modelnet resumed for epoch 1")
        scalars = [json.loads(x) for x in
                   (log / "metrics.jsonl").read_text().splitlines()]
        if scalars[-2]["step"] != 2 * FIT_STEPS:
            raise AssertionError(f"resumed step count {scalars[-2]}")
        print(f"resumed: epoch 1 ran steps {FIT_STEPS}-{2 * FIT_STEPS - 1}, "
              f"{scalars[-2]['ms_per_batch']:.2f} ms a batch, train loss "
              f"{scalars[-2]['train_loss']:.4f}, eval accuracy "
              f"{scalars[-1]['eval_accuracy']:.4f}", flush=True)

        # 38. cli.evaluate_modelnet with 3 votes
        reset_kernel_launches()
        t0 = time.perf_counter()
        res = evaluate_modelnet.main([
            "--data_dir", str(root), "--log_dir", str(log), "--num_votes",
            str(EVAL_VOTES), "--batch_size", str(B)])
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        want = {k: res["forwards"] * PER_FORWARD.get(k, 0)
                + res["reruns"] * PER_WIN_FORWARD.get(k, 0)
                for k in launches}
        print(f"cli.evaluate_modelnet: {res['forwards']} forwards "
              f"({evals} batches x {EVAL_VOTES} votes), {res['reruns']} "
              f"re-run on the per-edge engine, {wall:.2f} s host clock; "
              f"accuracy {res['accuracy']:.4f}; launches {launches}",
              flush=True)
        if (launches != want or res["votes"].shape != (TEST_RECORDS, 40)
                or not np.isfinite(res["votes"]).all()
                or res["forwards"] != evals * EVAL_VOTES
                or not (log / "pred_votes.npz").is_file()):
            raise AssertionError(f"cli.evaluate_modelnet: launches "
                                 f"{launches}, want {want}")
        runs["modelnet_eval_cli"] = launches

        # 39. fit on phase 34's shrunk block: the classic re-run
        batch, state0 = shrunk
        host = {k: v.cpu().numpy() for k, v in batch.items()}
        dense = seg_factory(s3dis_config(S3_N, fast=True, dense=True), False,
                            state0, dev)
        direct = seg_factory(s3dis_config(S3_N, fast=True), False, state0,
                             dev)
        torch.use_deterministic_algorithms(True)
        try:
            reset_kernel_launches()
            fit(dense, lambda epoch: iter([host]), None, S3_B, 1,
                str(root / "s3dis"), seed=5)
            launches = kernel_launches()
            direct.train_step(batch, step_generator(5, 0, dev))
        finally:
            torch.use_deterministic_algorithms(False)
        text = (root / "s3dis" / "log_train.txt").read_text()
        ref = direct.model.state_dict()
        same = [k for k, v in dense.model.state_dict().items()
                if torch.equal(v, ref[k])]
        want = {k: PER_SEG_STEP.get(k, 0) + PER_S3PE_STEP.get(k, 0)
                for k in launches}
        print(f"fit on the batch with the shrunk block: the log "
              f"{'shows' if 'via the classic engine' in text else 'lacks'} "
              f"the classic re-run; {len(same)} of {len(ref)} parameters "
              f"and statistics bitwise equal to a direct per-edge step; "
              f"launches {launches} (a dense step and a per-edge step)",
              flush=True)
        if ("re-running via the classic engine" not in text
                or len(same) != len(ref) or launches != want):
            raise AssertionError("fit's classic re-run of the shrunk block")
        runs["s3dis_fit_fallback"] = launches
        del dense, direct, batch, state0, shrunk

        # 40. windows derived from vote-rotated clouds, and remat_blocks
        test = clouds["test"][:B]
        votes_rng = np.random.default_rng(400)
        votes = [test] + [vote_augment(test.copy(), votes_rng)
                          for _ in range(EVAL_VOTES - 1)]
        plain = modelnet_config(N, fast=True, dense=True)
        t0 = time.perf_counter()
        reqs = measure_requirements(plain, np.concatenate(votes), device=dev,
                                    normalize=normalize_unit_sphere)
        measure_s = time.perf_counter() - t0
        win, dec_win, dec_margin, growth = derive_config_windows(plain, reqs)
        derived = dataclasses.replace(plain, windows=win,
                                      dec_windows=dec_win,
                                      dec_margin=dec_margin,
                                      growth_steps=growth)
        print(f"windows measured over {len(votes)} votes x {B} clouds in "
              f"{measure_s:.2f} s: " + "; ".join(
                  f"level {lv}: enc {r.enc} pool {r.pool}"
                  for lv, r in enumerate(reqs))
              + f"; derived (10% margin) {win}, against plain "
              f"{plain.windows} and hard {cfg.windows}", flush=True)
        for family, wcfg in (("plain", plain), ("hard", cfg),
                             ("derived", derived)):
            net = SPH3DModelNet(wcfg).to(dev).eval()
            net.load_state_dict(model.state_dict())
            oks = []

            def forward(x):
                logits = net(torch.as_tensor(x, device=dev))
                oks.append(bool(net.dense_ok))
                return logits.float().cpu().numpy()

            with torch.inference_mode():
                vote_classify(forward, test, EVAL_VOTES,
                              np.random.default_rng(400))
                x = torch.from_numpy(votes[1]).to(dev)
                fwd_ms = median_ms(lambda: net(x))
            print(f"{family} windows {wcfg.windows}: {sum(oks)} of "
                  f"{len(oks)} vote forwards certified; forward of vote 1 "
                  f"{fwd_ms:.2f} ms (CUDA events, median)", flush=True)
            if family == "derived" and not all(oks):
                raise AssertionError("the derived windows miss a vote")
        del net

        seg_cfg = s3dis_config(S3_N, fast=True)
        rng = np.random.default_rng(401)
        batch = {
            "points": torch.from_numpy(scene_blocks(rng, S3_B, S3_N)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, seg_cfg.num_cls, (S3_B, S3_N))).to(dev),
            "inner_label": torch.from_numpy(rng.integers(
                0, 2, (S3_B, S3_N)).astype(np.int32)).to(dev),
        }
        state0 = SPH3DSceneSeg(seg_cfg, generator=torch.Generator(
            ).manual_seed(40)).state_dict()
        out = {}
        for remat in (False, True):
            f = seg_factory(seg_cfg, remat, state0, dev)
            torch.use_deterministic_algorithms(True)
            try:
                metrics = f.loss_and_grads(batch)
            finally:
                torch.use_deterministic_algorithms(False)
            grads = {k: p.grad.clone() for k, p in
                     f.model.named_parameters()}
            stats = {k: v.clone() for k, v in f.model.state_dict().items()}
            f.train_step(batch)                        # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(REMAT_STEPS):
                t0 = time.perf_counter()
                f.train_step(batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            out[remat] = (metrics["loss"], grads, stats)
            print(f"S3DIS per-edge train step B={S3_B} N={S3_N}, "
                  f"remat_blocks={remat}: {float(np.median(times)):.2f} ms "
                  f"median of {REMAT_STEPS} (host clock, synchronised), "
                  f"peak device memory {peak:.2f} GiB", flush=True)
            del f
        (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
        same_g = sum(torch.equal(g0[k], g1[k]) for k in g0)
        same_s = sum(torch.equal(s0[k], s1[k]) for k in s0)
        same_l = "equal" if torch.equal(l0, l1) else "differs"
        print(f"remat_blocks: loss {same_l}, {same_g} of {len(g0)} "
              f"gradients and {same_s} of {len(s0)} parameters and "
              f"statistics bitwise equal with and without it "
              f"(torch.use_deterministic_algorithms(True))", flush=True)
        if not torch.equal(l0, l1) or same_g != len(g0) or same_s != len(s0):
            raise AssertionError("remat_blocks changed the step")
    return runs


def shapenet_shapes(rng, cats: list[int], points: int) -> list[dict]:
    """ShapeNet-format shapes: unit-sphere normalized ellipsoid surfaces
    (the family ``shapenet_config``'s windows were calibrated on), each
    split into its category's parts by azimuth; ``part_label`` and the
    global ``seg_label`` 0-based, as the records store them."""
    from sph3d_gcn_torch.cli.train_shapenet import NUM_PARTS
    from sph3d_gcn_torch.data.synthetic import surface_clouds

    clouds = surface_clouds(rng, len(cats), points)
    clouds -= clouds.mean(axis=1, keepdims=True)
    clouds /= np.sqrt((clouds ** 2).sum(-1)).max(axis=1)[:, None, None]
    offsets = np.concatenate([[0], np.cumsum(NUM_PARTS)])
    shapes = []
    for xyz, cat in zip(clouds, cats):
        azimuth = np.arctan2(xyz[:, 1], xyz[:, 0]) + np.pi
        part = np.minimum((azimuth / (2 * np.pi) * NUM_PARTS[cat]).astype(
            np.int32), NUM_PARTS[cat] - 1)
        shapes.append({"xyz": xyz.astype(np.float32), "part_label": part,
                       "seg_label": (part + offsets[cat]).astype(np.int32),
                       "cls_label": cat})
    return shapes


def write_shapenet_records(path: Path, shapes: list[dict]) -> str:
    from sph3d_gcn_torch.data import tfrecord

    with tfrecord.TFRecordWriter(path) as w:
        for s in shapes:
            w.write_example({"xyz_raw": s["xyz"].tobytes(),
                             "part_label": s["part_label"].tobytes(),
                             "seg_label": s["seg_label"].tobytes(),
                             "cls_label": np.int64(s["cls_label"])})
    return str(path)


def facade_blocks(rng, batch: int, n: int) -> np.ndarray:
    """(batch, n, 9) RueMonge-format points: scene-block xyz, unit normals,
    rgb."""
    from sph3d_gcn_torch.data.synthetic import scene_blocks

    xyz = scene_blocks(rng, batch, n)[..., :3]
    normal = rng.standard_normal((batch, n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    rgb = rng.uniform(-1.0, 1.0, (batch, n, 3)).astype(np.float32)
    return np.concatenate([xyz, normal, rgb], axis=-1)


def seg_step_phases(dev: torch.device, res: Results, what: str, model,
                    model32, batch: dict, inner_masked: bool = False,
                    keys: tuple = ()) -> dict[str, int]:
    """A segmentation train path's checks (phases 41 and 44): one plain
    step's kernel calls replayed through kernel and plain version (no
    device-time profile of each call); kernel step vs plain step (bf16,
    and f32 on ``model32``) under phase 21's gates; two kernel steps
    bitwise equal; SEG_STEPS steps with launches, certificates and a
    falling loss; the step's time, peak memory and profile (device busy
    and idle share). Returns the launches of the timed steps."""
    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import segmentation_step_factory

    bsize, npts = batch["points"].shape[:2]
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def factory(use_kernels, net=model):
        opt, sch = make_optimizer(
            net.parameters(), "adam",
            exponential_decay_lr(0.001, batch_size=bsize))
        return segmentation_step_factory(
            net, opt, sch, inner_masked=inner_masked,
            use_kernels=use_kernels, model_kwargs_keys=keys)

    def grads_of(step):
        step.model.load_state_dict(state0)
        metrics = step.loss_and_grads(batch)
        if not bool(metrics["dense_ok"]):
            raise AssertionError(f"dense_ok False on the {what} batch")
        return metrics, {k: p.grad.clone()
                         for k, p in step.model.named_parameters()}

    print(f"{what}: B={bsize} N={npts}, columns {batch['points'].shape[2]}"
          f", {'inner-masked' if inner_masked else 'plain mean'} loss, "
          f"model inputs {('points',) + keys}", flush=True)
    print(f"per-kernel parity, {what} (forward + backward, times: median "
          f"of {SEG_REPS} CUDA-event runs)", flush=True)
    model.load_state_dict(state0)
    with _build.record_calls() as calls:
        factory(False).loss_and_grads(batch)
    n_unpool = [sum(name == u for name, _, _ in calls)
                for u in ("mean_interpolate", "mean_interpolate_bwd")]
    if n_unpool != [4, 4]:
        raise AssertionError(f"recorded unpools and backwards {n_unpool}")
    replay(calls, res, PER_SEG_STEP, plain_reps=1, reps=SEG_REPS,
           device=False)
    res.summary(what)
    del calls

    compare_steps(grads_of, factory, model32, what)
    check_bitwise_steps(grads_of, factory(None), f" ({what})")

    model.load_state_dict(state0)
    factory(None).train_step(batch)        # warm-up (allocator, cuBLAS)
    model.load_state_dict(state0)
    step = factory(None)
    losses, oks, times = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    for _ in range(SEG_STEPS):
        t0 = time.perf_counter()
        metrics = step.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
        oks.append(metrics["dense_ok"])
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = torch.stack(losses).cpu()
    print(f"{SEG_STEPS} {what}s: loss {[round(v, 4) for v in loss.tolist()]}"
          f"; launches {launches}", flush=True)
    for name, per in PER_SEG_STEP.items():
        if launches[name] != per * SEG_STEPS:
            raise AssertionError(
                f"{name}: {launches[name]} launches, want {per} per step")
    if not bool(torch.stack(oks).all()):
        raise AssertionError(f"dense_ok False on a {what}")
    if not torch.isfinite(loss).all() or not loss[-1] < loss[0]:
        raise AssertionError(f"loss did not fall: {loss.tolist()}")
    step_ms = float(np.median(times)) * 1e3
    model.load_state_dict(state0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factory(False).train_step(batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"{what} B={bsize} N={npts}: {step_ms:.2f} ms median of "
          f"{SEG_STEPS} (host clock, synchronised; "
          f"{bsize * npts / step_ms * 1e3:.0f} points/s) with kernels, "
          f"{plain_ms:.2f} ms for one step with the plain versions; peak "
          f"device memory {peak:.2f} GiB", flush=True)
    profile_steps(lambda: step.train_step(batch), what)
    model.load_state_dict(state0)
    return launches


def serve_replay(model, x: torch.Tensor, extra: list, res: Results,
                 what: str) -> None:
    """One plain forward's kernel calls replayed through kernel and plain
    version (no device-time profile of each call); the kernel forward's
    logits against the plain one's; its time (CUDA events)."""
    from sph3d_gcn_torch import _build

    print(f"per-kernel parity, {what} (times: median of {SEG_REPS} "
          f"CUDA-event runs)", flush=True)
    with _build.record_calls() as calls, torch.inference_mode():
        model(x, *extra, use_kernels=False)
    if not bool(model.dense_ok):
        raise AssertionError(f"dense_ok False on the {what} batch")
    replay(calls, res, PER_SEG_FORWARD, plain_reps=1, reps=SEG_REPS,
           device=False)
    res.summary(what)
    del calls
    with torch.inference_mode():
        got = model(x, *extra)
        ref = model(x, *extra, use_kernels=False)
        fwd_ms = median_ms(lambda: model(x, *extra), SEG_REPS)
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    scale = ref.abs().max().item()
    print(f"{what}: kernel vs plain logits max_abs_err "
          f"{(got - ref).abs().max().item():.4g}, argmax agreement "
          f"{agree:.4f} (|logits| <= {scale:.3g}); forward B={x.shape[0]} "
          f"N={x.shape[1]} {fwd_ms:.2f} ms with kernels", flush=True)
    if agree < 0.95:
        raise AssertionError(f"argmax agreement {agree} < 0.95")
    torch.testing.assert_close(got, ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * scale)


def eval_launches(out: dict, launches: dict[str, int], what: str) -> None:
    """An eval CLI's launches: ``PER_SEG_FORWARD`` a forward, plus the
    per-edge forward of each that re-ran."""
    want = {k: out["forwards"] * PER_SEG_FORWARD.get(k, 0)
            + out["reruns"] * PER_S3PE_FORWARD.get(k, 0) for k in launches}
    print(f"{what}: {out['forwards']} forwards, {out['reruns']} re-run on "
          f"the per-edge engine; launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")


def scene_set(root: Path, rng, area: int, dims=(4.5, 3.0, 3.0),
              facade: bool = False) -> None:
    """One voxelized scene of ``Area_<area>`` (its npz with ``xyz``,
    ``label`` and a full-resolution cloud of twice the points) and its
    block records (1.5 m blocks every 0.75 m in x and y, the inner mask
    the middle 0.75 m, ``index_label`` the block->scene map), listed in
    ``test_files_fold<area>.txt`` (``test_files.txt`` for a facade: xyz,
    normals and rgb). The density is the served blocks' (10000 points a
    1.5 m square)."""
    from sph3d_gcn_torch.data import tfrecord

    block, stride = 1.5, 0.75
    num_cls = 7 if facade else 13
    size = int(S3_P * dims[0] * dims[1] / block ** 2)
    xyz = (rng.uniform(0.0, 1.0, (size, 3)) * dims).astype(np.float32)
    label = rng.integers(0, num_cls, size).astype(np.int32)
    full = np.repeat(xyz, 2, axis=0) + rng.normal(
        0.0, 0.005, (2 * size, 3)).astype(np.float32)
    name = f"Area_{area}_{'facade' if facade else 'office'}_1"
    (root / "scenes").mkdir(exist_ok=True)
    np.savez(root / "scenes" / f"{name}.npz", xyz=xyz, label=label,
             full_xyz=full, full_label=np.repeat(label, 2))
    normal = rng.standard_normal((size, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    rgb = rng.random((size, 3)).astype(np.float32)
    path = root / f"{name}.tfrecord"
    with tfrecord.TFRecordWriter(path) as w:
        for x0 in np.arange(0.0, dims[0] - block + 1e-6, stride):
            for y0 in np.arange(0.0, dims[1] - block + 1e-6, stride):
                lo = np.array([x0, y0], np.float32)
                rel = xyz[:, :2] - lo
                index = np.flatnonzero(((rel >= 0) & (rel < block)).all(1))
                mid = rel[index]
                inner = ((mid >= (block - stride) / 2)
                         & (mid < (block + stride) / 2)).all(1)
                ex = {"xyz_raw": xyz[index].tobytes(),
                      "rgb_raw": rgb[index].tobytes(),
                      "seg_label": label[index].tobytes(),
                      "inner_label": inner.astype(np.int32).tobytes(),
                      "index_label": index.astype(np.int32).tobytes()}
                if facade:
                    ex["normal_raw"] = normal[index].tobytes()
                w.write_example(ex)
    lst = "test_files.txt" if facade else f"test_files_fold{area}.txt"
    (root / lst).write_text(f"{path}\n")


def check_scene_eval(out: dict, log: Path, scene_dir: Path, metric: Path,
                     num_cls: int, what: str) -> None:
    """``cli.evaluate_scene_seg``'s outputs: every block's inner points
    covered, its saved blocks merged again (``data.merge``) equal to its
    merged labels, the fold file's counts equal to its accumulator's."""
    from sph3d_gcn_torch.data.merge import (
        SceneAccumulator,
        merge_scene_predictions,
    )

    per_scene: dict[str, list] = {}
    for name in os.listdir(log / "block_results"):
        blk = np.load(log / "block_results" / name)
        if not (np.isfinite(blk["logits"]).all() and (np.abs(
                blk["logits"][blk["inner"] == 1]).sum(-1) > 0).all()):
            raise AssertionError(f"{what}: block {name} not covered")
        scene, i = name[:-4].rsplit("_", 1)
        per_scene.setdefault(scene, []).append(
            (int(i), (blk["index"], blk["inner"], blk["logits"])))
    for scene, blks in per_scene.items():
        gt = np.load(scene_dir / f"{scene}.npz")
        again = merge_scene_predictions(
            len(gt["label"]), [b for _, b in sorted(blks, key=lambda t: t[0])],
            num_cls)
        if not np.array_equal(again, out["merged"][scene]):
            raise AssertionError(f"{what}: {scene} merged labels differ")
    acc = out["accumulator"]
    fold = SceneAccumulator.load(str(metric))
    if not (np.array_equal(fold.total_union, acc.total_union)
            and fold.merged_seen == acc.merged_seen):
        raise AssertionError(f"{what}: the fold file's counts differ")


def family_phases(dev: torch.device, runs: dict) -> dict:
    """Phases 41-46 (see the module docstring): the ShapeNet and RueMonge
    models and the scene evaluation. Adds each replayed path's
    (Results, launches) to ``runs``; returns the launch counts of the
    entry points' runs."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.cli import (
        aggregate_folds,
        evaluate_scene_seg,
        evaluate_shapenet,
        train_scene_seg,
        train_shapenet,
    )
    from sph3d_gcn_torch.cli.train_shapenet import NUM_PARTS
    from sph3d_gcn_torch.configs import (
        ruemonge2014_config,
        s3dis_config,
        shapenet_config,
    )
    from sph3d_gcn_torch.cli import read_list
    from sph3d_gcn_torch.data import tfrecord
    from sph3d_gcn_torch.data.datasets import (
        load_scene_blocks,
        resample_indices,
    )
    from sph3d_gcn_torch.data.merge import SceneAccumulator
    from sph3d_gcn_torch.data.synthetic import scene_blocks
    from sph3d_gcn_torch.models import (
        SPH3DRueMonge,
        SPH3DSceneSeg,
        SPH3DShapeNet,
        SPH3DShapeNetOnehot,
    )
    from sph3d_gcn_torch.train.checkpoint import Checkpointer, snapshot_config
    from sph3d_gcn_torch.train.schedule import make_optimizer

    fit_runs = {}
    sn_cfg = shapenet_config(fast=True, dense=True)
    levels = range(len(sn_cfg.radius))
    print(f"ShapeNet: windows {[sn_cfg.enc_window(lv) for lv in levels]} / "
          f"pool {[sn_cfg.pool_window(lv) for lv in levels]} / decoder "
          f"{[sn_cfg.dec_window(lv) for lv in levels]} + margin "
          f"{sn_cfg.dec_margin}, growth {sn_cfg.growth_steps}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)

        # 41. the one-hot ShapeNet train step
        rng = np.random.default_rng(410)
        cats = [i % len(NUM_PARTS) for i in range(SN_B)]
        shapes = shapenet_shapes(rng, cats, SN_N)
        batch = {
            "points": torch.from_numpy(np.stack(
                [s["xyz"] for s in shapes])).to(dev),
            "label": torch.from_numpy(np.stack(
                [s["seg_label"] for s in shapes]).astype(np.int64)).to(dev),
            "cls_label": torch.tensor(cats, device=dev),
        }
        gen = torch.Generator().manual_seed(41)
        model = SPH3DShapeNetOnehot(sn_cfg, generator=gen).to(dev)
        model32 = SPH3DShapeNetOnehot(dataclasses.replace(
            sn_cfg, compute_dtype="float32")).to(dev)
        res = Results()
        launches = seg_step_phases(dev, res, "ShapeNet one-hot train step",
                                   model, model32, batch,
                                   keys=("cls_label",))
        runs["shapenet_onehot_train_step"] = (res, launches)
        del model, model32, batch

        # 42. cli.train_shapenet --onehot and --category chair
        rng = np.random.default_rng(420)
        chair = 4
        train = shapenet_shapes(rng, [i % len(NUM_PARTS)
                                      for i in range(SN_TRAIN_SHAPES)],
                                SN_POINTS)
        chairs = shapenet_shapes(rng, [chair] * SN_CHAIRS, SN_POINTS)
        tests = shapenet_shapes(rng, [chair] * SN_TEST_CHAIRS, SN_POINTS)
        t0 = time.perf_counter()
        for name, shp in (("train", train + chairs), ("test", tests)):
            path = write_shapenet_records(root / f"sn_{name}.tfrecord", shp)
            (root / f"{name}_files.txt").write_text(f"{path}\n")
            (root / f"chair_{name}_files.txt").write_text(f"{path}\n")
        print(f"ShapeNet records: {len(train) + len(chairs)} train and "
              f"{len(tests)} test shapes of {SN_POINTS} points written in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        n_chairs = sum(s["cls_label"] == chair for s in train + chairs)
        for kind, which, shapes_n in (
                ("onehot", ["--onehot"], len(train) + len(chairs)),
                ("category", ["--category", "chair"],
                 (int(640 / n_chairs) + 1) * n_chairs)):
            log = root / f"log_sn_{kind}"
            reset_kernel_launches()
            t0 = time.perf_counter()
            trained = train_shapenet.main(which + [
                "--data_dir", str(root), "--log_dir", str(log), "--mode",
                "dense", "--batch_size", str(SN_B), "--max_epoch", "1"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = -(-shapes_n // SN_B)
            text = (log / "log_train.txt").read_text()
            fit_runs[f"shapenet_{kind}_fit"] = fit_launches(
                kernel_launches(), text, steps, 0,
                f"cli.train_shapenet {' '.join(which)}, 1 epoch of {steps} "
                f"steps", PER_SEG_STEP, PER_SEG_FORWARD, PER_S3PE_STEP,
                PER_S3PE_FORWARD)
            scalars = [json.loads(x) for x in
                       (log / "metrics.jsonl").read_text().splitlines()]
            if not (np.isfinite(scalars[0]["train_loss"])
                    and (log / "ckpt" / "0.pt").is_file()):
                raise AssertionError(f"cli.train_shapenet {kind}: {scalars}")
            print(f"cli.train_shapenet {' '.join(which)}: {shapes_n} shapes,"
                  f" {wall:.2f} s host clock, {scalars[0]['ms_per_batch']:.2f}"
                  f" ms a batch (its log line), train loss "
                  f"{scalars[0]['train_loss']:.4f}", flush=True)
        del trained

        # 43. ShapeNet per-category serving: replay, then the eval CLI
        log = root / "log_sn_category"
        model = SPH3DShapeNet(sn_cfg, num_cls=NUM_PARTS[chair]).to(dev)
        Checkpointer(log).restore_variables(model)
        model.eval()
        x = torch.from_numpy(np.stack([
            t["xyz"][resample_indices(SN_POINTS, SN_N, rng)]
            for t in tests])).to(dev)
        res = Results()
        serve_replay(model, x, [], res, "ShapeNet per-category forward")
        del model
        reset_kernel_launches()
        t0 = time.perf_counter()
        out = evaluate_shapenet.main([
            "--data_dir", str(root), "--category", "chair", "--log_dir",
            str(log), "--batch_size", str(SN_EVAL_B)])
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        eval_launches(out, launches, "cli.evaluate_shapenet --category chair")
        runs["shapenet_serve"] = (res, launches)
        fit_runs["shapenet_eval_cli"] = launches
        preds = sorted(os.listdir(log / "pred"))
        if (len(preds) != SN_TEST_CHAIRS
                or not np.isfinite(out["instance_miou"])
                or out["forwards"] < 2 * 11):
            raise AssertionError(f"cli.evaluate_shapenet: {preds}, {out}")
        print(f"cli.evaluate_shapenet: {SN_TEST_CHAIRS} shapes of "
              f"{SN_POINTS} points, each point sampled 11 times, raw and "
              f"augmented passes: {out['forwards']} forwards of B="
              f"{SN_EVAL_B} in {wall:.2f} s host clock "
              f"({SN_TEST_CHAIRS / wall:.2f} shapes/s); instance mIoU "
              f"{out['instance_miou']:.4f}", flush=True)

        # 44. the RueMonge train step
        rm_cfg = ruemonge2014_config(fast=True, dense=True)
        rng = np.random.default_rng(440)
        batch = {
            "points": torch.from_numpy(facade_blocks(rng, RM_B, S3_N)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, rm_cfg.num_cls, (RM_B, S3_N)).astype(np.int64)).to(dev),
        }
        model = SPH3DRueMonge(rm_cfg, generator=torch.Generator(
            ).manual_seed(44)).to(dev)
        model32 = SPH3DRueMonge(dataclasses.replace(
            rm_cfg, compute_dtype="float32")).to(dev)
        res = Results()
        launches = seg_step_phases(dev, res, "RueMonge train step", model,
                                   model32, batch)
        runs["ruemonge_train_step"] = (res, launches)
        del model, model32, batch

        # 45. cli.train_scene_seg --dataset ruemonge2014
        rm_root = root / "ruemonge"
        rm_root.mkdir()
        scene_set(rm_root, np.random.default_rng(450), 0, dims=(3.0, 1.5, 3.0),
                  facade=True)
        blocks = facade_blocks(np.random.default_rng(451), 1, S3_P)[0]
        with tfrecord.TFRecordWriter(rm_root / "facade_train.tfrecord") as w:
            w.write_example({
                "xyz_raw": blocks[:, :3].copy().tobytes(),
                "normal_raw": blocks[:, 3:6].copy().tobytes(),
                "rgb_raw": blocks[:, 6:].copy().tobytes(),
                "seg_label": np.random.default_rng(452).integers(
                    0, 7, S3_P).astype(np.int32).tobytes(),
                "inner_label": np.ones(S3_P, np.int32).tobytes()})
        (rm_root / "train_files.txt").write_text(
            f"{rm_root / 'facade_train.tfrecord'}\n")
        rm_log = root / "log_ruemonge"
        reset_kernel_launches()
        t0 = time.perf_counter()
        train_scene_seg.main([
            "--dataset", "ruemonge2014", "--data_dir", str(rm_root),
            "--log_dir", str(rm_log), "--mode", "dense", "--batch_size",
            str(RM_B), "--max_epoch", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = -(-100 // RM_B)
        evals = -(-len(load_scene_blocks(
            read_list(rm_root / "test_files.txt"))) // RM_B)
        text = (rm_log / "log_train.txt").read_text()
        scalars = [json.loads(x) for x in
                   (rm_log / "metrics.jsonl").read_text().splitlines()]
        fit_runs["ruemonge_fit"] = fit_launches(
            kernel_launches(), text, steps, evals,
            f"cli.train_scene_seg --dataset ruemonge2014, 1 epoch of {steps}"
            f" steps and {evals} eval batch", PER_SEG_STEP, PER_SEG_FORWARD,
            PER_S3PE_STEP, PER_S3PE_FORWARD)
        print(f"cli.train_scene_seg --dataset ruemonge2014: 1 block x 100, "
              f"{wall:.2f} s host clock, {scalars[0]['ms_per_batch']:.2f} ms "
              f"a batch (its log line), train loss "
              f"{scalars[0]['train_loss']:.4f}, eval loss "
              f"{scalars[1]['eval_loss']:.4f}", flush=True)

        # 46. the scene evaluation and the re-merge: S3DIS areas 5 and 6,
        # RueMonge's facade, then the folds aggregated
        s3_root = root / "s3dis"
        s3_root.mkdir()
        for area in (5, 6):
            scene_set(s3_root, np.random.default_rng(460 + area), area)
        s3_log = root / "log_s3dis"
        s3_cfg = s3dis_config(fast=True, dense=True)
        snapshot_config(s3_log, s3_cfg)
        gen = torch.Generator().manual_seed(46)
        model = SPH3DSceneSeg(s3_cfg, generator=gen, in_columns=6)
        randomize_bn(model, gen)
        Checkpointer(s3_log).save(0, model)
        model = model.to(dev).eval()
        x = torch.from_numpy(scene_blocks(np.random.default_rng(462), EVAL_B,
                                          S3_N)[..., [0, 1, 2, 6, 7, 8]]
                             ).to(dev)
        res = Results()
        serve_replay(model, x, [], res, "S3DIS scene-eval forward")
        del model
        metric_files, evals_s3 = [], {}
        for area in (5, 6):
            reset_kernel_launches()
            t0 = time.perf_counter()
            out = evaluate_scene_seg.main([
                "--dataset", "s3dis", "--data_dir", str(s3_root),
                "--log_dir", str(s3_log), "--test_area", str(area),
                "--scene_dir", str(s3_root / "scenes"), "--save_blocks",
                "--batch_size", str(EVAL_B)])
            wall = time.perf_counter() - t0
            launches = kernel_launches()
            eval_launches(out, launches,
                          f"cli.evaluate_scene_seg s3dis area {area}")
            check_scene_eval(out, s3_log, s3_root / "scenes",
                             s3_log / f"Area_{area}_metric.npz", 13,
                             f"S3DIS area {area}")
            n_blocks = len(out["logits"])
            print(f"scene eval, S3DIS area {area}: {n_blocks} blocks in "
                  f"{out['forwards']} forwards of B={EVAL_B} "
                  f"({n_blocks / out['forwards']:.2f} blocks a forward), "
                  f"{wall:.2f} s host clock ({n_blocks / wall:.2f} blocks/s,"
                  f" the merge and the full-cloud projection included); "
                  f"merged OA {out['accumulator'].overall_accuracy:.4f}",
                  flush=True)
            evals_s3[area] = launches
            metric_files.append(str(s3_log / f"Area_{area}_metric.npz"))
            for f in (s3_log / "block_results").iterdir():
                f.unlink()
        runs["s3dis_scene_eval"] = (res, evals_s3[5])
        fit_runs["s3dis_scene_eval_cli"] = {
            k: evals_s3[5][k] + evals_s3[6][k] for k in evals_s3[5]}
        total = aggregate_folds.main(metric_files)
        folds = [SceneAccumulator.load(p) for p in metric_files]
        if total.merged_seen != sum(f.merged_seen for f in folds):
            raise AssertionError("aggregate_folds: counts do not add up")
        reset_kernel_launches()
        out = evaluate_scene_seg.main([
            "--dataset", "ruemonge2014", "--data_dir", str(rm_root),
            "--log_dir", str(rm_log), "--test_area", "0", "--scene_dir",
            str(rm_root / "scenes"), "--save_blocks", "--batch_size",
            str(EVAL_B)])
        launches = kernel_launches()
        eval_launches(out, launches, "cli.evaluate_scene_seg ruemonge2014")
        check_scene_eval(out, rm_log, rm_root / "scenes",
                         rm_log / "Area_0_metric.npz", 7, "RueMonge")
        fit_runs["ruemonge_scene_eval_cli"] = launches
    return fit_runs


def prep_fps_replay(calls: list, res: Results, what: str) -> None:
    """Every recorded K1 call of a ``prepare_modelnet`` run against the
    plain FPS, bitwise: the kernel replayed call by call (its span, CUDA
    events, median of 3; its device time in one profiler session; its
    bound). The plain version runs once over each (npoint, N) group's
    clouds stacked into one batch (its rows are independent, so each row
    is the plain version of that cloud) for the comparison, and is timed
    at B = 1 on the group's first cloud: the calls' own shape, and the
    plain loop's work does not depend on the points, so that time stands
    for each call of the group."""
    from sph3d_gcn_torch.ops import sample as S

    groups = collections.defaultdict(list)
    for i, (name, (npoint, cloud), _) in enumerate(calls):
        if name != "fps" or cloud.shape[0] != 1:
            raise AssertionError(f"{what}: recorded {name} {cloud.shape}")
        groups[(npoint, cloud.shape[1])].append(i)
    plain_out, plain_ms = {}, {}
    with torch.no_grad():
        for (npoint, n), idx in groups.items():
            out = S.farthest_point_sample_plain(
                npoint, torch.cat([calls[i][1][1] for i in idx]))
            first = calls[idx[0]][1][1]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            one = S.farthest_point_sample_plain(npoint, first)
            end.record()
            torch.cuda.synchronize()
            if not torch.equal(one, out[:1]):
                raise AssertionError(f"{what}: the plain FPS at B = 1 "
                                     f"differs from its stacked row")
            print(f"  plain FPS, {n} -> {npoint} points, B = 1: "
                  f"{start.elapsed_time(end):.1f} ms (CUDA events, one "
                  f"run; the group's {len(idx)} clouds stacked for the "
                  f"comparison)", flush=True)
            for j, i in enumerate(idx):
                plain_out[i] = out[j:j + 1]
                plain_ms[i] = start.elapsed_time(end)
        for i, (name, args, kw) in enumerate(calls):
            kern = functools.partial(S.farthest_point_sample_kernel, *args)
            steps = max(args[0] - 1, 1)
            ms = median_ms(kern, 3)
            res.add(name, describe(name, args, kw), kern(), plain_out[i], ms,
                    plain_ms[i], exact, work(name, args, kw))
            res.add_device(name, describe(name, args, kw), kern, None,
                           work(name, args, kw), steps)
    res.summary(what)


def read_all(paths: list[str], reader, verify_crc: bool
             ) -> tuple[list, float]:
    """Every record (or Example) of ``paths`` through ``reader``, and the
    seconds it took."""
    t0 = time.perf_counter()
    records = [r for p in paths for r in reader(p, verify_crc=verify_crc)]
    return records, time.perf_counter() - t0


def prep_phases(dev: torch.device, runs: dict) -> dict:
    """Phases 47-52 (see the module docstring): the datasets' raw files
    through the ``prepare_*`` entry points, the native reader, a model
    trained and a scene evaluated on the prepared data, and TF1 bundles
    into fresh models. Adds the ModelNet preparation's K1 replay to
    ``runs``; returns the launch counts of the entry points' runs."""
    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.cli import (
        evaluate_scene_seg,
        measure_windows,
        prepare_modelnet,
        prepare_ruemonge2014,
        prepare_s3dis,
        prepare_scannet,
        prepare_shapenet,
        read_list,
        train_modelnet,
    )
    from sph3d_gcn_torch.configs import modelnet_config, s3dis_config
    from sph3d_gcn_torch.data import raw_trees, tfrecord
    from sph3d_gcn_torch.data.datasets import (
        load_modelnet_records,
        load_scene_blocks,
        resample_indices,
    )
    from sph3d_gcn_torch.data.native_loader import (
        read_examples_native,
        read_records_native,
    )
    from sph3d_gcn_torch.data.synthetic import scene_blocks, surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg
    from sph3d_gcn_torch.train.checkpoint import Checkpointer, snapshot_config
    from sph3d_gcn_torch.train.eval import checked_forward, vote_classify
    from sph3d_gcn_torch.utils.checkpoint_convert import (
        convert_checkpoint,
        tf_variables,
    )
    from sph3d_gcn_torch.utils.tf1_bundle import write_bundle

    fit_runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        raw = root / "raw"

        # 47. raw trees in the datasets' published layouts
        t0 = time.perf_counter()
        sizes = [PREP_POINTS] * 9 + [N]             # every tenth at N
        raw_trees.write_modelnet_tree(
            str(raw / "modelnet"), np.random.default_rng(470),
            classes=PREP_CLASSES, train_per_class=PREP_TRAIN // len(
                PREP_CLASSES), test_per_class=PREP_TEST // len(PREP_CLASSES),
            points=sizes)
        raw_trees.write_s3dis_tree(str(raw / "s3dis"),
                                   np.random.default_rng(471),
                                   points=PREP_ROOM_POINTS)
        raw_trees.write_scannet_tree(str(raw / "scannet"),
                                     np.random.default_rng(472),
                                     points=PREP_SCENE_POINTS)
        raw_trees.write_shapenet_tree(
            str(raw / "shapenet"), np.random.default_rng(473),
            cats=(("Airplane", "02691156"), ("Chair", "03001627"),
                  ("Table", "04379243")), points=SN_POINTS)
        raw_trees.write_ruemonge_tree(str(raw / "ruemonge"),
                                      np.random.default_rng(474),
                                      points=PREP_FACADE_POINTS)
        size = sum(f.stat().st_size for f in raw.rglob("*") if f.is_file())
        print(f"raw trees: ModelNet40 {PREP_TRAIN} + {PREP_TEST} shapes "
              f"(36 of {PREP_POINTS} points, 4 of {N}), S3DIS 2 rooms of "
              f"{PREP_ROOM_POINTS} points, ScanNet 2 scenes of "
              f"{PREP_SCENE_POINTS}, ShapeNet 3 x 4 shapes of {SN_POINTS}, "
              f"RueMonge2014 {PREP_FACADE_POINTS} points: "
              f"{size / 2 ** 20:.1f} MiB written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        # 48. prepare_modelnet on the card: K1 on each raw shape, B = 1
        res = Results()
        store = {}
        for num_point in (N, 1024):
            store[num_point] = root / f"modelnet_{num_point}"
            reset_kernel_launches()
            t0 = time.perf_counter()
            with _build.record_calls() as calls:
                prepare_modelnet.main([
                    "--data_path", str(raw / "modelnet"), "--store_folder",
                    str(store[num_point]), "--num_point", str(num_point)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_launches()
            sampled = sum(s > num_point for s in
                          (sizes * 4)[:PREP_TRAIN + PREP_TEST])
            print(f"prepare_modelnet --num_point {num_point}: "
                  f"{PREP_TRAIN + PREP_TEST} shapes in {wall:.2f} s host "
                  f"clock ({wall / (PREP_TRAIN + PREP_TEST) * 1e3:.1f} ms a "
                  f"shape: text read, K1, normalization, record); launches "
                  f"{launches}", flush=True)
            if launches != {k: sampled if k == "fps" else 0
                            for k in launches}:
                raise AssertionError(f"prepare_modelnet: launches "
                                     f"{launches}, want {sampled} K1")
            print(f"per-kernel parity, prepare_modelnet --num_point "
                  f"{num_point}: each of its {len(calls)} K1 calls "
                  f"replayed", flush=True)
            prep_fps_replay(calls, res, f"prepare_modelnet --num_point "
                            f"{num_point}")
            fit_runs[f"modelnet_prep_{num_point}"] = launches
            del calls
        runs["modelnet_prep"] = (res, {
            k: sum(fit_runs[f"modelnet_prep_{p}"][k] for p in (N, 1024))
            for k in fit_runs[f"modelnet_prep_{N}"]})
        shapes = load_modelnet_records(read_list(store[N] / "train_files.txt"))
        if not all(s.xyz.shape == (N, 3) and np.isfinite(s.xyz).all()
                   for s in shapes) or len(shapes) != PREP_TRAIN:
            raise AssertionError("prepared ModelNet records")
        norms = np.linalg.norm(np.stack([s.xyz for s in shapes]), axis=-1)
        print(f"prepared ModelNet records: {len(shapes)} train shapes of "
              f"{N} points, largest norm {norms.max(-1).min():.6f}-"
              f"{norms.max(-1).max():.6f}", flush=True)

        # 49. the host preparations, and every record file read by both
        # readers
        store_of = {"s3dis": root / "s3dis", "scannet": root / "scannet",
                    "shapenet": root / "shapenet",
                    "ruemonge": root / "ruemonge"}
        for name, cli in (("s3dis", prepare_s3dis),
                          ("scannet", prepare_scannet),
                          ("shapenet", prepare_shapenet),
                          ("ruemonge", prepare_ruemonge2014)):
            t0 = time.perf_counter()
            cli.main(["--data_path", str(raw / name), "--store_folder",
                      str(store_of[name])])
            print(f"prepare_{name if name != 'ruemonge' else 'ruemonge2014'}"
                  f": {time.perf_counter() - t0:.2f} s host clock",
                  flush=True)
        blocks = (store_of["s3dis"] / "log_block.txt").read_text(
            ).splitlines()
        print(f"S3DIS blocks (area, room, inner points, stored points): "
              f"{blocks}", flush=True)
        files = sorted(str(p) for p in root.rglob("*.tfrecord"))
        size = sum(os.path.getsize(p) for p in files) / 2 ** 20
        print(f"record readers, {len(files)} files, {size:.1f} MiB (warm "
              f"page cache; crc32c of the Python reader by "
              f"{'numpy' if tfrecord._crc32c is tfrecord.crc32c else 'C'}):",
              flush=True)
        for what, readers, crc in (
                ("records, CRCs checked",
                 (read_records_native, tfrecord.read_records), True),
                ("records, no CRC",
                 (read_records_native, tfrecord.read_records), False),
                ("decoded Examples, no CRC (data.datasets' traffic)",
                 (read_examples_native, tfrecord.read_examples), False)):
            (native, native_s), (python, python_s) = (
                read_all(files, r, crc) for r in readers)
            print(f"  {what}: {len(native)}, native {native_s:.3f} s "
                  f"({size / native_s:.1f} MiB/s), Python {python_s:.3f} s "
                  f"({size / python_s:.1f} MiB/s)", flush=True)
            if what.startswith("records") and native != python:
                raise AssertionError("the native reader's records differ")
            del native, python

        # 50. cli.train_modelnet on the prepared records
        log = root / "log_modelnet"
        reset_kernel_launches()
        t0 = time.perf_counter()
        train_modelnet.main([
            "--data_dir", str(store[N]), "--log_dir", str(log), "--mode",
            "dense", "--family", "hard", "--batch_size", str(B),
            "--num_input", str(N), "--max_epoch", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps, evals = PREP_TRAIN // B, -(-PREP_TEST // B)
        text = (log / "log_train.txt").read_text()
        fit_runs["modelnet_prepared_fit"] = fit_launches(
            kernel_launches(), text, steps, evals,
            f"cli.train_modelnet on the prepared records, 1 epoch of "
            f"{steps} steps and {evals} eval batch")
        scalars = [json.loads(x) for x in
                   (log / "metrics.jsonl").read_text().splitlines()]
        if not (np.isfinite(scalars[0]["train_loss"])
                and np.isfinite(scalars[1]["eval_loss"])):
            raise AssertionError(f"non-finite loss: {scalars}")
        print(f"cli.train_modelnet on the prepared records: {wall:.2f} s "
              f"host clock, {scalars[0]['ms_per_batch']:.2f} ms a batch, "
              f"train loss {scalars[0]['train_loss']:.4f}, eval loss "
              f"{scalars[1]['eval_loss']:.4f}", flush=True)

        # 51. windows measured on the prepared area's blocks, then its
        # scene evaluation with them
        s3_default = s3dis_config(S3_N, fast=True, dense=True)
        test = load_scene_blocks(read_list(
            store_of["s3dis"] / "test_files_fold1.txt"))
        rng = np.random.default_rng(510)
        clouds = np.stack([
            blk.points[resample_indices(len(blk.label), S3_N, rng)]
            for blk in test for _ in range(PREP_WINDOW_DRAWS)])
        np.savez(root / "s3dis_area1.npz", points=clouds)
        t0 = time.perf_counter()
        windows, dec_windows, dec_margin, growth = measure_windows.main([
            "--dataset", "s3dis", "--num_input", str(S3_N), "--data",
            str(root / "s3dis_area1.npz")])
        print(f"windows measured on {len(clouds)} draws of {S3_N} points "
              f"from the prepared area 1's {len(test)} blocks in "
              f"{time.perf_counter() - t0:.2f} s: {windows} / decoder "
              f"{dec_windows} + {dec_margin}, growth {growth}, against "
              f"s3dis_config's {s3_default.windows} / "
              f"{s3_default.dec_windows} + {s3_default.dec_margin}, growth "
              f"{s3_default.growth_steps} (calibrated on uniform blocks)",
              flush=True)
        model = SPH3DSceneSeg(s3_default, generator=torch.Generator(
            ).manual_seed(510), in_columns=6).to(dev).eval()
        failed = []
        with torch.inference_mode():
            for i in range(0, PREP_DEFAULT_CLOUDS, EVAL_B):
                model(torch.as_tensor(clouds[i:i + EVAL_B],
                                      dtype=torch.float32, device=dev))
                failed.append(not bool(model.dense_ok))
        print(f"s3dis_config's windows on the prepared area 1: "
              f"{sum(failed)} of {len(failed)} forwards of B={EVAL_B} (the "
              f"first {PREP_DEFAULT_CLOUDS} draws) fail the certificate "
              f"(none re-run)", flush=True)
        del model
        s3_cfg = dataclasses.replace(
            s3_default, windows=windows, dec_windows=dec_windows,
            dec_margin=dec_margin, growth_steps=growth)
        s3_log = root / "log_s3dis"
        snapshot_config(s3_log, s3_cfg)
        gen = torch.Generator().manual_seed(51)
        model = SPH3DSceneSeg(s3_cfg, generator=gen, in_columns=6)
        randomize_bn(model, gen)
        Checkpointer(s3_log).save(0, model)
        del model, test, clouds
        reset_kernel_launches()
        t0 = time.perf_counter()
        out = evaluate_scene_seg.main([
            "--dataset", "s3dis", "--data_dir", str(store_of["s3dis"]),
            "--log_dir", str(s3_log), "--test_area", "1", "--scene_dir",
            str(store_of["s3dis"] / "scenes"), "--save_blocks",
            "--batch_size", str(EVAL_B)])
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        eval_launches(out, launches, "cli.evaluate_scene_seg on the "
                      "prepared S3DIS area 1")
        check_scene_eval(out, s3_log, store_of["s3dis"] / "scenes",
                         s3_log / "Area_1_metric.npz", 13,
                         "prepared S3DIS area 1")
        n_blocks = len(out["logits"])
        print(f"scene eval, prepared S3DIS area 1, the measured windows: "
              f"{n_blocks} blocks in "
              f"{out['forwards']} forwards of B={EVAL_B}, {wall:.2f} s host "
              f"clock ({n_blocks / wall:.2f} blocks/s, the merge and the "
              f"full-cloud projection included); merged OA "
              f"{out['accumulator'].overall_accuracy:.4f}", flush=True)
        fit_runs["s3dis_prepared_scene_eval_cli"] = launches

        # 52. TF1 bundles at full width into fresh models on the card
        gen = torch.Generator().manual_seed(52)
        mn_cfg = modelnet_config(N, fast=True, dense=True, family="hard")
        pairs = []
        for name, make in (
                ("SPH3DModelNet",
                 lambda g=None: SPH3DModelNet(mn_cfg, generator=g)),
                ("SPH3DSceneSeg",
                 lambda g=None: SPH3DSceneSeg(s3_default, generator=g))):
            source = make(gen)
            randomize_bn(source, gen)
            source = source.to(dev).eval()
            prefix = str(root / "tf1" / name / "model.ckpt-250")
            t0 = time.perf_counter()
            write_bundle(prefix, tf_variables(source.state_dict()))
            write_s = time.perf_counter() - t0
            fresh = make().to(dev).eval()
            t0 = time.perf_counter()
            fresh.load_state_dict(convert_checkpoint(fresh, prefix))
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
            size = sum(p.stat().st_size for p in Path(prefix).parent.iterdir())
            print(f"TF1 bundle of a seeded {name} at full width "
                  f"({len(fresh.state_dict())} variables, "
                  f"{size / 2 ** 20:.2f} MiB): written in {write_s:.3f} s, "
                  f"read and loaded into a fresh model on the card in "
                  f"{read_s:.3f} s", flush=True)
            pairs.append((source, fresh))
        (mn_src, mn_new), (s3_src, s3_new) = pairs
        clouds = surface_clouds(np.random.default_rng(520), B, N)
        votes = [vote_classify(checked_forward(m, dev), clouds, VOTES,
                               np.random.default_rng(521))
                 for m in (mn_src, mn_new)]
        x = torch.from_numpy(scene_blocks(np.random.default_rng(522), S3_B,
                                          S3_N)).to(dev)
        with torch.inference_mode():
            seg = [m(x) for m in (s3_src, s3_new)]
        ok = [bool(m.dense_ok) for m in (s3_src, s3_new)]
        same = (np.array_equal(*votes), torch.equal(*seg))
        print(f"TF1-loaded models against their sources: ModelNet "
              f"hard-window votes ({VOTES} votes of B={B}) bitwise equal "
              f"{same[0]}; S3DIS serving forward (B={S3_B}, N={S3_N}, "
              f"dense_ok {ok}) bitwise equal {same[1]}", flush=True)
        if not (all(same) and all(ok)):
            raise AssertionError("a TF1-loaded model's logits differ")
    return fit_runs


HOST_THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


@contextlib.contextmanager
def host_pool(workers: int):
    """A pool of ``workers`` spawned processes for the host side of
    phases 53-55 (CPU queries, NumPy oracles), which runs beside phases
    11-52 on the card, after the main path's timed phases 3-10; each
    process's BLAS and torch take 2 threads. Every job is submitted
    inside the block that opens it; on leaving, the pool waits for its
    processes (a failure cancels what has not started)."""
    import concurrent.futures
    import multiprocessing

    saved = {k: os.environ.get(k) for k in HOST_THREADS}
    os.environ.update({k: "2" for k in HOST_THREADS})
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        yield pool
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        pool.shutdown(wait=True, cancel_futures=True)


def host_job(fn, *args) -> tuple:
    """A pool job: ``fn(*args)`` and the host clock (``perf_counter``, one
    clock for every process) at its start and end."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, t0, time.perf_counter()


def cpu_queries(x: torch.Tensor, q: torch.Tensor) -> tuple:
    """Phase 53's queries on the CPU (a pool job): the cube query and the
    dilated sphere query with bins, and their seconds."""
    from sph3d_gcn_torch.ops import build_cube_neighbor
    from sph3d_gcn_torch.ops.neighbor import build_sphere_neighbor_and_bins

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    cube = build_cube_neighbor(x, q, **CUBE_QUERY)
    t1 = time.perf_counter()
    nbh, bins = build_sphere_neighbor_and_bins(x, q, **DILATED_QUERY)
    return tuple(cube), tuple(nbh) + (bins,), t1 - t0, \
        time.perf_counter() - t1


def numpy_oracle(cfg, variables: dict, points: np.ndarray
                 ) -> tuple[np.ndarray, float]:
    """The NumPy oracle's logits (a pool job) and its seconds."""
    from sph3d_gcn_torch.cli.parity_check import oracle_forward

    t0 = time.perf_counter()
    ref = oracle_forward(cfg, variables, points)
    return ref, time.perf_counter() - t0


def windows_cover(cfg, reqs) -> bool:
    """Whether ``cfg``'s windows hold every measured requirement (the
    decoders' only where the model has a decoder)."""
    decoder = cfg.global_channels is None
    for lv, r in enumerate(reqs):
        if r.enc > cfg.enc_window(lv) or r.pool > cfg.pool_window(lv):
            return False
        if decoder and (r.dec > cfg.dec_window(lv)
                        or r.dec_inter > cfg.dec_window(lv) + cfg.dec_margin
                        or r.growth > cfg.growth_steps):
            return False
    return True


def exact_in_range(x: torch.Tensor, q: torch.Tensor, idx: torch.Tensor,
                   count: torch.Tensor, radius: float) -> None:
    """A sphere query's rows against exact (f64) distances on the card:
    every row keeps at least its query's own point, no point twice, no
    point past ``THRESHOLD_BAND`` beyond the in-range threshold ``radius -
    1e-6``, and no point inside it by more than the band that comes
    before the row's last kept point (or anywhere, in a row that is not
    full)."""
    batch, num_q, k = idx.shape
    thr = radius - 1e-6
    cols = torch.arange(x.shape[1], device=x.device)
    x64 = x[..., :3].double()
    if int(count.min()) < 1:
        raise AssertionError("a dilated query's row kept no point")
    tile = 125
    for s in range(0, num_q, tile):
        d = torch.cdist(q[:, s:s + tile, :3].double(), x64,
                        compute_mode="donot_use_mm_for_euclid_dist")
        n = count[:, s:s + tile]
        valid = torch.arange(k, device=x.device) < n[..., None]
        kept = torch.zeros(d.shape, dtype=torch.int32, device=x.device)
        kept.scatter_add_(2, idx[:, s:s + tile], valid.int())
        last = idx[:, s:s + tile].gather(2, (n - 1)[..., None])
        reach = (cols <= last) | (n < k)[..., None]
        if int(kept.max()) > 1:
            raise AssertionError("a dilated query's row keeps a point twice")
        if bool(((kept > 0) & (d >= thr + THRESHOLD_BAND)).any()):
            raise AssertionError("the dilated query keeps a point out of "
                                 f"range of {radius}")
        if bool(((kept == 0) & (d < thr - THRESHOLD_BAND) & reach).any()):
            raise AssertionError("the dilated query skips a point in range "
                                 f"of {radius}")


def query_phase(dev: torch.device, smi: str) -> tuple:
    """Phase 53, the card's side: the cube query and the dilated sphere
    query at ModelNet level-0 scale (queries the FPS sample of each
    cloud), timed; the dilated query equal to the undilated one at the
    product radius and held against exact distances. Returns the inputs
    of the CPU's calls, the card's results and its launches, which
    :func:`finish_host_phases` compares."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models.common import normalize_unit_sphere
    from sph3d_gcn_torch.nn.graph import gather_points
    from sph3d_gcn_torch.ops import build_cube_neighbor
    from sph3d_gcn_torch.ops.neighbor import build_sphere_neighbor_and_bins
    from sph3d_gcn_torch.ops.sample import farthest_point_sample

    x = normalize_unit_sphere(torch.from_numpy(
        surface_clouds(np.random.default_rng(530), B, N)).to(dev))
    reset_kernel_launches()
    q = gather_points(x, farthest_point_sample(QUERY_M, x))
    cube = build_cube_neighbor(x, q, **CUBE_QUERY)
    nbh, bins = build_sphere_neighbor_and_bins(x, q, **DILATED_QUERY)
    radius = DILATED_QUERY["dilation_rate"] * DILATED_QUERY["radius"]
    undilated = dict(DILATED_QUERY, dilation_rate=None, radius=radius)
    nbh2, bins2 = build_sphere_neighbor_and_bins(x, q, **undilated)
    launches = {k: v for k, v in kernel_launches().items() if v}
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(tuple(nbh) + (bins,),
                                                 tuple(nbh2) + (bins2,))):
        raise AssertionError("the dilated query differs from the "
                             "undilated one at the product radius")
    exact_in_range(x, q, nbh.idx, nbh.count, radius)
    cube_ms = median_ms(lambda: build_cube_neighbor(x, q, **CUBE_QUERY))
    dil_ms = median_ms(lambda: build_sphere_neighbor_and_bins(
        x, q, **DILATED_QUERY))
    counts = cube.count.float()
    print(f"53. cube query (edge {CUBE_QUERY['length']}, grid "
          f"{CUBE_QUERY['gridsize']}, K={CUBE_QUERY['nn_sample']}) at B={B} "
          f"N={N} M={QUERY_M}: {cube_ms:.3f} ms (CUDA events, median of "
          f"{REPS}), count mean {counts.mean().item():.2f} max "
          f"{int(counts.max().item())}, {len(cube.bin.unique())} bins "
          f"used; dilated sphere query + bins (radius "
          f"{DILATED_QUERY['radius']} x {DILATED_QUERY['dilation_rate']}, "
          f"K={DILATED_QUERY['nn_sample']}): {dil_ms:.3f} ms, count mean "
          f"{nbh.count.float().mean().item():.2f}; equal to the undilated "
          f"query at radius {radius}; against exact (f64) distances, no "
          f"point kept out of range or skipped in range past "
          f"{THRESHOLD_BAND:g} of the threshold; launches {launches} (the "
          f"queries' FPS); {smi}", flush=True)
    card = (tuple(t.cpu() for t in cube),
            tuple(t.cpu() for t in tuple(nbh) + (bins,)))
    return (x.cpu(), q.cpu()), card, launches, (cube_ms, dil_ms)


def dense_oracle_phase(dev: torch.device, family: str) -> tuple:
    """Phases 54 (ModelNet) and 55 (S3DIS), the card's side: the dense
    engine's f32 config at B=1 on the JAX parity script's first cloud,
    sorted beforehand so that the model's own sort is the identity; its
    windows measured on the cloud and widened where they do not cover
    it; the seeded model calibrated (``cli.parity_check``) and run once,
    ``dense_ok`` True, the launches counted. Returns the NumPy oracle's
    arguments, the card's logits and the launches."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.cli.parity_check import (
        CALIBRATION_CLOUDS,
        calibrate_batch_norm,
        seeded_model,
        synthetic_points,
    )
    from sph3d_gcn_torch.configs import modelnet_config, s3dis_config
    from sph3d_gcn_torch.models.common import normalize_unit_sphere
    from sph3d_gcn_torch.ops.locality import permute_points, spatial_sort
    from sph3d_gcn_torch.utils.convert import flax_tree_from_torch
    from sph3d_gcn_torch.utils.windows import (
        derive_config_windows,
        measure_requirements,
    )

    modelnet = family == "modelnet"
    factory = modelnet_config if modelnet else s3dis_config
    cfg = dataclasses.replace(factory(fast=True, dense=True),
                              compute_dtype="float32")
    n = cfg.num_input
    rng = np.random.default_rng(0)
    points = torch.from_numpy(synthetic_points(family, rng, 1, n)).to(dev)
    calibration = synthetic_points(family, rng, CALIBRATION_CLOUDS, n)
    perm, _ = spatial_sort(points, cfg.radius[0])
    points = permute_points(points, perm)
    again, _ = spatial_sort(points, cfg.radius[0])
    if not torch.equal(again, torch.arange(n, device=dev).expand(1, n)):
        raise AssertionError(f"{family}: the model's sort of the sorted "
                             f"cloud is not the identity")
    t0 = time.perf_counter()
    reqs = measure_requirements(
        cfg, points.cpu().numpy(), device=dev,
        normalize=normalize_unit_sphere if modelnet else None)
    covered = windows_cover(cfg, reqs)
    text = (f"config windows {cfg.windows} dec {cfg.dec_windows} margin "
            f"{cfg.dec_margin} growth {cfg.growth_steps}; measured on the "
            f"cloud in {time.perf_counter() - t0:.2f} s: " + "; ".join(
                f"level {lv}: enc {r.enc} pool {r.pool}" + (
                    "" if modelnet else f" dec {r.dec} dec_inter "
                    f"{r.dec_inter} growth {r.growth}")
                for lv, r in enumerate(reqs)))
    if not covered:
        win, dec_win, margin, growth = derive_config_windows(cfg, reqs)
        cfg = dataclasses.replace(cfg, windows=win, dec_windows=dec_win,
                                  dec_margin=margin, growth_steps=growth)
        text += (f"; the config's do not cover it: derived windows {win} "
                 f"dec {dec_win} margin {margin} growth {growth}")
    model = seeded_model(cfg).to(dev)
    calibrate_batch_norm(model, torch.from_numpy(calibration).to(dev))
    torch.cuda.synchronize()
    reset_kernel_launches()
    with torch.no_grad():
        logits = model(points)
    launches = kernel_launches()
    if not bool(model.dense_ok):
        raise AssertionError(f"{family} oracle forward: dense_ok False")
    want = PER_FORWARD if modelnet else PER_SEG_FORWARD
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{family} oracle forward launches {got}, "
                             f"want {want}")
    phase = 54 if modelnet else 55
    print(f"{phase}. {family} dense engine in f32 at B=1 N={n}: {text}; "
          f"dense_ok True, launches {got}", flush=True)
    oracle = (cfg, flax_tree_from_torch(model.state_dict()),
              points.cpu().numpy())
    return oracle, logits.float().cpu().numpy(), launches


def submit_host_jobs(pool, cards: dict) -> dict:
    """The host side of phases 53-55 into ``pool``: the CPU's queries on
    the card's inputs and the oracles on the card's weights."""
    inputs = cards["queries"][0]
    jobs = {"queries": pool.submit(host_job, cpu_queries, *inputs)}
    for family in ("modelnet", "s3dis"):
        jobs[family] = pool.submit(host_job, numpy_oracle,
                                   *cards[family][0])
    return jobs


def hold_against_cpu(card: tuple, cpu: tuple, x: torch.Tensor,
                     q: torch.Tensor, radius: float) -> str:
    """The card's dilated query (idx, count, dist, bins) against the
    CPU's: their in-range tests' matmul forms round differently, so at
    most ``ROW_SHARE`` of the rows may differ, each first at a point that
    one device keeps and the other does not, within ``THRESHOLD_BAND`` of
    the threshold ``radius - 1e-6`` in exact distances; the entries both
    keep have the same bins and distances within ``DIST_TOL``."""
    idx, count, dist, bins = card
    cidx, ccount, cdist, cbins = cpu
    k = idx.shape[-1]
    valid = torch.arange(k) < count[..., None]
    cvalid = torch.arange(k) < ccount[..., None]
    differ = (idx != cidx) | (valid != cvalid)
    rows = differ.any(-1)
    both = valid & cvalid & ~differ
    share = rows.float().mean().item()
    if share > ROW_SHARE:
        raise AssertionError(f"the dilated query: {int(rows.sum())} rows "
                             f"differ from the CPU's")
    if not torch.equal(bins[both], cbins[both]):
        raise AssertionError("the dilated query: bins of entries both "
                             "devices keep differ from the CPU's")
    dist_err = (dist[both] - cdist[both]).abs().max().item()
    if dist_err > DIST_TOL:
        raise AssertionError(f"the dilated query: distances of entries "
                             f"both devices keep differ by {dist_err:.3g}")
    b, m = rows.nonzero(as_tuple=True)
    j = differ[b, m].int().argmax(-1)
    far = x.shape[1]
    first = torch.minimum(
        torch.where(valid[b, m, j], idx[b, m, j], far),
        torch.where(cvalid[b, m, j], cidx[b, m, j], far))
    d = (x[b, first, :3].double() - q[b, m, :3].double()).norm(dim=-1)
    off = (d - (radius - 1e-6)).abs()
    if off.numel() and off.max().item() >= THRESHOLD_BAND:
        raise AssertionError(f"the dilated query: a row differs from the "
                             f"CPU's at a point {off.max().item():.3g} "
                             f"from the threshold")
    return (f"{int(rows.sum())} of {rows.numel()} rows differ ({share:.2g}, "
            f"bound {ROW_SHARE:g}; entries differing in idx, count, dist, "
            f"bins {[int((a != c).sum()) for a, c in zip(card, cpu)]}), "
            f"each first at a point "
            f"{off.max().item() if off.numel() else 0.0:.3g} or less from "
            f"the threshold (bound {THRESHOLD_BAND:g}); entries both keep: "
            f"bins equal, distances within {dist_err:.3g}")


def finish_host_phases(cards: dict, jobs: dict, start: float) -> None:
    """Phases 53-55, the host's side: the CPU's queries against the
    card's (the cube query bitwise; the dilated query by
    :func:`hold_against_cpu`), each oracle's logits against the card's at
    rtol = atol = ``ORACLE_TOL``; the jobs' times on the script's
    clock."""
    from sph3d_gcn_torch.cli.parity_check import compare_logits

    (x, q), (cube, dilated), _, _ = cards["queries"]
    (cpu_cube, cpu_dilated, cube_s, dil_s), t0, t1 = jobs["queries"].result()
    spans = [f"queries {t0 - start:.1f}-{t1 - start:.1f} s"]
    if not all(torch.equal(a, b) for a, b in zip(cube, cpu_cube)):
        raise AssertionError("the card's cube query differs from the CPU's")
    radius = DILATED_QUERY["dilation_rate"] * DILATED_QUERY["radius"]
    text = hold_against_cpu(dilated, cpu_dilated, x, q, radius)
    print(f"53. the cube query's idx, bin and count equal to the CPU's, "
          f"bit for bit (CPU {cube_s:.1f} s at 2 threads); the dilated "
          f"query against the CPU's (CPU {dil_s:.1f} s): {text}",
          flush=True)
    for family, phase in (("modelnet", 54), ("s3dis", 55)):
        _, logits, _ = cards[family]
        (ref, seconds), t0, t1 = jobs[family].result()
        spans.append(f"{family} oracle {t0 - start:.1f}-{t1 - start:.1f} s")
        print(f"{phase}. {family} dense engine (f32, B=1) against the NumPy "
              f"oracle ({seconds:.1f} s on the host):", flush=True)
        out = compare_logits(logits, ref, ORACLE_TOL, ORACLE_TOL,
                             f"{family}, dense f32, oracle")
        if not out["ok"]:
            raise AssertionError(f"{family}: the dense engine's logits "
                                 f"differ from the oracle's")
    print(f"host jobs on the script's clock: {'; '.join(spans)}",
          flush=True)


def cli_oracle_phase() -> dict[str, int]:
    """Phase 56: ``cli.parity_check`` on its default config in this
    process, after every timed phase; returns its kernel launches."""
    import io

    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.cli import parity_check

    buf = io.StringIO()
    reset_kernel_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            parity_check.main(ORACLE_CLI)
            rc = 0
        except SystemExit as e:
            rc = e.code
    launches = {k: v for k, v in kernel_launches().items() if v}
    text = buf.getvalue()
    print(f"56. cli.parity_check {' '.join(ORACLE_CLI)} "
          f"({time.perf_counter() - t0:.1f} s; launches {launches}):",
          flush=True)
    print(text, end="", flush=True)
    if rc != 0 or "PASS" not in text:
        raise AssertionError(f"cli.parity_check exited {rc}")
    return launches


def dp_problems(dev: torch.device, sizes: dict) -> dict:
    """Phase 58's two steps, built from seeds on the host alike in every
    process at ``sizes`` (name -> global batch and points): name -> (step
    factory builder, global host batch, launches a step). f32
    activations: the ranks' step is held to the one-process step by a
    tight gate."""
    from sph3d_gcn_torch.configs import modelnet_config, s3dis_config
    from sph3d_gcn_torch.data.synthetic import scene_blocks, surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg
    from sph3d_gcn_torch.train.schedule import make_optimizer
    from sph3d_gcn_torch.train.steps import (
        classification_step_factory,
        segmentation_step_factory,
    )

    mn_cfg = dataclasses.replace(modelnet_config(fast=True, dense=True),
                                 compute_dtype="float32")
    s3_cfg = dataclasses.replace(s3dis_config(fast=True, dense=True),
                                 compute_dtype="float32")
    (mn_b, mn_n), (s3_b, s3_n) = sizes["modelnet"], sizes["s3dis"]
    rng = np.random.default_rng(57)
    mn_batch = {"points": surface_clouds(rng, mn_b, mn_n),
                "label": rng.integers(0, mn_cfg.num_cls, mn_b)}
    rng = np.random.default_rng(58)
    s3_batch = {"points": scene_blocks(rng, s3_b, s3_n),
                "label": rng.integers(0, s3_cfg.num_cls, (s3_b, s3_n)),
                "inner_label": rng.integers(0, 2, (s3_b, s3_n))
                .astype(np.int32)}

    def modelnet(group):
        model = SPH3DModelNet(mn_cfg, generator=torch.Generator()
                              .manual_seed(57)).to(dev)
        return classification_step_factory(
            model, *make_optimizer(model.parameters(), "adam", 1e-3),
            weight_decay=mn_cfg.weight_decay, group=group)

    def s3dis(group, points=None, dtype="float32"):
        cfg = dataclasses.replace(
            s3_cfg, compute_dtype=dtype,
            point_axis=None if points is None else "points")
        model = SPH3DSceneSeg(cfg, generator=torch.Generator()
                              .manual_seed(58)).to(dev)
        return segmentation_step_factory(
            model, *make_optimizer(model.parameters(), "adam", SP_LR),
            inner_masked=True, group=group, points=points)

    return {"modelnet": (modelnet, mn_batch, PER_STEP),
            "s3dis": (s3dis, s3_batch, PER_SEG_STEP)}


def dp_warm_up(factory, batch: dict, dev: torch.device) -> dict:
    """One step on ``batch`` (host arrays) without the update, the model
    put back as it was; returns the batch on ``dev``."""
    dev_batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in batch.items()}
    model = factory.model
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    factory.loss_and_grads(dev_batch,
                           torch.Generator(device=dev).manual_seed(59))
    model.load_state_dict(state0)
    return dev_batch


def dp_step(factory, batch: dict, dev: torch.device,
            update: bool = False) -> dict:
    """One step's loss, data loss, certificates, gradients and BN running
    statistics (host tensors), after a warm-up step from the same state;
    the step's launches and its ms on the host clock (synchronised). With
    ``update`` also its logits and the parameters after the optimizer's
    update (timed with it); without, no update."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches

    dev_batch = dp_warm_up(factory, batch, dev)
    model = factory.model
    gen = torch.Generator(device=dev).manual_seed(59)
    sync(dev)
    reset_kernel_launches()
    t0 = time.perf_counter()
    metrics = factory.loss_and_grads(dev_batch, gen)
    if update:
        factory.optimizer.step()
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches = kernel_launches()
    out = {"loss": metrics["loss"].item(),
           "data_loss": metrics["data_loss"].item(),
           "dense_ok": bool(metrics["dense_ok"]),
           "halo_ok": bool(metrics["halo_ok"]), "ms": ms,
           "launches": launches,
           "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
           "stats": {k: v.cpu() for k, v in model.state_dict().items()
                     if k.endswith((".mean", ".var"))}}
    if update:
        out["logits"] = metrics["logits"].cpu()
        out["params"] = {k: p.detach().cpu()
                         for k, p in model.named_parameters()}
    return out


def sp_prepare(group, dev: torch.device) -> dict:
    """The first half of phase 58's point-sharded S3DIS step on one of the
    two ranks, before the main process's go: the ranks form one point
    group, and every kernel-wrapped call of one sharded step (the rank's
    first, which also warms it) is recorded and held against its plain
    version on the same operands (the replay's lines come back as text).
    Returns what :func:`sp_measure` takes on."""
    import contextlib
    import io

    from sph3d_gcn_torch import _build
    from sph3d_gcn_torch.parallel import shard_batch, split_groups
    from sph3d_gcn_torch.parallel import spatial

    data, points = split_groups(group, SP_POINTS)
    build, batch, _ = dp_problems(dev, DP_SIZES)["s3dis"]
    factory = build(None, points)
    levels = [n for n in (batch["points"].shape[1],)
              + factory.model.config.num_sample
              if spatial.shardable_rows(n, points.size)]
    if tuple(levels) != SP_SHARDED_ROWS:
        raise AssertionError(f"sharded levels {levels}, want "
                             f"{SP_SHARDED_ROWS}")
    rows = shard_batch(batch, data)
    dev_batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in rows.items()}
    state0 = {k: v.clone() for k, v in factory.model.state_dict().items()}
    with _build.record_calls() as calls:
        factory.loss_and_grads(dev_batch,
                               torch.Generator(device=dev).manual_seed(59))
    factory.model.load_state_dict(state0)
    res, text = Results(), io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            replay(calls, res, PER_SEG_STEP, plain_reps=1, reps=1,
                   device=False, checks=dict.fromkeys(SP_CHECKS, sums_close))
    except AssertionError as e:
        raise AssertionError(f"point rank {points.rank}: {e}; its replay "
                             f"so far:\n{text.getvalue()}") from e
    del calls, state0
    torch.cuda.empty_cache()
    return {"build": build, "factory": factory, "rows": rows,
            "dev_batch": dev_batch, "points": points,
            "held": {name: (res.calls[name], res.err[name])
                     for name in res.calls},
            "replay": text.getvalue()}


def sp_measure(prep: dict, dev: torch.device) -> dict:
    """The second half, after the data-parallel steps: the sharded step
    against the one-process step (:func:`dp_step` with the update;
    launches, ms), SP_TIMED more steps with the halo exchanges' rows,
    bytes and host ms, and one bf16 step, whose loss and logits must be
    finite."""
    from sph3d_gcn_torch.parallel import spatial

    factory, dev_batch = prep["factory"], prep["dev_batch"]
    out = dp_step(factory, prep["rows"], dev, update=True)
    spatial.reset_halo_stats()
    times = []
    gen = torch.Generator(device=dev).manual_seed(60)
    for _ in range(SP_TIMED):
        sync(dev)
        t0 = time.perf_counter()
        factory.train_step(dev_batch, gen)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    out["timed"] = times
    out["halo"] = spatial.halo_stats()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del factory, prep["factory"]
    torch.cuda.empty_cache()
    points = prep["points"]
    bf16 = prep["build"](None, points, "bfloat16")
    m = bf16.train_step(dev_batch, torch.Generator(device=dev)
                        .manual_seed(61))
    out["bf16"] = {"loss": m["loss"].item(),
                   "finite": bool(torch.isfinite(m["logits"]).all()),
                   "dense_ok": bool(m["dense_ok"]),
                   "halo_ok": bool(m["halo_ok"])}
    out["replay"], out["held"] = prep["replay"], prep["held"]
    out["points"] = (points.rank, points.size, points.backend)
    del bf16
    torch.cuda.empty_cache()
    return out


def sp_hold(name: str, got: dict, ref: dict) -> None:
    """Phase 58's gate on a point-sharded step: :func:`dp_hold`'s (loss,
    gradients, BN statistics, dense_ok), the halo certificate, the
    gathered logits within SP_LOGIT_TOL of their largest magnitude and
    the Adam update (SP_RESOLVED, SP_UNRESOLVED)."""
    dp_hold(name, got, ref)
    scale = ref["logits"].abs().max().item()
    logit_err = (got["logits"] - ref["logits"]).abs().max().item()
    unresolved = entries = 0
    worst = 0.0
    for k, want in ref["params"].items():
        g, r = got["grads"][k], ref["grads"][k]
        loose = (g - r).abs() > SP_RESOLVED * torch.minimum(g.abs(),
                                                           r.abs())
        err = (got["params"][k] - want).abs()
        worst = max(worst, err[~loose].max().item() if (~loose).any()
                    else 0.0)
        unresolved += int(loose.sum())
        entries += loose.numel()
    bound = SP_LR * SP_RESOLVED / 4 + 1e-7
    print(f"  {name}: halo_ok {got['halo_ok']}; logits max abs err "
          f"{logit_err:.3g} of |logits| <= {scale:.3g} (tolerance "
          f"{SP_LOGIT_TOL:g} of that); Adam update: {unresolved} of "
          f"{entries} entries with gradients not within {SP_RESOLVED:g} "
          f"of each other (tolerance {SP_UNRESOLVED:g} of them), the "
          f"others' parameters within {worst:.3g} (tolerance {bound:.3g})",
          flush=True)
    if (not got["halo_ok"] or not logit_err <= SP_LOGIT_TOL * scale
            or not worst <= bound
            or not unresolved <= SP_UNRESOLVED * entries):
        raise AssertionError(f"{name}: the point-sharded step is not the "
                             f"one-process step")


def sync(dev: torch.device) -> None:
    """Wait for ``dev``'s work (the CPU's is done on return)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_rank(group, go: str, timeout: float, sizes: dict) -> dict:
    """Phase 58 on one of two ranks sharing the card over gloo: build both
    steps' batches, check each collective the steps use on CUDA tensors,
    build both steps and run each once, wait for the main process's
    ``go`` file, then run this rank's rows of each global batch."""
    from sph3d_gcn_torch.parallel import shard_batch

    dev = group.device
    problems = dp_problems(dev, sizes)
    x = torch.full((3,), float(group.rank + 1), device=dev)
    checks = {
        "all_reduce": group.all_reduce_(x.clone()).tolist(),
        "all_gather": group.all_gather_rows(x[None]).tolist(),
        "sum_floats": group.sum_floats(1.0, 2.0 * group.rank)}
    want = {"all_reduce": [3.0] * 3, "all_gather": [[1.0] * 3, [2.0] * 3],
            "sum_floats": [2.0, 2.0]}
    if checks != want:
        raise AssertionError(f"gloo collectives on {dev}: {checks}")
    factories = {name: build(group)
                 for name, (build, _, _) in problems.items()}
    # a process's first step loads and warms everything (seconds): here,
    # beside phase 56, not in the timed run after the go
    for name, (_, batch, _) in problems.items():
        dp_warm_up(factories[name], shard_batch(batch, group), dev)
        torch.cuda.empty_cache()
    # the point-sharded step's replay, held before anything is timed
    sp = sp_prepare(group, dev)
    deadline = time.monotonic() + timeout
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError("no go from the main process")
        time.sleep(0.05)
    group.barrier()
    out = {"checks": checks, "device": str(dev), "clock": []}
    for name, (_, batch, _) in problems.items():
        out[name] = dp_step(factories.pop(name), shard_batch(batch, group),
                            dev)
        out["clock"].append(time.time())
        torch.cuda.empty_cache()
    out["sp"] = sp_measure(sp, dev)
    out["clock"].append(time.time())
    return out


def dp_hold(name: str, got: dict, ref: dict) -> float:
    """Phase 58's gate: a rank's step against the one-process step on the
    global batch. Returns the largest of the measured errors; raises past
    the tolerances (``DP_LOSS_TOL`` relative; each gradient leaf's L2
    error within ``DP_GRAD_TOL`` of the larger of its norm and the median
    leaf's; each BN statistic within ``DP_STATS_TOL`` absolute)."""
    loss = max(abs(got[k] - ref[k]) / abs(ref[k])
               for k in ("loss", "data_loss"))
    med = float(np.median([v.norm().item() for v in ref["grads"].values()]))
    grads = leaf_errors(got["grads"], ref["grads"], med)
    stats = {k: (got["stats"][k] - v).abs().max().item()
             for k, v in ref["stats"].items()}
    worst = max(grads, key=grads.get)
    print(f"  {name}: loss {got['loss']:.6f} vs {ref['loss']:.6f} "
          f"(relative {loss:.3g}, tolerance {DP_LOSS_TOL:g}); gradient "
          f"leaves max {grads[worst]:.3g} ({worst}) / median "
          f"{float(np.median(list(grads.values()))):.3g} of the larger of "
          f"their norm and the median leaf's (tolerance {DP_GRAD_TOL:g}); "
          f"BN statistics max abs {max(stats.values()):.3g} "
          f"(tolerance {DP_STATS_TOL:g}); dense_ok {got['dense_ok']}",
          flush=True)
    if (not loss <= DP_LOSS_TOL or not grads[worst] <= DP_GRAD_TOL
            or not max(stats.values()) <= DP_STATS_TOL
            or not got["dense_ok"]):
        raise AssertionError(f"{name}: the ranks' step is not the "
                             f"one-process step")
    return max(loss, grads[worst], max(stats.values()))


def world_one_phase(dev: torch.device) -> tuple[dict[str, int], object]:
    """Phase 57: the served ModelNet dense step (bf16, B=16, N=10000) in a
    world-1 NCCL group, three steps against three plain single-process
    kernel steps from the same state and dropout seeds, bitwise (loss,
    certificate, every gradient, the final parameters and statistics).
    Returns the grouped run's launches and a function that times steps
    alternately with and without the group (the collectives' cost) and
    then leaves the group: it runs once phase 58's ranks are done, whose
    start would take this host's cores from the timed steps."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.parallel import (
        close_data_parallel,
        init_data_parallel,
    )
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import classification_step_factory

    group = init_data_parallel(dev, "nccl", rank=0, world_size=1,
                               store=torch.distributed.HashStore())
    x = torch.arange(3.0, device=dev)
    nccl = {"all_reduce": group.all_reduce_(x.clone()).tolist(),
            "all_gather": group.all_gather_rows(x[None]).tolist()}
    if nccl != {"all_reduce": [0.0, 1.0, 2.0],
                "all_gather": [[0.0, 1.0, 2.0]]}:
        raise AssertionError(f"NCCL collectives on {dev}: {nccl}")
    cfg = modelnet_config(fast=True, dense=True)
    model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(1))
    model = model.to(dev)
    rng = np.random.default_rng(1)
    batch = {
        "points": torch.from_numpy(surface_clouds(rng, B, N)).to(dev),
        "label": torch.from_numpy(
            rng.integers(0, cfg.num_cls, (B,)).astype(np.int64)).to(dev),
    }
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def factory(g):
        return classification_step_factory(
            model, *make_optimizer(model.parameters(), "adam",
                                   exponential_decay_lr(0.001, B)),
            weight_decay=cfg.weight_decay, group=g)

    def run(g) -> tuple[list, dict]:
        model.load_state_dict(state0)
        step, out = factory(g), []
        for i in range(DP_STEPS):
            m = step.train_step(batch, torch.Generator(device=dev)
                                .manual_seed(60 + i))
            out.append((m["loss"].clone(), bool(m["dense_ok"]),
                        {k: p.grad.clone()
                         for k, p in model.named_parameters()}))
        return out, {k: v.clone() for k, v in model.state_dict().items()}

    torch.use_deterministic_algorithms(True)
    try:
        plain, plain_state = run(None)
        sync(dev)
        reset_kernel_launches()
        grouped, grouped_state = run(group)
        sync(dev)
        launches = kernel_launches()
    finally:
        torch.use_deterministic_algorithms(False)
    same = [torch.equal(a[0], b[0]) and a[1] == b[1]
            and all(torch.equal(v, b[2][k]) for k, v in a[2].items())
            for a, b in zip(grouped, plain)]
    state_same = sum(torch.equal(v, plain_state[k])
                     for k, v in grouped_state.items())
    print(f"57. world-1 NCCL group, ModelNet dense step B={B} N={N} (bf16):"
          f" {sum(same)} of {DP_STEPS} steps bitwise equal to the plain "
          f"single-process kernel step (loss, dense_ok, {len(grouped[0][2])}"
          f" gradient leaves), {state_same} of {len(plain_state)} final "
          f"parameters and statistics equal; losses "
          f"{[round(x[0].item(), 4) for x in grouped]}; NCCL collectives "
          f"on the card {nccl}, none in a step of a group of one; "
          f"launches {launches}", flush=True)
    if sum(same) != DP_STEPS or state_same != len(plain_state):
        raise AssertionError("the world-1 NCCL step is not the plain step")
    for name, per in PER_STEP.items():
        if launches[name] != per * DP_STEPS:
            raise AssertionError(f"world-1 group: {name} launched "
                                 f"{launches[name]} times, want {per} a "
                                 f"step")

    def timed() -> None:
        times: dict = {None: [], group: []}
        model.load_state_dict(state0)
        steps = {g: factory(g) for g in times}
        gen = torch.Generator(device=dev).manual_seed(60)
        for g in (None, group, group, None) * DP_TIMED:
            sync(dev)
            t0 = time.perf_counter()
            steps[g].train_step(batch, gen)
            sync(dev)
            times[g].append((time.perf_counter() - t0) * 1e3)
        plain_ms, group_ms = (float(np.median(times[g])) for g in times)
        (p_lo, p_hi), (g_lo, g_hi) = ((min(times[g]), max(times[g]))
                                      for g in times)
        print(f"57. world-1 step {group_ms:.2f} ms against {plain_ms:.2f} "
              f"ms without the group (medians of {2 * DP_TIMED} steps "
              f"each, alternated; host clock, synchronised; ranges "
              f"{g_lo:.2f}-{g_hi:.2f} and {p_lo:.2f}-{p_hi:.2f}): the "
              f"group adds {group_ms - plain_ms:.2f} ms a step",
              flush=True)
        close_data_parallel()

    return launches, timed


def start_dp_ranks(dev: torch.device) -> dict:
    """Phase 58's two ranks, started before phase 56 so that their start
    (imports, models, batches, the collectives' check) runs beside it:
    they wait for :func:`data_parallel_phases` to write the ``go`` file.
    Daemon thread and processes: a failed phase before 57 leaves nothing
    running."""
    import threading

    from sph3d_gcn_torch.parallel import run_ranks

    tmp = tempfile.mkdtemp()
    ranks: dict = {"tmp": tmp, "go": os.path.join(tmp, "go")}

    def spawn():
        try:
            ranks["out"] = run_ranks(
                dp_rank, 2, (ranks["go"], DP_TIMEOUT, DP_SIZES),
                device=str(dev), backend="gloo", timeout=DP_TIMEOUT,
                threads=2, store_dir=tmp)
        except BaseException as e:     # re-raised in the main thread
            ranks["error"] = e

    ranks["thread"] = threading.Thread(target=spawn, daemon=True)
    ranks["thread"].start()
    return ranks


def data_parallel_phases(dev: torch.device, smi: str, ranks: dict) -> dict:
    """Phases 57-58 (see the module docstring), the latter's ranks from
    :func:`start_dp_ranks`. Returns their launches by path for the JSON
    line's ``fit_paths``."""
    import shutil

    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    try:
        try:
            launches, timed = world_one_phase(dev)
            runs = {"modelnet_dp_world1": launches}
            t_world = time.perf_counter()
            problems, refs = dp_problems(dev, DP_SIZES), {}
            for name, (build, batch, _) in problems.items():
                # the S3DIS reference also holds the point-sharded step
                refs[name] = dp_step(build(None), batch, dev,
                                     update=name == "s3dis")
                torch.cuda.empty_cache()
            t_refs = time.perf_counter()
            t_go = time.time()
        finally:
            Path(ranks["go"]).touch()
            ranks["thread"].join()
        t_ranks = time.perf_counter()
        timed()
    finally:
        shutil.rmtree(ranks["tmp"], ignore_errors=True)
    if "error" in ranks:
        raise ranks["error"]
    print(f"   phase 57 {t_world - t_start:.1f} s, the one-process "
          f"references {t_refs - t_world:.1f} s, the ranks after them "
          f"{t_ranks - t_refs:.1f} s (rank 0's steps end "
          f"{[round(t - t_go, 2) for t in ranks['out'][0]['clock']]} s "
          f"after the go)", flush=True)
    print(f"58. two ranks sharing the card over gloo ({smi}): collectives "
          f"on CUDA tensors {ranks['out'][0]['checks']}; each rank's rows "
          f"of the global batch (f32 activations) against the one-process "
          f"kernel step on it:", flush=True)
    for name, (_, _, per_step) in problems.items():
        ref = refs[name]
        for rank, out in enumerate(ranks["out"]):
            got = out[name]
            dp_hold(f"{name} rank {rank} ({got['ms']:.1f} ms, one-process "
                    f"{ref['ms']:.1f} ms)", got, ref)
            for kernel, per in per_step.items():
                if got["launches"][kernel] != per:
                    raise AssertionError(
                        f"{name} rank {rank}: {kernel} launched "
                        f"{got['launches'][kernel]} times, want {per}")
            runs[f"{name}_dp_rank{rank}"] = got["launches"]
            print(f"  {name} rank {rank} launches {got['launches']}",
                  flush=True)
    runs.update(point_sharded_report(smi, refs["s3dis"],
                                     [out["sp"] for out in ranks["out"]]))
    print(f"[phases 57-58: {time.perf_counter() - t_start:.1f} s]",
          flush=True)
    return runs


def point_sharded_report(smi: str, ref: dict, outs: list[dict]
                         ) -> dict[str, dict[str, int]]:
    """Phase 58's point-sharded half: each rank's replay of its recorded
    calls (held on the rank), its step against the one-process step
    ``ref`` (:func:`sp_hold`), its times, launches, halo traffic and bf16
    step. Returns the launches by path for ``fit_paths``."""
    runs = {}
    print(f"58. point sharding: the same two ranks as one point group "
          f"(two ranks sharing one card over gloo, {smi}; not a two-card "
          f"figure), the S3DIS dense train step B={S3_B} N={S3_N} (f32) "
          f"with rows {list(SP_SHARDED_ROWS)} split {SP_POINTS} ways, "
          f"against the one-process step on the same batch and weights:",
          flush=True)
    for rank, got in enumerate(outs):
        print(f"  point rank {got['points'][0]} of {got['points'][1]} "
              f"({got['points'][2]}): replay of one sharded step's "
              f"kernel-wrapped calls, each against its plain version "
              f"(K6 and K9's f32 sums within {F32_SUM_TOL:g} of their "
              f"largest magnitude, the others as in the other replays; "
              f"spans of one run, not device times):", flush=True)
        print(got["replay"].rstrip(), flush=True)
        print(f"  held on rank {rank}: " + ", ".join(
            f"{k} {n} calls max_abs_err {e:.3g}"
            for k, (n, e) in sorted(got["held"].items())), flush=True)
        sp_hold(f"sharded s3dis rank {rank}", got, ref)
        for kernel, per in PER_SEG_STEP.items():
            if got["launches"][kernel] != per:
                raise AssertionError(
                    f"sharded s3dis rank {rank}: {kernel} launched "
                    f"{got['launches'][kernel]} times, want {per}")
        halo, per = got["halo"], len(got["timed"])
        print(f"  sharded s3dis rank {rank}: step "
              f"{float(np.median(got['timed'])):.1f} ms, median of {per} "
              f"(range {min(got['timed']):.1f}-{max(got['timed']):.1f}; "
              f"the gated step {got['ms']:.1f} ms, one-process "
              f"{ref['ms']:.1f} ms on the whole batch; with the Adam "
              f"update, host clock, synchronised); halo exchanges a step: "
              f"{halo['exchanges'] // per}, {halo['rows'] // per} rows and "
              f"{halo['bytes'] / per / 2**20:.2f} MiB sent, "
              f"{halo['seconds'] * 1e3 / per:.1f} ms host time in them "
              f"(gloo, staged through the host); peak device memory "
              f"{got['peak_gib']:.2f} GiB; launches {got['launches']}",
              flush=True)
        bf = got["bf16"]
        print(f"  sharded s3dis rank {rank} bf16 step: loss "
              f"{bf['loss']:.4f}, logits finite {bf['finite']}, dense_ok "
              f"{bf['dense_ok']}, halo_ok {bf['halo_ok']}", flush=True)
        if not (bf["finite"] and np.isfinite(bf["loss"])):
            raise AssertionError(f"sharded bf16 step on rank {rank} is "
                                 "not finite")
        runs[f"s3dis_sp_rank{rank}"] = got["launches"]
    return runs


def kernel_lines(runs: dict[str, tuple[Results, dict]],
                 others: tuple, fit_runs: dict[str, dict[str, int]]
                 ) -> dict:
    """The per-kernel JSON object: each kernel's times, bound and launches
    from the one path of ``runs`` (path -> (Results, launch counts)) that
    PATH_OF names for it, its largest error over every replay (``runs``
    and ``others``, more Results); under ``paths`` the same numbers
    from every path of ``runs`` that replayed the kernel's calls (a
    Results that two paths share counts for PATH_OF's path only); and
    under ``fit_paths`` its launches on each path of ``fit_runs`` (the
    entry points' runs, path -> launch counts)."""
    every = [r for r, _ in runs.values()] + list(others)
    shared = collections.Counter(id(r) for r, _ in runs.values())

    def numbers(r, launches, name):
        bound_ms, bound_by = r.bound(name)
        return {"launches": launches[name], "ms": r.ms[name],
                "plain_ms": r.plain_ms[name], "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": (r.library_ms[name] if name in r.has_library
                               else None)}

    kernels = []
    for name, (src, rep) in SOURCES.items():
        path = PATH_OF[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "path": path,
            "max_abs_err": max(x.err[name] for x in every),
            **numbers(*runs[path], name),
            "paths": {p: numbers(r, launches, name)
                      for p, (r, launches) in runs.items()
                      if r.calls[name] and name in r.plain_ms
                      and (shared[id(r)] == 1 or p == path)},
            "fit_paths": {p: launches.get(name, 0)
                          for p, launches in fit_runs.items()},
        })
    return {"kernels": kernels}


def main() -> None:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    # the scene merge's nearest-neighbour projection needs scipy: a card
    # without it fails here, before any phase
    import scipy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.train.eval import checked_forward, vote_classify

    # 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"scipy {scipy.__version__} numpy {np.__version__} "
          f"device {torch.cuda.get_device_name(0)} "
          f"(tf32 off for matmul and cudnn)", flush=True)
    dev = torch.device("cuda:0")

    # 2. build
    t0 = time.perf_counter()
    lib, nvcc_s = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {nvcc_s:.1f} s) "
          f"-> {lib}", flush=True)
    for line in (lib.parent / "ptxas.log").read_text().splitlines():
        if any(k in line for k in ("Compiling entry", "spill", "registers")):
            print("  ptxas:", line.strip(), flush=True)

    # 53-55, the card's side: the queries and the dense engine's f32
    # forwards, whose host side (the CPU's queries, the oracles) runs in a
    # pool beside phases 11-52
    cards = {"queries": query_phase(dev, smi)}
    for family in ("modelnet", "s3dis"):
        cards[family] = dense_oracle_phase(dev, family)
    print(f"[{time.perf_counter() - start:.1f} s] phases 53-55 on the "
          f"card", flush=True)
    phases(dev, start, cards, smi)


def phases(dev: torch.device, start: float, cards: dict, smi: str) -> None:
    """Phases 3-10, the main path's; phases 11-52 beside the host side of
    phases 53-55 (``cards``: their card side's results) in a pool of
    processes; phase 56; then the wall time and the JSON lines."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.train.eval import checked_forward, vote_classify

    cfg_plain = modelnet_config(fast=True, dense=True)
    cfg = modelnet_config(fast=True, dense=True, family="hard")
    gen = torch.Generator().manual_seed(0)
    model = SPH3DModelNet(cfg, generator=gen)
    randomize_bn(model, gen)
    model = model.to(dev).eval()
    model_plain = SPH3DModelNet(cfg_plain).to(dev).eval()
    model_plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(0)
    batches = [surface_clouds(rng, B, N) for _ in range(BATCHES)]

    # 3. per-kernel parity at the served shapes (the default windows'
    # forward calls are replayed with phase 6's step)
    x = torch.from_numpy(batches[0]).to(dev)
    res = Results()
    c = model.config
    levels = range(len(c.radius))
    print(f"per-kernel parity, batch 0, hard windows "
          f"{[c.enc_window(lv) for lv in levels]} / pool "
          f"{[c.pool_window(lv) for lv in levels]} "
          f"(times: median of CUDA events)", flush=True)
    kernel_parity(model, x, res, "ModelNet forward, hard windows")

    # 4. serving: vote_classify through the kernels
    forward = checked_forward(model, dev)
    reset_kernel_launches()
    for bi, batch in enumerate(batches):
        votes = vote_classify(forward, batch, num_votes=VOTES,
                              rng=np.random.default_rng(100 + bi))
        if votes.shape != (B, cfg.num_cls) or not np.isfinite(votes).all():
            raise AssertionError(f"bad vote logits {votes.shape}")
        print(f"batch {bi}: {VOTES} votes, summed logits finite "
              f"{votes.shape}, dense_ok on every forward", flush=True)
    launches = kernel_launches()
    n_fwd = BATCHES * VOTES
    print(f"launches over {n_fwd} forwards: {launches}", flush=True)
    for name, per in PER_FORWARD.items():
        if launches[name] != per * n_fwd:
            raise AssertionError(
                f"{name}: {launches[name]} launches, want {per} per "
                f"forward")

    with torch.inference_mode():
        got = model(x)
        ok_k = bool(model.dense_ok)
        ref = model(x, use_kernels=False)
        ok_p = bool(model.dense_ok)
        fwd_ms = median_ms(lambda: model(x))
        plain_fwd_ms = median_ms(lambda: model(x, use_kernels=False),
                                 reps=3)
        fwd_plain_win_ms = median_ms(lambda: model_plain(x))
        ok_w = bool(model_plain.dense_ok)
    if not (ok_k and ok_p and ok_w):
        raise AssertionError("dense_ok False on the comparison forward")
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"kernel vs plain logits: max_abs_err {diff:.4g}, argmax "
          f"agreement {agree:.4f} (|logits| <= {scale:.3g}, tolerance "
          f"{LOGIT_TOL:g} of that)", flush=True)
    if agree < 0.95:
        raise AssertionError(f"argmax agreement {agree} < 0.95")
    torch.testing.assert_close(got, ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * scale)
    print(f"forward B={B} N={N}, hard-family windows: {fwd_ms:.2f} ms "
          f"({B * N / fwd_ms * 1e3:.0f} points/s) with kernels, "
          f"{plain_fwd_ms:.2f} ms with the plain versions", flush=True)
    print(f"forward B={B} N={N}, plain-family windows: "
          f"{fwd_plain_win_ms:.2f} ms "
          f"({B * N / fwd_plain_win_ms * 1e3:.0f} points/s) with kernels",
          flush=True)

    # 5. profile: the served forward's device-busy time and idle share
    for family, m in (("hard", model), ("plain", model_plain)):
        profile_forward(m, x, family)
    del model, model_plain

    # 6-10. the train step
    res_train = Results()
    train_launches, conv_map, profile_launches = train_phases(dev,
                                                              res_train)
    print(f"[{time.perf_counter() - start:.1f} s] phases 1-10 done; the "
          f"host side of phases 53-55 starts in 3 processes", flush=True)
    with host_pool(3) as pool:
        jobs = submit_host_jobs(pool, cards)
        runs = later_phases(dev, start, batches, conv_map)
        del conv_map
        t0 = time.perf_counter()
        finish_host_phases(cards, jobs, start)
    print(f"[{time.perf_counter() - start:.1f} s] phases 53-55 done "
          f"({time.perf_counter() - t0:.1f} s waiting on the host "
          f"processes)", flush=True)
    fit_runs = runs.pop("fit_runs")
    dp_ranks = start_dp_ranks(dev)
    fit_runs["modelnet_oracle_cli"] = cli_oracle_phase()
    fit_runs.update(data_parallel_phases(dev, smi, dp_ranks))
    fit_runs["modelnet_profile_step"] = profile_launches
    fit_runs["cube_dilated_queries"] = cards["queries"][2]
    fit_runs["modelnet_oracle_dense"] = cards["modelnet"][2]
    fit_runs["s3dis_oracle_dense"] = cards["s3dis"][2]
    others = runs.pop("others")

    print(f"chip_smoke wall: {time.perf_counter() - start:.1f} s (host "
          f"clock, from the script's start; the kernels' build included)",
          flush=True)
    print(json.dumps(kernel_lines(dict(
        runs, modelnet_train_step=(res_train, train_launches)),
        (res,) + others, fit_runs)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def later_phases(dev: torch.device, start: float, batches: list,
                 conv_map: tuple) -> dict:
    """Phases 11-52. Returns their paths for the JSON line (path ->
    (Results, launch counts)), with ``fit_runs`` (the entry points'
    launches) and ``others`` (Results no path names)."""
    # 11-13. the S3DIS serving forward
    res_s3 = Results()
    s3_launches = s3dis_phases(dev, res_s3)

    # 14-19. the per-edge engine and the dense engine's fallback
    res_win, res_win_step = Results(), Results()
    win_launches, win_step_launches = windowed_phases(
        dev, batches, res_win, res_win_step)

    # 20-25. the S3DIS train step and the max_index entry
    res_s3_step, res_index = Results(), Results()
    s3_step_launches, pool_calls = s3dis_train_phases(dev, res_s3_step)
    max_index_replay(dev, pool_calls, conv_map, res_index)
    pool_bwd_stress(dev)
    pool_fwd_stress(dev)
    gather_stress(dev)
    gather_bwd_stress(dev)
    conv_fwd_stress(dev)
    conv_bwd_stress(dev)
    fps_stress(dev)
    query_stress(dev)
    del pool_calls, conv_map

    # 26-30. the options that read distance maps, the avg pools, IDS and
    # random sampling, and the distance-map replay of their queries
    res_weighted, res_ids, res_dist = Results(), Results(), Results()
    weighted_launches, growth_calls = s3dis_weighted_phases(dev,
                                                           res_weighted)
    ids_launches, query_calls = modelnet_option_phases(dev, res_ids)
    random_sample_phase(dev)
    dist_map_replay(query_calls + growth_calls, res_dist)
    del query_calls, growth_calls

    # 31-34. the S3DIS per-edge engine and the dense scene model's fallback
    res_s3pe, res_s3pe_step = Results(), Results()
    s3pe_launches, s3pe_step_launches, shrunk = s3dis_per_edge_phases(
        dev, res_s3pe, res_s3pe_step)

    # 35-40. the training and evaluation entry points
    fit_runs = entry_point_phases(dev, shrunk)
    del shrunk
    print(f"[{time.perf_counter() - start:.1f} s] phases 1-40 done",
          flush=True)

    # 41-46. ShapeNet, RueMonge and the scene evaluation
    family_runs: dict = {}
    fit_runs.update(family_phases(dev, family_runs))
    print(f"[{time.perf_counter() - start:.1f} s] phases 41-46 done",
          flush=True)

    # 47-52. the datasets' raw files prepared, the native reader, TF1
    fit_runs.update(prep_phases(dev, family_runs))

    return {
        **family_runs,
        "s3dis_serve": (res_s3, s3_launches),
        "s3dis_train_step": (res_s3_step, s3_step_launches),
        "modelnet_per_edge_serve": (res_win, win_launches),
        "modelnet_per_edge_train_step": (res_win_step, win_step_launches),
        "modelnet_ids_train_step": (res_dist, ids_launches),
        "s3dis_weighted_serve": (res_dist, weighted_launches),
        "s3dis_per_edge_serve": (res_s3pe, s3pe_launches),
        "s3dis_per_edge_train_step": (res_s3pe_step, s3pe_step_launches),
        "fit_runs": fit_runs,
        "others": (res_index, res_weighted, res_ids),
    }


if __name__ == "__main__":
    main()
