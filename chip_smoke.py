#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. Require CUDA; print the card's name and power limit; turn TF32 off.
2. Build the hand-written kernels (``csrc/*.cu``) for sm_90a; print each
   kernel's registers and spills (``-Xptxas -v``), instance by instance, and
   fail unless every band-attention instance, f32 and bf16, has its recorded
   registers and spills: the f32 ones those from before the bf16-operand
   switch, the row walk's as they were before its window layout (which must
   leave them as they were), the window forward's and the dense softmax
   backward's as they were first built; the bf16 column walk's as it
   compiled when it first read the stored bf16 rows; the dense softmax
   forward (v2's row walk on one block) at v2's numbers, f32 and bf16, and
   the dense backward's bf16 instance at v2's, its dp-rounding rows pass at
   the rows pass's.
3. Hold each kernel, forward and backward, against its plain PyTorch version
   on the card, at the bigtown band layout (B 1 and B 4) and at small ragged
   shapes (W not a multiple of 32, fully masked rows, H·C 64, C past one
   128- and 256-channel tile, C 256 of one head, three heads of C 128,
   C % 4 != 0, rows with more than 32 entries, extended rows that more than
   32 entries read, more than 32 heads (H 40 at C 4, H 33 at C 3), an x_ext
   off 16-byte alignment, forward and backward); atol and rtol 1e-4, since
   the kernels sum in another order. The backward kernels get a random
   cotangent on all rows. The flash backward and the band SpMM backward also
   at every ragged shape, with a d_out off alignment, each called twice on
   the same inputs with bit-equal results.
4. Fixture parity: the trained GATRes-large on bigtown (banded, through the
   kernels) against the JAX activations stored in
   ``artifacts/parity_r5_trained.npz`` (atol 1e-3), with exactly 50
   band-attention and 25 band-SpMM launches per forward; and the dense
   15-block fixture ``artifacts/parity.npz`` (atol 1e-4).
5. Serving: ``Inferencer`` answers 64 bigtown snapshots at batch 32, with
   exactly 50 and 25 launches per batch; ``torch.profiler`` then splits one
   batch's device time by kernel.
6. At the serving shapes (B 32), holds each kernel against its plain version
   once more (atol and rtol 1e-4), then times it beside the plain version, a
   PyTorch library call where one computes the same function, and its bound
   on an H100 SXM (counted over the index the kernel walks) with the share of
   it reached; v2's forward also beside the flash forward on the same inputs;
   every kernel also at the training batch (B 8). The device time of v2's
   forward and of v2's backward by pass (``torch.profiler``) at B 32, H·C 256.
7. Training at full width: GATRes-large from the trained fixture's weights on
   bigtown. (a) One step at B 1 with the mask of
   ``artifacts/parity_train_bigtown.npz``: loss, every gradient and the
   parameters after 3 Adam steps against the JAX ``Trainer``'s, with exactly
   50 + 25 forward and 50 + 25 backward launches per step. (b) The same step
   through the plain versions on the card. (c) ``Trainer.fit`` for 2 epochs at
   batch 8 on 32 + 16 snapshots in memory: finite losses, no divergence,
   checkpoints written and reloaded, exact launch counts; then the step time
   (CUDA events), peak memory and a ``torch.profiler`` split of one step.

8. The dense path at C-Town scale (``inputs/synthctown.inp``, 388 nodes): the
   four dense-mode kernels (``fused_attention``, ``fused_factored``, forward
   and backward) against their plain versions at every shape GATRes-small and
   GATRes-large run there, at B 1 and B 32, and at small ragged shapes (a
   one-way mask, rows and columns of more than 32 entries, C past one tile,
   H past a head group of the factored walk, B 1);
   atol and rtol 1e-4, random cotangents, a third of the nodes zeroed so
   that a_d + a_s == 0 occurs. At the same shapes the softmax pair's bf16
   instances (``bf16=True``, GATConv's ``attn_dtype="bfloat16"``) against
   their bf16 plain versions (1e-4; the backward on v and dO on a grid where
   every dp is exact in f32, so both round the same dp to bf16), each at
   least 1e-3·max|ref| from its f32 instance.
9. Fixture parity: GATRes-small with the weights of
   ``artifacts/parity_train_synthctown.npz``: the serving forward per block
   and at the output against the JAX values (1e-3), exactly 30
   ``fused_factored`` launches; one B 1 train step (loss, metrics, every
   gradient, parameters after 3 Adam steps) with exactly 30 forward and 30
   backward launches; the same step through the plain versions on the card.
10. Serving: ``Inferencer`` answers 64 synthctown snapshots at batch 32 with
    GATRes-small (30 launches a forward) and GATRes-large (50), seeded
    weights; each first batch is held against the plain versions on the card.
11. Training: ``Trainer.fit`` of GATRes-small for 2 epochs at batch 32,
    mask_rate 0.95 (30 + 30 launches a step), checkpoints, a resume from the
    first epoch's checkpoint that must end bit-identical; step time (CUDA
    events), edges/s as ``bench.py`` counts them, peak memory; one GATRes-large
    step; ``torch.profiler`` splits of one serving batch and one train step.
12. ``attn_impl="softmax"``: the fixture
    ``artifacts/parity_train_synthctown_softmax.npz`` (GATRes-small, the JAX
    layer's XLA branch: per block and output within 1e-3, the B 1 step, 3
    Adam steps, 30 + 30 launches); its bf16 twin ``…_softmax_bf16.npz``
    (deviations per block beside the f32 model's, the blocks before the
    first bf16 rounding flip held to 1e-3, the step failing only on a loss
    no nearer the bf16 fixture than the f32 fixture's); then GATRes-small and
    -large with seeded weights, f32 and ``attn_dtype="bfloat16"``: a serving
    batch of 32 (30 / 50 launches of the instance, none of the other; the
    f32 fields held against the plain versions) and a train step at batch
    32 (as many backwards; small's f32 gradients held against the plain
    step), each timed in turns f32, bf16, bf16, f32.
13. Times of the four dense kernels and the softmax pair's bf16 instances at
    B 32 beside their plain versions, the einsum formulation the layer would
    otherwise run (the factored pair's, forward and backward), and their
    byte bounds (the bf16 instances' at 2-byte v and at f32 v); the softmax
    backward (v2's band backward on one block) by pass, and the softmax
    pair's device time in a GATRes-small step (15 launches at conv1's shape,
    15 at conv2's).

14. The banded path at 23k nodes: meganet (``simgen.netgen.make_mega``, made
    from its seed; BLK 256, W 1920). The streaming-softmax band attention
    (``band_attention_flash``: out, m, Z; backward from m, Z, delta) against
    its plain version on the meganet layout at H·C 256 and 128, B 1 and B 2,
    and the window band attention (``band_attention_window``) on the bigtown
    layout at the same batches (phase 19 holds both at their serving batches);
    both also at small ragged shapes (fully masked rows, rows of more than 32
    entries, C past one tile); a third of the nodes zeroed; atol and rtol 1e-4.
    The window pair also against v2's on the x_ext its windows were cut from:
    the forward (v2's row walk reading x_win) equal to v2's bit for bit at
    every shape, or the run fails; the backward's folded d x_win within 1e-4
    of v2's d x_ext, and whether its d a_dst and d a_src_win equal v2's bit
    for bit is printed.
15. Routing: ``batch()`` with no argument sends meganet to ``"flash"`` and
    bigtown to ``"dma"``.
16. The meganet fixture ``artifacts/parity_train_meganet.npz`` (GATRes-large
    width, the fixture's depth, weights drawn from a seed): forward, loss,
    every gradient and the parameters after 3 Adam steps against the JAX
    ``Trainer`` (its v4 Pallas kernel in interpret mode).
17. meganet, GATRes-large at full depth and width, seeded weights:
    ``Inferencer`` on 16 snapshots at batch 8 with exactly 50
    ``band_attention_flash`` and 25 ``band_spmm`` launches a forward and none
    of the v2 kernel; one train step through the kernels against the same step
    through the plain versions; the same step with ``remat=True``;
    ``Trainer.fit`` for 2 epochs at batch 2 on 8 + 4 snapshots with as many
    backward as forward launches a step and a resume that ends bit-identical;
    ms per batch and per step (CUDA events), edges/s, peak memory, profiler
    splits.
18. bigtown with ``band_attn="window"``: one serving batch (50
    ``band_attention_window`` launches) against the default route's (1e-4),
    the B 1 step of ``artifacts/parity_train_bigtown.npz``, and the same
    serving batch and a batch-8 train step timed under each of the three routes;
    the window backward's device time in that step (25 launches at each width).
19. Times of the four new kernels beside their plain versions and byte bounds:
    the flash pair on meganet at B 8 (serving) and B 2 (training), out, m
    and Z held against the plain version first, the backward also from the
    forward kernel's own out, m, Z (whether m equals the plain row maximum
    bit for bit is printed); the flash backward's device time by pass and
    that of its delta reduction at B 8 and B 2; the kernels alone at B 32; at
    B 8, v2's pair on the same inputs (the two forwards are one row walk, v2's
    without the statistics; the two backwards one column walk, v2's with the
    softmax recomputed); the band SpMM forward on meganet at B 8 beside
    ``torch.sparse.mm``, its backward at B 8 and B 2 beside
    ``torch.sparse.mm`` on the transposed CSR, and the launch-weighted device
    time of both backwards in a B 2 step; the window pair on bigtown at B 32,
    each beside v2's kernel of the same direction on the same x_ext (device
    time too; the backwards by pass), and the window columns instances'
    registers and spills.

20. The backward of the sliding-accumulator route (``band_attention_acc_bwd``,
    v2's passes under their own entry) against its plain version on the
    bigtown layout at B 1, 8 and 32, H·C 256 and 128, and at ragged shapes
    (padded rows, C past one tile, rows of more than 32 entries, a block of
    1056 rows); atol and rtol 1e-4; and its three outputs equal to
    ``band_attention_bwd``'s on the same inputs, bit for bit.
21. Path A, GATRes-large training on bigtown with ``band_attn="acc"``: the B 1
    step of ``artifacts/parity_train_bigtown.npz`` (loss, metrics, every
    gradient, 3 Adam steps) with exactly 50 ``band_attention`` + 50
    ``band_attention_acc_bwd`` (+ 25 + 25 band SpMM) launches and no
    ``band_attention_bwd``; a batch-8 step under "acc", under "dma" and through
    the plain versions, on four draws of snapshots and masks, each gradient
    held against the same step through the plain versions in float64 (within
    3 × (1e-3·max|g| + 1e-6): the plain f32 step itself exceeds 1×), and the
    "acc" and "dma" gradients equal bit for bit on each draw;
    ``Trainer.fit`` for 2 epochs at batch 8 with a
    resume that ends bit-identical; the batch-8 step timed under "dma", "acc"
    and "dma".
22. Path B, ``agg_mode="padded"``: the trained fixture forward per block and
    at the output (1e-3), ``Inferencer`` on 64 snapshots at batch 32 (timed,
    held against the banded route's fields), the B 1 fixture step, ``fit``
    for 2 epochs at batch 8 with a bit-identical resume, the step's time and
    peak memory. No kernel runs on this path: its gathers are plain torch, as
    the reference's are XLA.
23. ``window_gather`` on the padded mode's degree tables of bigtown at B 8 and
    32, C 256 and 128: forward bit-equal to its plain version and to
    ``x_perm[idx_perm]``, backward within 1e-4; then driven through
    ``make_window_gather`` on conv1's projected features of a padded serving
    batch, against the padded mode's own gather, forward and backward.
24. Times of the two new kernels: ``band_attention_acc_bwd`` beside v2's
    backward on the same inputs (B 8, 32), both by pass, its device time in a
    batch-8 step and its columns instances' registers; ``window_gather`` beside
    ``torch.index_select`` and its backward beside ``index_add_`` on the same
    rows; plain versions and byte bounds.

25. The dense factored pair as one walk over the mask index
    (``csrc/dense_walk.cuh``): the walk's instances' registers and spills;
    both kernels on synthctown at B 32 at phase 13's four shapes, held
    against their plain versions (1e-4), then timed: device time
    (``torch.profiler``), CUDA events, the plain versions, the einsum
    formulation (device time too) and the byte bound; then one serving
    batch and one train step at B 32 of GATRes-small and -large with exactly
    30 / 50 factored forwards a forward and as many backwards a step, and the
    device time of those launches.

26. The band attention's bf16-operand instances (``mxu_bf16=True``, GATRes's
    ``attn_dtype="bfloat16"``): v2's forward, v2's and v3's backwards
    (bigtown layout, B 1, 8 and 32) and v4's pair (meganet layout, B 1, 2
    and 8), H·C 256 and 128, against their plain versions (atol and rtol
    1e-4; v3's backward equal to v2's bit for bit) and at least
    1e-3·max|ref| from their f32 instances on the same inputs; forwards and
    backwards read x_ext stored in bf16, as the model's path hands it, and
    f32 rows through the wrappers' cast must give the same outputs bit for
    bit; then at ragged shapes (padded rows, rows of more than 32 entries, C
    past a tile, C % 4 != 0, 33 and 40 heads) and on bf16 rows off 16-byte
    alignment (the scalar loads), forward and backward.
27. bigtown, GATRes-large with ``attn_dtype="bfloat16"`` set by
    ``apply_model_knobs`` on the trained weights: the fixture
    ``artifacts/parity_train_bigtown_bf16.npz`` (the forward's output and
    per-block statistics within 1e-3 with exactly 50 bf16 band-attention
    launches and none of the f32 instance; the B 1 step under "dma" and under
    "acc" with the gates of phase 7 and exact launch counts), 64 snapshots at
    batch 32 through ``Inferencer`` and a batch-8 train step, each timed in
    turns with the f32 model; a profiler trace of each step: its device
    time, and no op that copies a tensor of the extended rows' shape (the
    backwards read the saved bf16 rows as they are), or the run fails.
28. meganet through "flash" with ``attn_dtype="bfloat16"``: the 4-block
    fixture ``artifacts/parity_train_meganet_bf16.npz`` (forward statistics,
    B 1 step), 16 snapshots at batch 8 and a batch-2 step of the 25-block
    model, in turns with f32, exact launch counts; the step's peak memory
    under bf16 and f32, its device time and no copy of the extended rows.
29. Times of the bf16 instances beside their f32 instances on the same
    inputs (in turns; the bf16 ones on bf16 rows), their plain versions and
    their bounds at 2-byte x rows, at bigtown B 32 and 8 and meganet B 8
    and 2.

30. The snapshot store and the solver: the C++ hydraulic solver (the port's
    copy of ``hydraulic.cpp``) built into ``_build/``, timed;
    ``artifacts/eval_bigtown.zip`` (bigtown snapshots from the JAX generator,
    Blosc-lz4 chunks) read by the port's ``ZarrZipReader`` into the train and
    test ``WDNDataset``s: every split and the scaled arrays bit-equal to the
    JAX package's (SHA-256 in ``artifacts/parity_eval_bigtown.npz``), the
    statistics within 1e-12 relative; 4 noise scenes of bigtown
    (``make_noisy_scenes``, ``backend="cpp"``, the fixture's seed): the
    perturbed demands bit-equal to JAX's, the pressures within 1e-4 m, the
    solver's time a scene.
31. Clean evaluation on the card: the trained GATRes-large
    (``parity_r5_trained.npz``) through ``Evaluator`` on the test split at the
    fixture's batch, banded, routed to ``"dma"``, the fixture's masks
    replayed in order and its ``sensor_names``: every trial's loss and five
    metrics within 1e-3 relative + 1e-4 of the JAX values, corr and r2 within
    1e-3; exactly 50 ``band_attention`` + 25 ``band_spmm`` launches a forward
    (the Timer's warm-ups included) and no other kernel; then twice with the
    port's own mask draws from one seed, bit-identical; ``test_time`` and
    ``test_throughput`` from the CUDA-event ``Timer``.
32. noisy11 and noisyNN on phase 30's scenes through the scene-batched path
    (the 4 scenes as one batch), replayed masks, the same gates and launch
    counts; a summary line of the evaluation times.
33. The port's command line (``cli.main``, as a user calls it, on the card by
    default) for GATRes-large on bigtown at full depth and width: ``generate``
    from ``configs/bigtown.ini`` with the options the JAX generator was given
    for ``artifacts/eval_bigtown.zip`` (``tools/eval_parity_export.py``: 80
    scenarios, seed 1234, backend cpp): train, valid and test pressures of
    the same shapes (40, 8, 32 × 5,821) and within 1e-6 m of that store's;
    the seconds taken and the solver backend that ran.
34. ``train --model gatres_large`` on phase 33's zip (banded, BLK 256,
    routed to ``"dma"``): 2 epochs at batch 8 with ``--do_test``, ``--log_method
    wandb`` (the JSONL fallback: the card has no wandb) and a profiler trace
    of epoch 2; each train step launches 50 ``band_attention`` + 50
    ``band_attention_bwd`` + 25 ``band_spmm`` + 25 ``band_spmm_bwd`` and each
    forward 50 + 25, no other kernel; best and last checkpoints with layout
    banded / 256; the log and the trace (naming the band kernels) written;
    a resume from the last checkpoint for a third epoch ("continuing at 3");
    the epoch times.
35. ``eval`` of phase 34's best checkpoint: clean (2 trials, batch 16) and
    noisyNN (1 scene): 50 + 25 launches a forward, ``test_time`` and
    ``test_throughput``.
36. ``infer`` on a checkpoint built on the card from
    ``artifacts/parity_r5_trained.npz`` and the statistics of
    ``eval_bigtown.zip``'s train split (``save_checkpoint``), with the flags
    of ``artifacts/parity_infer_bigtown.npz`` (``tools/cli_parity_export.py``:
    the JAX ``cli infer`` on the flax checkpoint of the same weights and
    statistics): one forward of 50 + 25 launches, observed nodes at their
    true values, the same observed set and ``pred`` within 1e-3 of the JAX
    fields; npz and csv written.

37. The model zoo's shapes: the band SpMM against its plain version over the
    count bands ``cnt`` and ``cnt_sl`` and the signed Chebyshev band (f32)
    on bigtown at C 1, 30, 32, 60 and 120 (the scalar loads below C % 4 == 0),
    v2 at H 2 C 32 and H 1 C 1 on bigtown and ``fused_attention`` at both on
    synthctown, B 1 and B 8, forward and backward, random cotangents, atol
    and rtol 1e-4; then the band SpMM pair at B 32 at those widths (and 128)
    timed beside its plain version, ``torch.sparse.mm`` (CSR) and its byte
    bound.
38. Fixture parity of the six zoo presets (GIN, GAT, GCN2, ChebNet,
    GraphConvWat, m_GCN cut to 4 of its 45 aggregations) on bigtown (banded,
    BLK 256, ``"dma"``, B 1) against ``artifacts/parity_zoo_<model>.npz``
    (``tools/parity_zoo_export.py``, the JAX ``Trainer``): the port's dataset
    gives the fixture's snapshot and edge attributes; every layer on the
    fixture's rows and the output within 1e-3 (relative to max|ref| where it
    exceeds 1); one step: loss rtol 1e-4, each gradient within
    1e-3·max|g_ref| + 1e-6, the same step through the plain versions, 3 Adam
    steps at phase 7's gates; exactly the launches of ``ZOO_FWD`` /
    ``ZOO_BWD`` and none of any other kernel.
39. Serving: ``Inferencer`` answers 64 bigtown snapshots at batch 32 for each
    preset (seeded weights): ms per batch (CUDA events), launches, peak
    memory, a profiler split of one GraphConvWat batch; GAT and GIN serve a
    batch of 32 on synthctown (dense; GAT through ``fused_attention``), held
    against the plain versions.
40. Training on bigtown: ``Trainer.fit`` for 2 epochs, GIN at batch 8 and
    m_GCN at batch 4 (mae, minmax, edge attributes), each resumed from epoch
    1 to a bit-identical end (``ops.segment`` sums without atomics); step
    ms, edges/s, peak memory; 3 steps of GAT, GCN2, ChebNet and GraphConvWat
    at batch 8 with their launches.
41. ``GATResRemask`` and ``GATResRemaskStack`` (15 blocks, nc 32) on bigtown
    at batch 4: one forward against the plain versions, 30 ``band_attention``
    + 15 / 1 ``band_spmm`` launches.
42. ``cli.main`` ``train`` (one epoch, batch 8), ``eval`` (clean) and ``infer``
    with ``--model gin`` and ``--model mgcn`` (the preset's edge attributes,
    mae and minmax) on ``artifacts/eval_bigtown.zip``, the store phase 33
    regenerates: seconds and launches of each.

The parallel strategies (``parallel/``; each phase prints its ranks'
backend, by the rule of ``parallel.mesh.choose_backend``):

43. Every band kernel (SpMM; v2, v4, v3, v1; forward and backward) on each
    rank's chunk of bigtown's 1×2 halo layout (the last rank's padded with an
    empty block), x_ext random on every row, the halo rows included, at B 8
    and 32, H·C 256 and 128, against its plain version (atol, rtol 1e-4).
44. bigtown GATRes-large (25 blocks, nc 128) at B 8 on a 1×1 mesh under NCCL
    (one rank started through ``parallel.launch``): an eval step and a train
    step against the single-device ``Trainer``'s on this card: loss rtol
    1e-5, each gradient within 1e-3·max|g| + 1e-6, outputs within
    1e-5·max(1, max|ref|) (bit-equality reported), 50 + 25 launches a
    forward and 50 + 25 backwards a step; step ms, exchange ms and peak
    memory per rank.
45. The same on a 1×2 halo mesh of two gloo ranks sharing the card; the
    ranks' parameters bit-identical after the step.
46. ``"flash"``, ``"acc"`` and ``"window"`` on the 1×2 mesh, GATRes 4 blocks
    at full width, the same gates.
47. meganet GATRes-large serving at B 8 on the 1×2 mesh, routed to
    ``"flash"`` (50 + 25 launches a rank), against the single-device forward.
48. synthctown GATRes-small, the graphs strategy at 2×1, B 32, through the
    fused factored kernels (30 + 30 launches a rank); ``DistributedTrainer``
    at 1×2, B 8, the edge partition (no kernel).
49. ``Evaluator(mesh=)`` at 1×2 on ``eval_bigtown.zip``'s test split, one
    clean trial, against the single-device ``Evaluator`` (same seeds, same
    masks).
50. ``cli train --mesh 1,2`` for one epoch and a resume to two, ``cli eval
    --mesh 1,2``, a two-process ``--distributed`` train.

The last training knobs (``knob_phases``; fixtures of
``tools/parity_precision_export.py``):

51. bf16 activations (GATConv's ``dtype``, ``--activation_dtype``): the five
    instances that round the logits as the JAX layer's bf16 ops do (v2's
    forward and backward, the dense softmax pair, v1's forward; counted in
    their wrappers' ``launches_logit``) against their plain versions, and
    timed; synthctown, dense, B 1 steps of GATRes-small and GATRes-large's
    width (factored and softmax) against
    ``parity_train_synthctown_act_bf16.npz``: the blocks before the first
    rounding flip within 1e-3, the loss nearer the fixture than the f32
    step's, the gradients reported beside the f32 step's distance;
    GATRes-small and -large at B 32, serving and a step, exact launches, ms
    and peak memory in turns with f32; bigtown GATRes-small (its narrow
    layers on v2 with the logits rounded) against
    ``parity_train_bigtown_small_act_bf16.npz`` and timed at B 8;
    GATRes-large on bigtown's dma route raises before any launch, as the JAX
    layer does; on the window route (the JAX v1 kernel) it serves B 8 against
    the plain versions and its backward raises.
52. ``attn_impl="band_factored"``: bigtown GATRes-small in f32 and under
    ``attn_dtype`` bf16 against
    ``parity_train_bigtown_small_band_factored.npz`` (no band-attention
    launch: plain torch, as the JAX op is plain XLA); GATRes-large keeps the
    band kernels: its output bit-equal to the preset's, launches unchanged.
53. ``matmul_precision``: a 512×512 GEMM under each name against its
    TF32-operand and bf16-operand references (and what torch's "medium"
    gives); a bigtown GATRes-large B 8 step and a synthctown GATRes-small B
    32 step under each name: ``highest`` bit-equal to the default, the
    others' gradients as a share of the f32 step's gate, launches unchanged,
    the setting restored after each step.
54. ``epochs_per_dispatch``: synthctown GATRes-small ``fit`` for 4 epochs
    with tail batches at E 1, 2 and 4 (E 2 and E 4 bit-identical, one
    read-back a block); E 2 against the JAX ``_fit_fast`` with its masks
    replayed (``parity_fit_fast_synthctown.npz``); a resume across a block
    boundary, bit-identical; bigtown GATRes-large at B 8 for 2 epochs in
    one block with exact launches.
55. ``cli train`` with ``--activation_dtype bfloat16 --matmul_precision
    bfloat16 --epochs_per_dispatch 2`` on ``eval_bigtown.zip``, then a
    resume to epoch 4.

The last line is ``{"ok": true, "device": {...}}``; the ``kernels`` JSON line
(all fifteen kernels, and the seven wrappers' bf16-operand instances and five
logit-rounding instances as rows of their own; the rows the zoo launches carry
``zoo_launches``, the band SpMM pair its times at the zoo's widths, the rows
the mesh phases launch ``mesh_launches``, summed over their ranks, the rows
phases 51-55 launch ``knob_launches``) and the ``nvidia-smi`` line come
before it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4
# H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
TPU_SRC = "gnn_pressure_estimation_tpu/ops/pallas/band_attention.py"
TPU_DENSE_SRC = "gnn_pressure_estimation_tpu/ops/pallas/graph_attention.py"
TPU_WG_SRC = "gnn_pressure_estimation_tpu/ops/pallas/window_gather.py"


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float,
                verbose: bool = True) -> float:
    if got.shape != ref.shape:
        raise SystemExit(f"FAIL {name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {name}: non-finite values")
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, atol=atol, rtol=rtol):
        raise SystemExit(f"FAIL {name}: max abs err {err:.3e} (atol {atol}, rtol {rtol})")
    if verbose:
        print(f"  {name}: max abs err {err:.3e}")
    return err


def profile_batch(run, what: str = "one batch", top: int = 8) -> None:
    """Device time by kernel over one serving batch or train step
    (``torch.profiler``), and the device's busy share of its host-clock time.
    The profiler's own overhead lengthens the host time, so the busy share is
    a floor."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)
    busy_us = sum(t for t, _, _ in dev)
    if not busy_us:
        print("  profile: the profiler recorded no device time")
        return
    print(f"  profile of {what}: device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"host time ({busy_us / wall_us:.1%}); by kernel:")
    for t, count, key in dev[:top]:
        print(f"    {t / 1e3:9.3f} ms {t / busy_us:6.1%} x{count:<4d} {key[:90]}")


def ptxas_table(log: str) -> list:
    """Each kernel of one source's ``-Xptxas -v`` output as (name, registers,
    stack bytes, spill store bytes, spill load bytes); names demangled by
    ``c++filt`` where the toolkit's host has it, without the unnamed namespace
    and the parameter list."""
    import re
    import shutil

    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = tuple(map(int, m.groups()))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), *spill])
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(rows):
            for r, dm in zip(rows, out):
                r[0] = dm.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]
    return [tuple(r) for r in rows]


def columns_registers(table) -> str:
    """The ``columns_kernel`` instances of one source's ``ptxas_table``."""
    return "; ".join(f"{fn.removeprefix('columns_kernel')} {regs} registers, {stack} bytes stack, "
                     f"spill {st} / {ld}" for fn, regs, stack, st, ld in table
                     if fn.startswith("columns_kernel"))


def device_split(fn, iters: int = 10) -> list:
    """Device ms of each kernel that one call of ``fn`` launches, from
    ``torch.profiler`` over ``iters`` calls, largest first: the passes of a
    kernel source that launches several. The profiler now and then loses a
    trace's records, or all of them: a kernel's ms a call is its mean time a
    launch times its launches a call (at least one), which a lost record does
    not bias, and a trace with no device time is taken again, up to three
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def name(key):          # "void (anonymous namespace)::columns_kernel<2, true, true>(...)"
        return key.removeprefix("void ").removeprefix("(anonymous namespace)::").split("(")[0]

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if events:
            return sorted(((name(e.key), e.self_device_time_total / e.count
                            * max(1, round(e.count / iters)) / 1e3) for e in events),
                          key=lambda kv: -kv[1])
    return []


def fmt_ms(ms) -> str:
    """A device time for a report line: 'not measured' where the profiler
    recorded none."""
    return "not measured" if ms is None else f"{ms:.4f}"


def step_device_ms(ms_by_width: dict):
    """Device ms of a backward in a GATRes-large step: 25 launches at each
    width; None if a width was not measured."""
    return None if None in ms_by_width.values() else 25 * sum(ms_by_width.values())


def step_trace(run, B: int, n_ext: int) -> dict:
    """One train step ``run`` under ``torch.profiler``: its device time (every
    kernel of the step, summed; None where the trace holds none) and the
    ``aten::_to_copy`` ops on tensors of the extended rows' shape
    [B, n_ext, H, C] at GATRes-large's widths H·C 256 and 128, with their
    device ms: a backward that widened the saved bf16 rows would make one a
    GATConv, and nothing else in a step copies a tensor of that shape.
    {"device_ms": ms, "copies": {H·C: ops}, "copy_ms": ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    copies, copy_us = {256: 0, 128: 0}, 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    for H, C in ((2, 128), (1, 128)):
        ev = [e for e in prof.key_averages(group_by_input_shape=True)
              if e.key == "aten::_to_copy" and e.input_shapes
              and list(e.input_shapes[0]) == [B, n_ext, H, C]]
        copies[H * C] += sum(e.count for e in ev)
        copy_us += sum(e.device_time_total for e in ev)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return {"device_ms": busy / 1e3 or None, "copies": copies, "copy_ms": copy_us / 1e3}


def no_row_copies(label: str, traces: dict) -> str:
    """Fails if the bf16 step's trace holds a copy of the extended rows;
    returns the report of both steps' device time."""
    bf, f32 = traces["bfloat16"], traces["float32"]
    if any(bf["copies"].values()):
        raise SystemExit(f"FAIL {label}: the bf16 step copies tensors of the extended rows' shape "
                         f"{bf['copies']} ({bf['copy_ms']:.4f} ms): its backwards must read the "
                         f"saved bf16 rows as they are")
    return (f"device time of the step (a profiler trace of each): bf16 {fmt_ms(bf['device_ms'])} "
            f"ms, f32 {fmt_ms(f32['device_ms'])} ms; no op of the bf16 step copies a tensor of the "
            f"extended rows' shape (ops at H·C 256 / 128: {bf['copies'][256]} / {bf['copies'][128]})")


def band_bwd_bytes(B, nB, BLK, W, H, C, nnz, x_bytes=4, stats=False) -> int:
    """Bytes a band-attention backward must move: x_ext read at ``x_bytes``
    an element (2: the bf16 rows), dO read and d x_ext written at 4, a_dst,
    a_src (one a node), d a_dst and d a_src_win [nB, B, W, H] at 4, with
    ``stats`` v4's m, Z and delta too, and the index's row and column lists
    (row_ptr, t_ptr, col, t_entry, t_row)."""
    n_pad = nB * BLK
    n_ext = n_pad + W - BLK
    return (4 * B * n_pad * H * (5 if stats else 2) + 4 * B * n_ext * H + 4 * nB * B * W * H
            + (x_bytes + 4) * B * n_ext * H * C + 4 * B * n_pad * H * C
            + 4 * (n_pad + 1 + n_ext + 1 + 3 * nnz))


def device_ms(fn, iters: int = 20):
    """Device time of one call of ``fn`` (every kernel it launches, summed),
    from ``torch.profiler``: what the card spends, without the host's time to
    enqueue. None if the profiler records no device time."""
    return sum(ms for _, ms in device_split(fn, iters)) or None


def grads_within(label: str, names, grads, refs) -> float:
    """Each gradient: max|Δ| ≤ 1e-3·max|g_ref| + 1e-6. Returns the largest
    share of that bound any gradient used."""
    worst = 0.0
    for name, g, ref in zip(names, grads, refs):
        if not torch.isfinite(g).all():
            raise SystemExit(f"FAIL {label}: gradient of {name} is not finite")
        err, top = float((g - ref).abs().max()), float(ref.abs().max())
        if err > 1e-3 * top + 1e-6:
            raise SystemExit(f"FAIL {label}: gradient of {name} off by {err:.3e} "
                             f"(max |g_ref| {top:.3e})")
        worst = max(worst, err / (1e-3 * top + 1e-6))
    return worst


def adam_param_errors(named_parameters, fx) -> tuple[float, float]:
    """Largest deviation of the parameters from the fixture's ``p3_*`` (after
    3 Adam steps), split in two. An Adam step moves a parameter by up to lr
    whatever its gradient's size, so a component whose first gradient is
    rounding noise (below the gradient tolerance, 1e-3·max|g_ref| + 1e-6) can
    differ by up to 2·lr a step: those are returned apart from the rest."""
    perr = pnoise = 0.0
    for k, p in named_parameters:
        if f"p3_{k}" not in fx.files:
            continue
        err = (p.detach().cpu() - torch.as_tensor(fx[f"p3_{k}"])).abs()
        g_ref = torch.as_tensor(fx[f"grad_{k}"]).abs()
        real = g_ref > 1e-3 * g_ref.max() + 1e-6
        perr = max(perr, float(err[real].max()) if real.any() else 0.0)
        pnoise = max(pnoise, float(err[~real].max()) if (~real).any() else 0.0)
    return perr, pnoise


def factored_einsum(mask, a_d, a_s, vx, qx):
    """The factored forward as the JAX package's default (XLA) path runs it,
    several calls: the gate materialised, one einsum over it and one over the
    static mask."""
    s_ = a_d[:, :, None, :] + a_s[:, None, :, :]
    gate = (mask[None, :, :, None] & (s_ >= 0)).to(vx.dtype)
    t_adj = torch.einsum("ij,bjhc->bihc", mask.to(vx.dtype), qx)
    t_p = torch.einsum("bijh,bjhc->bihc", gate, torch.cat([vx, qx], dim=-1))
    return t_p[..., : vx.shape[-1]], t_adj - t_p[..., vx.shape[-1]:]


def factored_bwd_einsum(mask, a_d, a_s, g_pv, g_nq):
    """The factored backward in the same formulation: the transposed einsums
    over the materialised gate and the static mask."""
    s_ = a_d[:, :, None, :] + a_s[:, None, :, :]
    gate = (mask[None, :, :, None] & (s_ >= 0)).to(g_pv.dtype)
    d_adj = torch.einsum("ij,bihc->bjhc", mask.to(g_nq.dtype), g_nq)
    d_p = torch.einsum("bijh,bihc->bjhc", gate, torch.cat([g_pv, g_nq], dim=-1))
    return d_p[..., : g_pv.shape[-1]], d_adj - d_p[..., g_pv.shape[-1]:]


# blocks of GATRes-small through softmax under attn_dtype=bfloat16 before the first
# bf16 rounding flip against the JAX package on the bf16 fixture (tools/bf16_flips.py
# --network synthctown, on the CPU): held to 1e-3 on the card
BF16_FLIP_FREE_BLOCKS = 2


def dense_phases(dev, card, rng, held, max_err, reset_launches, read_launches, counts):
    """Phases 8-13: the dense path on synthctown. Returns the kernel rows
    (times and bounds at B 32) and the launch counts of its runs."""
    import tempfile

    from gnn_pressure_estimation_tpu_torch.data.dataset import (
        WDNDataset, _Member, build_template, get_keep_list,
    )
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.presets import MODEL_REGISTRY, select_model
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
    from gnn_pressure_estimation_tpu_torch.train import Trainer, load_checkpoint
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    wn = parse_inp(os.path.join(REPO, "inputs", "synthctown.inp"))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name="synthctown")
    n = tpl.n_node
    mask_np = tpl.dense_operators()["adj_sl_mask"]
    mask = torch.as_tensor(mask_np, device=dev)
    ix = tpl.dense_index().to(dev)
    nnz = ix.nnz
    print(f"[8] dense kernels vs plain versions on synthctown: n {n}, edges {tpl.n_edge}, mask "
          f"nonzeros {nnz} ({nnz / n / n:.4%} dense, longest row {ix.nbr.shape[1]})")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def operands(B, n_, H, C, zero_every=3):
        a_d, a_s = randn(B, n_, H), randn(B, n_, H)
        a_d[:, ::zero_every] = 0.0      # zeroed nodes: a_d + a_s == 0 where two of them meet
        a_s[:, ::zero_every] = 0.0
        return a_d, a_s, [randn(B, n_, H, C) for _ in range(4)]

    def grid(shape, step=2.0 ** -11):
        """[B, n, H, C] values on the grid step·k, |·| ≤ bound ≤ 1/4 (up to 9
        significant bits): their bf16 roundings stay on it, so a product of
        two is a multiple of 2^-22 and a sum of C of them, below
        C·bound² < 4 = 2^24·2^-22, is exact in f32 in any order."""
        bound = 0.25
        while shape[-1] * bound ** 2 >= 4:
            bound /= 2
        u = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        return torch.round(u * bound / step) * step

    def shown_to_round(name, label, got16, got32, ref16):
        """A bf16 instance at least 1e-3·max|ref| from its f32 instance."""
        gap, top = float((got16 - got32).abs().max()), float(ref16.abs().max())
        if gap < 1e-3 * top:
            raise SystemExit(f"FAIL {name} {label}: only {gap:.3e} from the f32 instance "
                             f"(max |ref| {top:.3e})")
        return gap / top

    parts = ("d a_dst", "d a_src", "d v")

    def check_dense(tag, msk, index, B, H, C, verbose=False):
        """All four kernels at one shape (the factored pair at D = C + 1),
        random cotangents; and the softmax pair's bf16 instances. Returns the
        operands."""
        n_ = msk.shape[0]
        a_d, a_s, (v, d_out, _, _) = operands(B, n_, H, C)
        _, _, (rv, rq, g_pv, g_nq) = operands(B, n_, H, C + 1)
        label = f"{tag} B{B} H{H} C{C}"
        out32 = ga.fused_attention_fwd(a_d, a_s, v, msk, 0.2, index)
        held("fused_attention", f"fused_attention {label}", out32,
             ga.fused_attention_plain(a_d, a_s, v, msk, 0.2), verbose)
        bwd32 = ga.fused_attention_bwd(a_d, a_s, v, msk, d_out, 0.2, index)
        for part, g, r in zip(parts, bwd32,
                              ga.fused_attention_bwd_plain(a_d, a_s, v, msk, d_out, 0.2)):
            held("fused_attention_bwd", f"fused_attention_bwd {label} {part}", g, r, verbose)
        # the bf16 instances: the forward on the random v, which both round; the
        # backward against its plain version on v and dO on a grid where every dp
        # is exact in f32, so both round the same dp to bf16 (on the random
        # operands the two sums' last bits may differ and land a rounding a bf16
        # step apart); each at least 1e-3·max|ref| from its f32 instance
        ref16 = ga.fused_attention_plain(a_d, a_s, v, msk, 0.2, bf16=True)
        out16 = ga.fused_attention_fwd(a_d, a_s, v, msk, 0.2, index, bf16=True)
        held("fused_attention_bf16", f"fused_attention bf16 {label}", out16, ref16, verbose)
        gaps = [shown_to_round("fused_attention_bf16", label, out16, out32, ref16)]
        vg, dg = grid(v.shape), grid(v.shape)
        for part, g, r in zip(parts, ga.fused_attention_bwd(a_d, a_s, vg, msk, dg, 0.2, index,
                                                            bf16=True),
                              ga.fused_attention_bwd_plain(a_d, a_s, vg, msk, dg, 0.2, bf16=True)):
            held("fused_attention_bwd_bf16", f"fused_attention_bwd bf16 {label} {part} (grid)", g,
                 r, verbose)
        for part, g16, g32 in zip(parts, ga.fused_attention_bwd(a_d, a_s, v, msk, d_out, 0.2,
                                                                index, bf16=True), bwd32):
            gaps.append(shown_to_round("fused_attention_bwd_bf16", f"{label} {part}", g16, g32,
                                       g16))
        dense_gaps[label] = min(gaps)
        for part, g, r in zip(("t_pv", "t_nq"), ga.fused_factored_fwd(a_d, a_s, rv, rq, msk, index),
                              ga.fused_factored_plain(a_d, a_s, rv, rq, msk)):
            held("fused_factored", f"fused_factored {label} {part}", g, r, verbose)
        for part, g, r in zip(("d rhs_v", "d rhs_q"),
                              ga.fused_factored_bwd(a_d, a_s, msk, g_pv, g_nq, index),
                              ga.fused_factored_bwd_plain(a_d, a_s, msk, g_pv, g_nq)):
            held("fused_factored_bwd", f"fused_factored_bwd {label} {part}", g, r, verbose)
        return a_d, a_s, v, d_out, rv, rq, g_pv, g_nq

    shapes = ((2, 32), (1, 32), (2, 128), (1, 128))     # conv1, conv2 of small; of large
    dense_gaps = {}
    for H, C in shapes:
        check_dense("synthctown", mask, ix, 1, H, C)
    # a one-way mask with rows and columns of more than 32 entries; C past one
    # 256-channel tile; D 34; H past a head group of the factored walk (32 gate
    # bits a word); B 1
    rmask = rng.random((70, 70)) < 0.6
    np.fill_diagonal(rmask, True)
    rmask_t = torch.as_tensor(rmask, device=dev)
    for B, H, C in ((3, 2, 5), (2, 1, 300), (2, 3, 33), (2, 33, 4), (2, 40, 4), (1, 34, 3),
                    (1, 2, 128)):
        check_dense("ragged", rmask_t, None, B, H, C)      # index built from the mask's values
    torch.cuda.synchronize()
    print(f"  B 1 and ragged shapes: all within atol/rtol 1e-4; the softmax pair's bf16 instances "
          f"(forward on random v, backward on grid v and dO) within "
          f"{max_err['fused_attention_bf16']:.3e} / {max_err['fused_attention_bwd_bf16']:.3e} of "
          f"their bf16 plain versions and at least {min(dense_gaps.values()):.2e}·max|ref| from "
          f"their f32 instances")

    # ---- 9: the synthctown fixture ------------------------------------------
    print("[9] synthctown fixture: GATRes-small against the JAX values")
    npz = os.path.join(REPO, "artifacts", "parity_train_synthctown.npz")
    fx = np.load(npz)
    stats = NormStats(norm_type="znorm", mean=float(fx["stats_mean"]), std=float(fx["stats_std"]))

    def fixture_model(attn_impl="factored", path=npz, attn_dtype=None):
        m = GATRes(int(fx["num_blocks"]), int(fx["nc"]), attn_impl=attn_impl, attn_dtype=attn_dtype)
        m.load_state_dict(params_from_parity_npz(path))
        return m.to(dev)

    model = fixture_model().eval()
    graph = tpl.batch(1, device=dev)
    acts = {}
    hooks = [blk.register_forward_hook(lambda m, i, o, k=k: acts.__setitem__(k, o))
             for k, blk in enumerate(model.blocks)]
    reset_launches()
    with torch.inference_mode():
        out = model(torch.as_tensor(fx["x_in"], device=dev), graph)
        torch.cuda.synchronize()
    fwd_launches = read_launches()
    for h in hooks:
        h.remove()
    if fwd_launches != counts(fused_factored=30):
        raise SystemExit(f"FAIL launches per dense forward {fwd_launches}")
    block_err = max(check_close(f"synthctown block {k}", a.cpu(),
                                torch.as_tensor(fx[f"ours_act_block_{k}"]), 1e-3, 0.0, verbose=False)
                    for k, a in sorted(acts.items()))
    out_err = check_close("synthctown output", out.cpu(), torch.as_tensor(fx["ours_out"]), 1e-3, 0.0,
                          verbose=False)
    print(f"  forward vs JAX ({bytes(fx['path']).decode()} path): worst block {block_err:.3e}, output "
          f"{out_err:.3e}; launches {fwd_launches['fused_factored']}")

    names = [k for k, _ in model.named_parameters()]
    xb1 = fx["x"][:, 0][None, :]

    def fixture_step(attn_impl="factored", path=npz, attn_dtype=None):
        tr = Trainer(fixture_model(attn_impl, path, attn_dtype),
                     MODEL_REGISTRY["gatres_small"].train_config(batch_size=1), stats, tpl, device=dev)
        g1, x1, m1, k1 = tr._prepare(tpl, xb1, fx["mask"], None, None)
        tr.model.train()
        loss, mets, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return tr, float(loss.detach()), mets, grads

    reset_launches()
    tr1, loss1, mets1, grads1 = fixture_step()
    step_launches = read_launches()
    if step_launches != counts(fused_factored=30, fused_factored_bwd=30):
        raise SystemExit(f"FAIL launches per dense train step {step_launches}")
    if abs(loss1 - float(fx["loss"])) > 1e-4 * abs(float(fx["loss"])):
        raise SystemExit(f"FAIL train loss {loss1!r} against the fixture's {float(fx['loss'])!r}")
    for k, v in mets1.items():
        # corr and r2 of an untrained model (a nearly constant output) are small
        # differences of f32 moment sums: atol 1e-3 there, 1e-4 elsewhere
        ref, atol = float(fx[f"metric_{k}"]), 1e-3 if k in ("train_corr", "train_r2") else 1e-4
        if abs(float(v) - ref) > 1e-3 * abs(ref) + atol:
            raise SystemExit(f"FAIL train metric {k}: {float(v)!r} against {ref!r}")
    worst = grads_within("synthctown B 1 step vs JAX", names, grads1,
                         [torch.as_tensor(fx[f"grad_{k}"], device=dev) for k in names])
    losses3 = [float(tr1.train_step(tpl, xb1, mask=fx["mask"])[0]) for _ in range(3)]
    perr = max(float((p.detach().cpu() - torch.as_tensor(fx[f"p3_{k}"])).abs().max())
               for k, p in tr1.model.named_parameters() if f"p3_{k}" in fx.files)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses3, fx["step_losses"]))
    if perr > 3e-4 or lerr > 1e-3:
        raise SystemExit(f"FAIL after 3 Adam steps: parameters off by {perr:.3e} (atol 3e-4), "
                         f"step losses by {lerr:.3e} relative (1e-3)")
    print(f"  B 1 step vs the JAX Trainer: loss {loss1:.7f} against {float(fx['loss']):.7f}; "
          f"{len(names)} gradients, each within 1e-3·max|g_ref| + 1e-6, the worst at {worst:.1%} of "
          f"it; after 3 Adam steps parameters within {perr:.3e}, step losses within {lerr:.3e} "
          f"relative; launches per step {step_launches['fused_factored']} + "
          f"{step_launches['fused_factored_bwd']}")
    reset_launches()
    with bops.plain_versions():
        _, loss_p, _, grads_p = fixture_step()
    if any(read_launches().values()):
        raise SystemExit("FAIL the plain dense step launched a kernel")
    worst_p = grads_within("dense kernel step vs plain step", names, grads1, grads_p)
    print(f"  kernel step vs plain step on the card: loss {loss1:.7f} / {loss_p:.7f}, gradients "
          f"within the same bound, the worst at {worst_p:.1%} of it")
    del tr1, grads1, grads_p

    # ---- 10: serving ---------------------------------------------------------
    print("[10] serving synthctown through Inferencer")
    sstats = NormStats(norm_type="znorm", mean=40.0, std=15.0)
    bs, n_snaps = 32, 64
    n_batches = n_snaps // bs
    snaps = rng.standard_normal((n_snaps, n)).astype(np.float32)
    serve_launches, serve_ms, models = {}, {}, {}
    for preset, per_forward in (("gatres_small", 30), ("gatres_large", 50)):
        smodel, _ = select_model(preset, device=dev, seed=0)
        models[preset] = smodel
        inf = Inferencer(smodel, sstats, device=dev)
        obs = inf.observed_indices(tpl, "random", mask_rate=0.95, seed=0)
        inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs)          # warm-up
        torch.cuda.synchronize()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs, with_truth=True)
        end.record()
        end.synchronize()
        got = read_launches()
        if got != counts(fused_factored=n_batches * per_forward):
            raise SystemExit(f"FAIL {preset} serving launches {got}")
        if res.pred.shape != snaps.shape or not np.isfinite(res.pred).all():
            raise SystemExit(f"FAIL {preset} serving output is not a finite [S, n] field")
        with bops.plain_versions():
            ref = inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs)
        err = check_close(f"{preset} served batch vs plain versions", torch.as_tensor(res.pred[:bs]),
                          torch.as_tensor(ref.pred), 1e-3, 1e-4, verbose=False)
        serve_launches[preset] = got["fused_factored"]
        serve_ms[preset] = start.elapsed_time(end) / n_batches
        print(f"  {preset}: {n_snaps} snapshots, batch {bs}, {len(obs)} observed of {n}: "
              f"{serve_ms[preset]:.3f} ms per batch ({bs / serve_ms[preset] * 1e3:.0f} snapshots/s); "
              f"{per_forward} fused_factored launches a forward; first batch within {err:.3e} m of "
              f"the plain versions' (fields of {sstats.mean:.0f} ± {sstats.std:.0f} m)")
        profile_batch(lambda: inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs),
                      f"one {preset} serving batch", top=10)

    # ---- 11: training ----------------------------------------------------------
    print("[11] training GATRes-small on synthctown through Trainer.fit")
    tbs, n_train, n_val = 32, 128, 64
    arr = rng.standard_normal((n_train + n_val, n)).astype(np.float32)
    mk_ds = lambda a: WDNDataset.from_members([_Member(tpl, a, [], None)], sstats)  # noqa: E731

    def small_trainer(preset="gatres_small", **kw):
        m, ps = select_model(preset, device=dev, seed=0)
        return Trainer(m, ps.train_config(batch_size=tbs, mask_rate=0.95, seed=0, **kw), sstats, tpl,
                       device=dev)

    epochs_log = []
    with tempfile.TemporaryDirectory() as dir_full, tempfile.TemporaryDirectory() as dir_cut:
        trn = small_trainer(epochs=2, save_path=dir_full)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        best = trn.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: print("  " + m),
                       on_epoch_end=lambda ep, m: epochs_log.append(m))
        torch.cuda.synchronize()
        fit_launches = read_launches()
        n_tr, n_ev = 2 * (n_train // tbs), 2 * (n_val // tbs)
        if fit_launches != counts(fused_factored=30 * (n_tr + n_ev), fused_factored_bwd=30 * n_tr):
            raise SystemExit(f"FAIL dense fit launches {fit_launches}")
        tl = [m["train_loss"] for m in epochs_log]
        vl = [m["val_loss"] for m in epochs_log]
        if len(tl) != 2 or not np.isfinite(tl + vl).all() or tl[1] >= 1.5 * tl[0]:
            raise SystemExit(f"FAIL dense fit diverged or stopped: train {tl}, val {vl}")
        params, opt_state, meta = load_checkpoint(
            os.path.join(dir_full, "last_gatres_small.ckpt"), trn.model.state_dict(),
            trn.opt_state_dict())
        if meta["epoch"] != 2 or opt_state is None or any(
                not torch.equal(params[k], v.cpu()) for k, v in trn.model.state_dict().items()):
            raise SystemExit("FAIL the last checkpoint does not hold the model's parameters")
        # one epoch, then a new trainer restores 'last' and runs the second: the
        # backwards use no atomics, so it must end where the uninterrupted run did
        small_trainer(epochs=1, save_path=dir_cut).fit(
            mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: None)
        resumed = small_trainer(epochs=2, save_path=dir_cut)
        resumed.restore(os.path.join(dir_cut, "last_gatres_small.ckpt"))
        resumed.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: None)
        torch.cuda.synchronize()
        sa, sb = trn.opt_state_dict(), resumed.opt_state_dict()
        same = (all(torch.equal(a, b) for a, b in zip(trn.model.state_dict().values(),
                                                     resumed.model.state_dict().values()))
                and sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa))
        if not same:
            raise SystemExit("FAIL the resumed dense run did not end bit-identical")
    print(f"  fit: 2 epochs, batch {tbs}, {n_train} train + {n_val} val snapshots: train loss {tl}, "
          f"val loss {vl}, best epoch {best['epoch']}, {best['train_time_s']:.2f} s; launches "
          f"{fit_launches['fused_factored']} forward, {fit_launches['fused_factored_bwd']} backward; "
          f"checkpoint reloaded; resumed from epoch 1 and ended bit-identical")
    batch = arr[:tbs]
    tgen = torch.Generator().manual_seed(0)
    train_ms, train_peak = {}, {}
    for preset, blocks in (("gatres_small", 15), ("gatres_large", 25)):
        tr = trn if preset == "gatres_small" else small_trainer(preset)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        tr.train_step(tpl, batch, generator=tgen)
        torch.cuda.synchronize()
        got = read_launches()
        if got != counts(fused_factored=2 * blocks, fused_factored_bwd=2 * blocks):
            raise SystemExit(f"FAIL {preset} launches per train step {got}")
        train_ms[preset] = cuda_ms(lambda: tr.train_step(tpl, batch, generator=tgen), 5, 30)
        train_peak[preset] = torch.cuda.max_memory_allocated() / 1e9
        edges = tbs * blocks * (2 * (tpl.n_edge + n) + tpl.n_edge)
        print(f"  {preset} train step at batch {tbs}: {train_ms[preset]:.3f} ms "
              f"({edges / train_ms[preset] * 1e3:.0f} message edges/s: batch · blocks · "
              f"(2·(E + N) + E)), peak device memory {train_peak[preset]:.3f} GB; launches "
              f"{2 * blocks} + {2 * blocks}")
        profile_batch(lambda: tr.train_step(tpl, batch, generator=tgen),
                      f"one {preset} train step", top=14)
        del tr
    del trn, resumed

    # ---- 12: attn_impl="softmax" ------------------------------------------------
    print('[12] attn_impl="softmax": the softmax fixtures, then GATRes-small and -large through '
          'fused_attention, f32 and bf16')

    def fixture_forward(path, attn_dtype, want):
        """Per-block and output deviations from the fixture at ``path`` of
        GATRes-small through softmax, and the launches of that forward."""
        f = np.load(path)
        m = fixture_model("softmax", path, attn_dtype).eval()
        acts = {}
        hooks = [blk.register_forward_hook(lambda m_, i, o, k=k: acts.__setitem__(k, o))
                 for k, blk in enumerate(m.blocks)]
        reset_launches()
        with torch.inference_mode():
            out = m(torch.as_tensor(f["x_in"], device=dev), tpl.batch(1, device=dev))
            torch.cuda.synchronize()
        launched = read_launches()
        for h in hooks:
            h.remove()
        if launched != want or not torch.isfinite(out).all():
            raise SystemExit(f"FAIL softmax fixture forward: launches {launched}, finite "
                             f"{bool(torch.isfinite(out).all())}")
        blocks = [float((a.cpu() - torch.as_tensor(f[f"ours_act_block_{k}"])).abs().max())
                  for k, a in sorted(acts.items())]
        return blocks, float((out.cpu() - torch.as_tensor(f["ours_out"])).abs().max())

    # (a) the f32 fixture (the JAX layer's XLA branch): per block and the B 1 step at the gates
    snpz = os.path.join(REPO, "artifacts", "parity_train_synthctown_softmax.npz")
    sfx = np.load(snpz)
    blocks, out_err = fixture_forward(snpz, None, counts(fused_attention=30))
    if max(blocks + [out_err]) > 1e-3:
        raise SystemExit(f"FAIL softmax fixture forward: worst block {max(blocks):.3e}, output "
                         f"{out_err:.3e} (1e-3)")
    reset_launches()
    trs, loss_s1, mets_s1, grads_s1 = fixture_step("softmax", snpz)
    launched = read_launches()
    if launched != counts(fused_attention=30, fused_attention_bwd=30):
        raise SystemExit(f"FAIL launches per softmax fixture step {launched}")
    if abs(loss_s1 - float(sfx["loss"])) > 1e-4 * abs(float(sfx["loss"])):
        raise SystemExit(f"FAIL softmax fixture loss {loss_s1!r} against {float(sfx['loss'])!r}")
    for k, v in mets_s1.items():
        ref, atol = float(sfx[f"metric_{k}"]), 1e-3 if k in ("train_corr", "train_r2") else 1e-4
        if abs(float(v) - ref) > 1e-3 * abs(ref) + atol:
            raise SystemExit(f"FAIL softmax fixture metric {k}: {float(v)!r} against {ref!r}")
    worst = grads_within("softmax fixture B 1 step vs JAX", names, grads_s1,
                         [torch.as_tensor(sfx[f"grad_{k}"], device=dev) for k in names])
    losses3 = [float(trs.train_step(tpl, xb1, mask=sfx["mask"])[0]) for _ in range(3)]
    perr, pnoise = adam_param_errors(trs.model.named_parameters(), sfx)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses3, sfx["step_losses"]))
    if perr > 3e-4 or pnoise > 3 * 2 * 5e-4 or lerr > 1e-3:
        raise SystemExit(f"FAIL softmax fixture after 3 Adam steps: parameters off by {perr:.3e} "
                         f"(3e-4; {pnoise:.3e} where the gradient is noise, 3e-3), step losses by "
                         f"{lerr:.3e} relative (1e-3)")
    print(f"  f32 fixture ({bytes(sfx['path']).decode()} branch): worst block {max(blocks):.3e}, "
          f"output {out_err:.3e}; B 1 step loss {loss_s1:.7f} against {float(sfx['loss']):.7f}, "
          f"{len(names)} gradients within 1e-3·max|g_ref| + 1e-6, the worst at {worst:.1%}; after "
          f"3 Adam steps parameters within {perr:.3e} ({pnoise:.3e} where the first gradient is "
          f"below its tolerance), step losses within {lerr:.3e}; launches 30 + 30")
    del trs, grads_s1

    # (b) the bf16 fixture: a rounding that the two packages' f32 sums put on either
    # side of a bf16 boundary (a flip) moves a value by 2^-8 of its size, and every
    # conv rounds its output: reported beside the f32 model's distance from it, the
    # blocks before the first flip the CPU shows (tools/bf16_flips.py) held to 1e-3,
    # and the run fails on a loss no nearer the bf16 fixture than the f32 fixture's
    bnpz = os.path.join(REPO, "artifacts", "parity_train_synthctown_softmax_bf16.npz")
    bfx = np.load(bnpz)
    b16, out16 = fixture_forward(bnpz, torch.bfloat16, counts(fused_attention_bf16=30))
    b32, out32 = fixture_forward(bnpz, None, counts(fused_attention=30))
    if max(b16[:BF16_FLIP_FREE_BLOCKS]) > 1e-3:
        raise SystemExit(f"FAIL bf16 softmax fixture: blocks 0-{BF16_FLIP_FREE_BLOCKS - 1} off by "
                         f"{max(b16[:BF16_FLIP_FREE_BLOCKS]):.3e} (1e-3)")
    first = next((k for k, e in enumerate(b16) if e > 1e-3), None)
    reset_launches()
    trb, loss_b1, _, grads_b1 = fixture_step("softmax", bnpz, torch.bfloat16)
    launched = read_launches()
    if launched != counts(fused_attention_bf16=30, fused_attention_bwd_bf16=30):
        raise SystemExit(f"FAIL launches per bf16 softmax fixture step {launched}")
    if not all(torch.isfinite(g).all() for g in grads_b1):
        raise SystemExit("FAIL bf16 softmax fixture step: non-finite gradients")
    l16, l32 = float(bfx["loss"]), float(sfx["loss"])
    if abs(loss_b1 - l16) >= abs(l32 - l16):
        raise SystemExit(f"FAIL bf16 softmax fixture loss {loss_b1!r}: no nearer the bf16 "
                         f"fixture's {l16!r} than the f32 fixture's {l32!r} is")
    shares = lambda gs: [float((g - r).abs().max()) / (1e-3 * float(r.abs().max()) + 1e-6)  # noqa: E731
                         for g, r in zip(gs, [torch.as_tensor(bfx[f"grad_{k}"], device=dev)
                                              for k in names])]
    mine = shares(grads_b1)
    theirs = shares([torch.as_tensor(sfx[f"grad_{k}"], device=dev) for k in names])
    print(f"  bf16 fixture: blocks against JAX " + ", ".join(f"{e:.2e}" for e in b16)
          + f" (output {out16:.3e}; " + ("all within 1e-3" if first is None else
          f"within 1e-3 up to block {first - 1}") + f"; blocks 0-{BF16_FLIP_FREE_BLOCKS - 1} held); "
          f"the f32 model's: " + ", ".join(f"{e:.2e}" for e in b32) + f" (output {out32:.3e}); "
          f"B 1 step loss {loss_b1:.7f} against {l16:.7f} ({abs(loss_b1 - l16) / l16:.2e} relative; "
          f"the f32 fixture's {l32:.7f}, {abs(l32 - l16) / l16:.2e}); gradients as shares of "
          f"1e-3·max|g_ref| + 1e-6: {sum(q > 1 for q in mine)} of {len(names)} beyond 1, the worst "
          f"{max(mine):.1%}, the median {float(np.median(mine)):.1%} (the f32 fixture's: "
          f"{sum(q > 1 for q in theirs)} beyond 1, the worst {max(theirs):.1%}); launches 30 + 30")
    del trb, grads_b1
    torch.cuda.empty_cache()

    # (c) serving and a train step at batch 32: small and large, f32 and bf16, timed
    # in turns; each f32 batch and small's f32 step held against the plain versions
    smask = rng.random((tbs, n)).argsort(1) < int(n * 0.95)
    soft_serve, soft_step_launch, soft_ms_by, serve_by = {}, {}, {}, {}
    fwd_of = {None: "fused_attention", torch.bfloat16: "fused_attention_bf16"}
    bwd_of = {None: "fused_attention_bwd", torch.bfloat16: "fused_attention_bwd_bf16"}
    for preset, blocks, nc in (("gatres_small", 15, 32), ("gatres_large", 25, 128)):
        def soft_model(dtype):
            m = GATRes(blocks, nc, attn_impl="softmax", attn_dtype=dtype)
            m.load_state_dict(models[preset].state_dict())
            return m

        def soft_trainer(dtype):
            return Trainer(soft_model(dtype), MODEL_REGISTRY[preset].train_config(batch_size=tbs),
                           sstats, tpl, device=dev)

        def soft_grads(tr):
            g1, x1, m1, k1 = tr._prepare(tpl, batch, smask.reshape(-1), None, None)
            tr.model.train()
            loss, _, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
            grads = torch.autograd.grad(loss, list(tr.model.parameters()))
            torch.cuda.synchronize()
            return float(loss.detach()), grads

        infs = {d: Inferencer(soft_model(d), sstats, device=dev) for d in fwd_of}
        obs = infs[None].observed_indices(tpl, "random", mask_rate=0.95, seed=0)
        preds = {}
        for d, inf in infs.items():
            reset_launches()
            preds[d] = inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs).pred
            got = read_launches()
            if got != counts(**{fwd_of[d]: 2 * blocks}):
                raise SystemExit(f"FAIL softmax {preset} {d} serving launches {got}")
            soft_serve[(preset, d)] = got[fwd_of[d]]
            if preds[d].shape != (bs, n) or not np.isfinite(preds[d]).all():
                raise SystemExit(f"FAIL softmax {preset} {d} serving output is not a finite field")
        with bops.plain_versions():
            pred_p = infs[None].infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs).pred
        err = check_close(f"softmax {preset} served batch vs plain versions",
                          torch.as_tensor(preds[None]), torch.as_tensor(pred_p), 1e-3, 1e-4,
                          verbose=False)
        pred_f = Inferencer(models[preset], sstats, device=dev).infer(
            tpl, snaps[:bs], obs, scaled=True, batch_size=bs).pred
        trs = {d: soft_trainer(d) for d in fwd_of}
        for d, tr in trs.items():
            reset_launches()
            loss_d, grads_d = soft_grads(tr)
            got = read_launches()
            if got != counts(**{fwd_of[d]: 2 * blocks, bwd_of[d]: 2 * blocks}):
                raise SystemExit(f"FAIL softmax {preset} {d} train step launches {got}")
            if not all(torch.isfinite(g).all() for g in grads_d):
                raise SystemExit(f"FAIL softmax {preset} {d} train step: non-finite gradients")
            soft_step_launch[(preset, d)] = got
            if d is None and preset == "gatres_small":
                with bops.plain_versions():
                    loss_p, grads_p = soft_grads(soft_trainer(None))
                worst_s = grads_within("softmax kernel step vs plain step",
                                       [k for k, _ in tr.model.named_parameters()], grads_d, grads_p)
            del grads_d
        # in turns: f32, bf16, bf16, f32
        serve_by[preset], soft_ms_by[preset] = {d: [] for d in fwd_of}, {d: [] for d in fwd_of}
        for d in (None, torch.bfloat16, torch.bfloat16, None):
            serve_by[preset][d].append(cuda_ms(lambda: infs[d].infer(
                tpl, snaps, obs, scaled=True, batch_size=bs), 1, 1) / (len(snaps) // bs))
            soft_ms_by[preset][d].append(cuda_ms(
                lambda: trs[d].train_step(tpl, batch, generator=tgen), 2, 5))
        print(f"  {preset}: a serving batch of {bs}: {2 * blocks} fused_attention launches (f32) / "
              f"{2 * blocks} of its bf16 instance; the f32 fields within {err:.3e} m of the plain "
              f"versions', {float(np.abs(preds[None] - pred_f).max()):.3e} m of the factored model's; "
              f"the bf16 fields {float(np.abs(preds[torch.bfloat16] - preds[None]).max()):.3e} m from "
              f"the f32 ones; a train step: {2 * blocks} + {2 * blocks} launches each"
              + (f", the f32 step's gradients within 1e-3·max|g_ref| + 1e-6 of the plain step's, "
                 f"the worst at {worst_s:.1%}" if preset == "gatres_small" else "")
              + f"; ms a serving batch f32 "
              + " / ".join(f"{v:.3f}" for v in serve_by[preset][None]) + ", bf16 "
              + " / ".join(f"{v:.3f}" for v in serve_by[preset][torch.bfloat16])
              + "; ms a step f32 " + " / ".join(f"{v:.3f}" for v in soft_ms_by[preset][None])
              + ", bf16 " + " / ".join(f"{v:.3f}" for v in soft_ms_by[preset][torch.bfloat16])
              + f" (in turns f32, bf16, bf16, f32; {card})")
        del infs, trs
        torch.cuda.empty_cache()
    soft_ms = soft_ms_by["gatres_small"][None][0]

    # ---- 13: kernel times at B 32 -------------------------------------------------
    print(f"[13] dense kernel times at B {bs} on {card}")

    ix_bytes = {"fwd": 4 * (n + 1 + nnz), "bwd": 4 * (n + 1 + 2 * nnz)}
    rows = []
    for H, C in shapes:
        a_d, a_s, v, d_out, rv, rq, g_pv, g_nq = check_dense("synthctown", mask, ix, bs, H, C)
        a_bytes, D = 4 * 2 * bs * n * H, C + 1
        wide = lambda k, w: 4 * k * bs * n * H * w  # noqa: E731  (k tensors [B, n, H, w])
        vb = v.to(torch.bfloat16)          # the bf16 copy of v that the layer's Function saves
        for name, fn, plain, einsum, nbytes, ops in (
            ("fused_attention", lambda: ga.fused_attention_fwd(a_d, a_s, v, mask, 0.2, ix),
             lambda: ga.fused_attention_plain(a_d, a_s, v, mask, 0.2), None,
             a_bytes + wide(2, C) + ix_bytes["fwd"], bs * H * nnz * (2 * C + 6)),
            ("fused_attention_bwd",
             lambda: ga.fused_attention_bwd(a_d, a_s, v, mask, d_out, 0.2, ix),
             lambda: ga.fused_attention_bwd_plain(a_d, a_s, v, mask, d_out, 0.2), None,
             2 * a_bytes + wide(3, C) + ix_bytes["fwd"] + ix_bytes["bwd"],
             bs * H * nnz * (4 * C + 14)),
            # the bf16 instances on the bf16 v: 2-byte v rows, f32 everything else
            ("fused_attention_bf16",
             lambda: ga.fused_attention_fwd(a_d, a_s, vb, mask, 0.2, ix, bf16=True),
             lambda: ga.fused_attention_plain(a_d, a_s, vb, mask, 0.2, bf16=True), None,
             a_bytes + wide(1.5, C) + ix_bytes["fwd"], bs * H * nnz * (2 * C + 6)),
            ("fused_attention_bwd_bf16",
             lambda: ga.fused_attention_bwd(a_d, a_s, vb, mask, d_out, 0.2, ix, bf16=True),
             lambda: ga.fused_attention_bwd_plain(a_d, a_s, vb, mask, d_out, 0.2, bf16=True), None,
             2 * a_bytes + wide(2.5, C) + ix_bytes["fwd"] + ix_bytes["bwd"],
             bs * H * nnz * (4 * C + 14)),
            ("fused_factored", lambda: ga.fused_factored_fwd(a_d, a_s, rv, rq, mask, ix),
             lambda: ga.fused_factored_plain(a_d, a_s, rv, rq, mask),
             lambda: factored_einsum(mask, a_d, a_s, rv, rq),
             a_bytes + wide(4, D) + ix_bytes["fwd"], bs * H * nnz * (D + 1)),
            ("fused_factored_bwd", lambda: ga.fused_factored_bwd(a_d, a_s, mask, g_pv, g_nq, ix),
             lambda: ga.fused_factored_bwd_plain(a_d, a_s, mask, g_pv, g_nq),
             lambda: factored_bwd_einsum(mask, a_d, a_s, g_pv, g_nq),
             a_bytes + wide(4, D) + ix_bytes["bwd"], bs * H * nnz * (D + 1)),
        ):
            t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            split = device_split(fn, 20)
            r = dict(name=name, H=H, C=C, ms=cuda_ms(fn, 5, 50),
                     device_ms=sum(ms for _, ms in split) or None, plain_ms=cuda_ms(plain, 2, 5),
                     einsum_ms=cuda_ms(einsum, 2, 5) if einsum else None, library_ms=None,
                     bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
            if name.endswith("_bf16"):     # the same work with v in f32
                r["bound_f32_ms"] = max(t_ops, (nbytes + wide(0.5, C)) / PEAK_BYTES_S * 1e3)
            rows.append(r)
            dms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
            ein = "" if einsum is None else f", einsum formulation {r['einsum_ms']:.4f} ms"
            b32 = f"; {r['bound_f32_ms']:.5f} ms at f32 v" if "bound_f32_ms" in r else ""
            print(f"  {name} H {H} C {C}: {r['ms']:.4f} ms a call (CUDA events over 50 calls of the "
                  f"wrapper), {dms} on the device, plain {r['plain_ms']:.4f} ms{ein}, library none "
                  f"(no PyTorch call computes a batched gate or mask over an n×n pattern), bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {nbytes / 1e6:.2f} MB{b32})")
            if name == "fused_attention_bwd":     # the band backward's passes on one block
                print("    device ms by pass: " + ", ".join(f"{k} {ms:.4f}" for k, ms in split))
    # the softmax pair's launches in a GATRes-small step: 15 at conv1's shape, 15 at conv2's
    soft_dev = {}
    for name in ("fused_attention", "fused_attention_bwd", "fused_attention_bf16",
                 "fused_attention_bwd_bf16"):
        dev_ms = [r["device_ms"] for r in rows if r["name"] == name and r["C"] == 32]
        soft_dev[name] = None if None in dev_ms else 15 * sum(dev_ms)
        print(f"  {name} in a GATRes-small softmax step: 15 x conv1 + 15 x conv2 = "
              f"{fmt_ms(soft_dev[name])} ms of device time")
    return dict(
        rows=rows, nnz=nnz, n=n, serve_launches=serve_launches, serve_ms=serve_ms,
        fit_launches=fit_launches, train_ms=train_ms, train_peak=train_peak, soft_ms=soft_ms,
        soft_launches={fwd_of[d]: sum(soft_serve[(p_, d)] for p_ in ("gatres_small", "gatres_large"))
                       for d in fwd_of} | {
            bwd_of[d]: sum(soft_step_launch[(p_, d)][bwd_of[d]]
                           for p_ in ("gatres_small", "gatres_large")) for d in fwd_of},
        soft_serve_ms=serve_by, soft_step_ms=soft_ms_by, soft_dev=soft_dev,
        dense_gaps=dense_gaps)



def mega_phases(dev, card, rng, held, reset_launches, read_launches, counts, big):
    """Phases 14-19: the banded path at 23k nodes (meganet) through the
    streaming-softmax band attention, and bigtown through the window band
    attention. ``big`` carries the bigtown template, fixtures and layout.
    Returns the kernel rows and the launch counts of its runs."""
    import tempfile

    from gnn_pressure_estimation_tpu_torch.data.dataset import (
        WDNDataset, _Member, build_template, get_keep_list,
    )
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.presets import MODEL_REGISTRY, select_model
    from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_mega
    from gnn_pressure_estimation_tpu_torch.train import Trainer
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    t0 = time.perf_counter()
    wn = make_mega()
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name="meganet")
    n = tpl.n_node
    bl = tpl.band_layout()
    nB, BLK, W = bl.adj_mask.shape
    n_pad, n_ext = bl.n_pad, bl.n_pad + W - BLK
    mask = torch.as_tensor(bl.adj_mask.view(np.int8), device=dev)
    ix = tpl.band_index("adj_mask").to(dev)
    print(f"[14] meganet: n {n}, edges {tpl.n_edge}, nB {nB}, BLK {BLK}, W {W}, n_pad {n_pad}, "
          f"n_ext {n_ext}, mask nonzeros {ix.nnz} ({bl.adj_mask.mean():.4%} dense), "
          f"{int(ix.empty_row.shape[0])} padded rows; generated, laid out and indexed on the host "
          f"in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def operands(msk, B, H, C):
        """a_dst, a_src_win, x_ext, d_out; a third of the nodes zeroed, so that
        a_dst + a_src == 0 occurs."""
        nB_, BLK_, W_ = msk.shape
        np_, ne_ = nB_ * BLK_, nB_ * BLK_ + W_ - BLK_
        a_dst, a_src = randn(B, np_, H), randn(nB_, B, W_, H)
        a_dst[:, ::3] = 0.0
        a_src[:, :, ::3] = 0.0
        return a_dst, a_src, randn(B, ne_, H, C), randn(B, np_, H, C)

    m_exact = []                                 # the kernel's m equal to the plain row max

    def check_flash(tag, msk, index, B, H, C, verbose=False):
        a_dst, a_src, x_ext, d_out = operands(msk, B, H, C)
        label = f"{tag} B{B} H{H} C{C}"
        own = ba.band_attention_flash_fwd(a_dst, a_src, x_ext, msk, 0.2, index)
        ref = ba.band_attention_flash_plain(a_dst, a_src, x_ext, msk, 0.2)
        for part, g, r in zip(("out", "m", "Z"), own, ref):
            held("band_attention_flash", f"band_attention_flash {label} {part}", g, r, verbose)
        m_exact.append(torch.equal(own[1], ref[1]))
        out, m, Z = ref
        delta = (d_out * out).sum(dim=-1)
        ref = ba.band_attention_flash_bwd_plain(a_dst, a_src, x_ext, msk, m, Z, delta, d_out, 0.2)
        got = ba.band_attention_flash_bwd(a_dst, a_src, x_ext, msk, m, Z, delta, d_out, 0.2, index)
        # and from the kernel's own out, m, Z: the statistics the model's path hands over
        mine = ba.band_attention_flash_bwd(a_dst, a_src, x_ext, msk, own[1], own[2],
                                           (d_out * own[0]).sum(dim=-1), d_out, 0.2, index)
        for part, g, g2, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, mine, ref):
            held("band_attention_flash_bwd", f"band_attention_flash_bwd {label} {part}", g, r,
                 verbose)
            held("band_attention_flash_bwd",
                 f"band_attention_flash_bwd {label} {part}, from the kernel's out, m, Z", g2, r,
                 verbose)
        return a_dst, a_src, x_ext, d_out, m, Z, delta

    win_da_equal = []                            # the window backward's d a's equal v2's
    win_fwd_equal = []                           # shapes where the window forward equals v2's

    def check_window(tag, msk, index, B, H, C, verbose=False):
        """The window pair against its plain versions; the forward also
        against v2's on the x_ext the windows were cut from, bit for bit (one
        row walk: the run fails otherwise); the backward against v2's there:
        the same d a_dst and d a_src_win (bit for bit, recorded), and d x_ext
        the fold of d x_win (1e-4)."""
        a_dst, a_src, x_ext, d_out = operands(msk, B, H, C)
        x_win = bops.band_windows_ext(x_ext, *msk.shape)
        label = f"{tag} B{B} H{H} C{C}"
        win = ba.band_attention_window_fwd(a_dst, a_src, x_win, msk, 0.2, index)
        held("band_attention_window", f"band_attention_window {label}", win,
             ba.band_attention_window_plain(a_dst, a_src, x_win, msk, 0.2), verbose)
        check_equal(f"band_attention_window {label} vs band_attention_fwd on the x_ext its windows "
                    f"were cut from", win, ba.band_attention_fwd(a_dst, a_src, x_ext, msk, 0.2, index))
        win_fwd_equal.append(label)
        del win
        got = ba.band_attention_window_bwd(a_dst, a_src, x_win, msk, d_out, 0.2, index)
        ref = ba.band_attention_window_bwd_plain(a_dst, a_src, x_win, msk, d_out, 0.2)
        for part, g, r in zip(("d a_dst", "d a_src_win", "d x_win"), got, ref):
            held("band_attention_window_bwd", f"band_attention_window_bwd {label} {part}", g, r,
                 verbose)
        v2 = ba.band_attention_bwd(a_dst, a_src, x_ext, msk, d_out, 0.2, index)
        win_da_equal.append(torch.equal(got[0], v2[0]) and torch.equal(got[1], v2[1]))
        check_close(f"band_attention_window_bwd {label} folded d x_win vs band_attention_bwd's d x_ext",
                    bops.fold_windows_ext(got[2], msk.shape[1]), v2[2], TOL, TOL, verbose)
        return a_dst, a_src, x_win, d_out, x_ext

    # B 1 is the batch of the fixture steps (phases 16 and 18), B 2 of the meganet
    # train step; the serving batches are held in phase 19, before they are timed
    for B in (1, 2):
        for H in (2, 1):
            check_flash("meganet", mask, ix, B, H, 128, verbose=True)
            check_window("bigtown", big["mask"], big["mask_ix"], B, H, 128, verbose=True)
    rmask = rng.random((3, 16, 70)) < 0.3
    rmask[-1, -5:] = False                       # fully masked (padded) rows
    wide = rng.random((2, 16, 200)) < 0.4        # rows of ~80 entries: three chunks of 32
    for m_np in (rmask, wide):
        m_t = torch.as_tensor(m_np.view(np.int8), device=dev)
        for B, H, C in ((3, 2, 32), (2, 1, 300), (2, 3, 33)):
            check_flash("ragged", m_t, None, B, H, C)      # index built from the mask's values
            check_window("ragged", m_t, None, B, H, C)
    torch.cuda.synchronize()
    print("  ragged shapes: all within atol/rtol 1e-4")
    print(f"  band_attention_window's output equal to band_attention_fwd's on the x_ext the windows "
          f"were cut from, bit for bit, at all {len(win_fwd_equal)} shapes (padded rows included)")
    print(f"  band_attention_window_bwd's d a_dst and d a_src_win equal band_attention_bwd's on the "
          f"x_ext the windows were cut from, bit for bit, at every shape: {all(win_da_equal)} "
          f"({sum(win_da_equal)} of {len(win_da_equal)})")

    # ---- 15: routing ------------------------------------------------------------
    routes = {"meganet": tpl.batch(1, device=dev).band_attn,
              "bigtown": big["tpl"].batch(1, device=dev).band_attn}
    if routes != {"meganet": "flash", "bigtown": "dma"}:
        raise SystemExit(f"FAIL routing {routes}")
    print(f"[15] routing with no argument: {routes}")

    # ---- 16: the meganet fixture ------------------------------------------------
    npz = os.path.join(REPO, "artifacts", "parity_train_meganet.npz")
    fx = np.load(npz)
    depth = int(fx["num_blocks"])
    print(f"[16] meganet fixture: GATRes nc {int(fx['nc'])}, {depth} blocks, against the JAX values "
          f"({bytes(fx['path']).decode()} path)")
    stats = NormStats(norm_type="znorm", mean=float(fx["stats_mean"]), std=float(fx["stats_std"]))

    def fixture_model():
        m = GATRes(depth, int(fx["nc"]), attn_impl="factored")
        m.load_state_dict(params_from_parity_npz(npz))
        return m.to(dev)

    model = fixture_model().eval()
    graph = tpl.batch(1, device=dev)
    acts = {}
    hooks = [blk.register_forward_hook(lambda m, i, o, k=k: acts.__setitem__(k, o))
             for k, blk in enumerate(model.blocks)]
    reset_launches()
    with torch.inference_mode():
        out = graph.unpack_nodes(
            model(graph.pack_nodes(torch.as_tensor(fx["x_in"], device=dev), n), graph), n)
        torch.cuda.synchronize()
    got = read_launches()
    for h in hooks:
        h.remove()
    if got != counts(band_attention_flash=2 * depth, band_spmm=depth):
        raise SystemExit(f"FAIL launches per meganet fixture forward {got}")
    out_err = check_close("meganet fixture output", out.cpu(), torch.as_tensor(fx["ours_out"]),
                          1e-3, 0.0, verbose=False)
    real = [graph.unpack_nodes(acts[k], n) for k in range(depth)]
    amax = np.array([float(a.abs().max()) for a in real])
    mean = np.array([float(a.double().mean()) for a in real])
    stat_err = max(np.abs(amax - fx["block_absmax"]).max(), np.abs(mean - fx["block_mean"]).max())
    if stat_err > 1e-3:
        raise SystemExit(f"FAIL meganet block statistics off by {stat_err:.3e}")
    print(f"  forward vs JAX: output within {out_err:.3e}, per-block |act| max and mean within "
          f"{stat_err:.3e}; launches {got['band_attention_flash']} + {got['band_spmm']}")
    names = [k for k, _ in model.named_parameters()]
    xb1 = fx["x"][:, 0][None, :]

    def fixture_step():
        tr = Trainer(fixture_model(), MODEL_REGISTRY["gatres_large"].train_config(batch_size=1),
                     stats, tpl, device=dev)
        g1, x1, m1, k1 = tr._prepare(tpl, xb1, fx["mask"], None, None)
        tr.model.train()
        loss, mets, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return tr, float(loss.detach()), mets, grads

    reset_launches()
    tr1, loss1, mets1, grads1 = fixture_step()
    got = read_launches()
    if got != counts(band_attention_flash=2 * depth, band_spmm=depth,
                     band_attention_flash_bwd=2 * depth, band_spmm_bwd=depth):
        raise SystemExit(f"FAIL launches per meganet fixture step {got}")
    if abs(loss1 - float(fx["loss"])) > 1e-4 * abs(float(fx["loss"])):
        raise SystemExit(f"FAIL train loss {loss1!r} against the fixture's {float(fx['loss'])!r}")
    for k, v in mets1.items():
        ref, atol = float(fx[f"metric_{k}"]), 1e-3 if k in ("train_corr", "train_r2") else 1e-4
        if abs(float(v) - ref) > 1e-3 * abs(ref) + atol:
            raise SystemExit(f"FAIL train metric {k}: {float(v)!r} against {ref!r}")
    worst = grads_within("meganet B 1 step vs JAX", names, grads1,
                         [torch.as_tensor(fx[f"grad_{k}"], device=dev) for k in names])
    losses3 = [float(tr1.train_step(tpl, xb1, mask=fx["mask"])[0]) for _ in range(3)]
    perr, pnoise = adam_param_errors(tr1.model.named_parameters(), fx)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses3, fx["step_losses"]))
    if perr > 3e-4 or pnoise > 3 * 2 * 5e-4 or lerr > 1e-3:
        raise SystemExit(f"FAIL after 3 Adam steps: parameters off by {perr:.3e} (atol 3e-4; "
                         f"{pnoise:.3e} where the gradient is noise, bound 3e-3), step losses by "
                         f"{lerr:.3e} relative (1e-3)")
    print(f"  B 1 step vs the JAX Trainer: loss {loss1:.7f} against {float(fx['loss']):.7f}; "
          f"{len(names)} gradients, each within 1e-3·max|g_ref| + 1e-6, the worst at {worst:.1%} of "
          f"it; after 3 Adam steps parameters within {perr:.3e} ({pnoise:.3e} where the first "
          f"gradient is below its tolerance), step losses within {lerr:.3e} relative")
    del tr1, grads1, model, acts, real
    torch.cuda.empty_cache()

    # ---- 17: meganet at full depth and width ---------------------------------
    print("[17] meganet, GATRes-large (25 blocks, nc 128), seeded weights")
    sstats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    smodel, preset = select_model("gatres_large", device=dev, seed=0)
    inf = Inferencer(smodel, sstats, device=dev)
    bs, n_snaps = 8, 16
    n_batches = n_snaps // bs
    snaps = rng.standard_normal((n_snaps, n)).astype(np.float32)
    obs = inf.observed_indices(tpl, "random", mask_rate=0.95, seed=0)
    inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs, with_truth=True)
    end.record()
    end.synchronize()
    serve_launches = read_launches()
    if serve_launches != counts(band_attention_flash=n_batches * 50, band_spmm=n_batches * 25):
        raise SystemExit(f"FAIL meganet serving launches {serve_launches}")
    if res.pred.shape != snaps.shape or not np.isfinite(res.pred).all():
        raise SystemExit("FAIL meganet serving output is not a finite [S, n] field")
    serve_ms = start.elapsed_time(end) / n_batches
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    with bops.plain_versions():
        ref = inf.infer(tpl, snaps[:2], obs, scaled=True, batch_size=2)
    got2 = inf.infer(tpl, snaps[:2], obs, scaled=True, batch_size=2)
    err = check_close("meganet served fields vs plain versions", torch.as_tensor(got2.pred),
                      torch.as_tensor(ref.pred), 1e-3, 1e-4, verbose=False)
    print(f"  serving: {n_snaps} snapshots, batch {bs}, {len(obs)} observed of {n}: {serve_ms:.3f} ms "
          f"per batch ({bs / serve_ms * 1e3:.1f} snapshots/s, "
          f"{bs * tpl.n_edge / serve_ms * 1e3:.0f} edges/s), peak device memory {serve_peak:.3f} GB; "
          f"50 band_attention_flash + 25 band_spmm launches a forward, 0 of band_attention; two "
          f"fields within {err:.3e} m of the plain versions'")
    profile_batch(lambda: inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs),
                  "one meganet serving batch", top=10)

    tbs, n_train, n_val = 2, 8, 4
    arr = rng.standard_normal((n_train + n_val, n)).astype(np.float32)
    tmask = (rng.random((tbs, n)).argsort(1) < int(n * 0.95)).reshape(-1)
    pnames = [k for k, _ in smodel.named_parameters()]

    def mega_trainer(remat=False, **kw):
        m = GATRes(25, 128, attn_impl="factored", remat=remat)
        m.load_state_dict(smodel.state_dict())
        return Trainer(m, preset.train_config(batch_size=tbs, mask_rate=0.95, seed=0, **kw), sstats,
                       tpl, device=dev)

    def one_step(remat=False):
        tr = mega_trainer(remat)
        g1, x1, m1, k1 = tr._prepare(tpl, arr[:tbs], tmask, None, None)
        tr.model.train()
        torch.cuda.reset_peak_memory_stats()
        loss, _, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return float(loss.detach()), grads, torch.cuda.max_memory_allocated() / 1e9

    per_step = counts(band_attention_flash=50, band_spmm=25, band_attention_flash_bwd=50,
                      band_spmm_bwd=25)
    reset_launches()
    loss_k, grads_k, peak_k = one_step()
    step_launches = read_launches()
    if step_launches != per_step:
        raise SystemExit(f"FAIL launches per meganet train step {step_launches}")
    with bops.plain_versions():
        loss_p, grads_p, _ = one_step()
    worst_p = grads_within("meganet kernel step vs plain step", pnames, grads_k, grads_p)
    reset_launches()
    loss_r, grads_r, peak_r = one_step(remat=True)
    remat_launches = read_launches()
    if remat_launches != counts(band_attention_flash=100, band_spmm=50,
                                band_attention_flash_bwd=50, band_spmm_bwd=25):
        raise SystemExit(f"FAIL launches per remat step {remat_launches}")
    if not all(torch.equal(a, b) for a, b in zip(grads_k, grads_r)):
        raise SystemExit("FAIL the remat step's gradients differ from the plain-autograd step's")
    print(f"  train step at batch {tbs}: kernels vs plain versions on the card: loss {loss_k:.7f} / "
          f"{loss_p:.7f}, {len(pnames)} gradients within 1e-3·max|g_ref| + 1e-6, the worst at "
          f"{worst_p:.1%}; launches {step_launches['band_attention_flash']} + "
          f"{step_launches['band_spmm']} forward, {step_launches['band_attention_flash_bwd']} + "
          f"{step_launches['band_spmm_bwd']} backward; remat=True: the same gradients to the bit, "
          f"peak {peak_r:.3f} GB against {peak_k:.3f} GB, 100 + 50 forward launches")
    del grads_k, grads_p, grads_r
    torch.cuda.empty_cache()

    mk_ds = lambda a: WDNDataset.from_members([_Member(tpl, a, [], None)], sstats)  # noqa: E731
    epochs_log = []
    with tempfile.TemporaryDirectory() as dir_full, tempfile.TemporaryDirectory() as dir_cut:
        trn = mega_trainer(epochs=2, save_path=dir_full)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        best = trn.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: print("  " + m),
                       on_epoch_end=lambda ep, m: epochs_log.append(m))
        torch.cuda.synchronize()
        fit_launches = read_launches()
        fit_peak = torch.cuda.max_memory_allocated() / 1e9
        n_tr, n_ev = 2 * (n_train // tbs), 2 * (n_val // tbs)
        expect = counts(band_attention_flash=50 * (n_tr + n_ev), band_spmm=25 * (n_tr + n_ev),
                        band_attention_flash_bwd=50 * n_tr, band_spmm_bwd=25 * n_tr)
        if fit_launches != expect:
            raise SystemExit(f"FAIL meganet fit launches {fit_launches}, expected {expect}")
        tl = [m["train_loss"] for m in epochs_log]
        vl = [m["val_loss"] for m in epochs_log]
        if len(tl) != 2 or not np.isfinite(tl + vl).all() or tl[1] >= 1.5 * tl[0]:
            raise SystemExit(f"FAIL meganet fit diverged or stopped: train {tl}, val {vl}")
        mega_trainer(epochs=1, save_path=dir_cut).fit(
            mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: None)
        resumed = mega_trainer(epochs=2, save_path=dir_cut)
        resumed.restore(os.path.join(dir_cut, "last_gatres_large.ckpt"))
        resumed.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: None)
        torch.cuda.synchronize()
        sa, sb = trn.opt_state_dict(), resumed.opt_state_dict()
        same = (all(torch.equal(a, b) for a, b in zip(trn.model.state_dict().values(),
                                                     resumed.model.state_dict().values()))
                and sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa))
        if not same:
            raise SystemExit("FAIL the resumed meganet run did not end bit-identical")
    del resumed
    batch = arr[:tbs]
    tgen = torch.Generator().manual_seed(0)
    step_ms = cuda_ms(lambda: trn.train_step(tpl, batch, generator=tgen), 2, 8)
    fit_peak = max(fit_peak, torch.cuda.max_memory_allocated() / 1e9)
    print(f"  fit: 2 epochs, batch {tbs}, {n_train} train + {n_val} val snapshots: train loss {tl}, "
          f"val loss {vl}, best epoch {best['epoch']}, {best['train_time_s']:.2f} s; launches "
          f"{fit_launches['band_attention_flash']} + {fit_launches['band_spmm']} forward, "
          f"{fit_launches['band_attention_flash_bwd']} + {fit_launches['band_spmm_bwd']} backward; "
          f"resumed from epoch 1 and ended bit-identical")
    print(f"  train step at batch {tbs}: {step_ms:.3f} ms ({tbs * tpl.n_edge / step_ms * 1e3:.0f} "
          f"edges/s), peak device memory {fit_peak:.3f} GB")
    profile_batch(lambda: trn.train_step(tpl, batch, generator=tgen), "one meganet train step",
                  top=14)
    del trn, inf, smodel
    torch.cuda.empty_cache()

    # ---- 18: bigtown through the window route ----------------------------------
    print('[18] bigtown with band_attn="window"')
    btpl, bnpz = big["tpl"], big["npz"]
    wmodel, wpreset = select_model("gatres_large", device=dev)
    wmodel.load_state_dict(params_from_parity_npz(bnpz))
    bstats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    wbs = 32
    wsnaps = (big["x"][:, 0][None, :] + 0.1 * rng.standard_normal((wbs, btpl.n_node))
              ).astype(np.float32)
    inf_w = Inferencer(wmodel, bstats, device=dev, band_attn="window")
    inf_d = Inferencer(wmodel, bstats, device=dev)
    wobs = inf_w.observed_indices(btpl, "random", mask_rate=0.95, seed=0)
    inf_w.infer(btpl, wsnaps, wobs, scaled=True, batch_size=wbs)           # warm-up
    torch.cuda.synchronize()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pred_w = inf_w.infer(btpl, wsnaps, wobs, scaled=True, batch_size=wbs).pred
    end.record()
    end.synchronize()
    window_serve = read_launches()
    if window_serve != counts(band_attention_window=50, band_spmm=25):
        raise SystemExit(f"FAIL window serving launches {window_serve}")
    window_serve_ms = start.elapsed_time(end)
    pred_d = inf_d.infer(btpl, wsnaps, wobs, scaled=True, batch_size=wbs).pred
    werr = check_close("window served batch vs the default route", torch.as_tensor(pred_w),
                       torch.as_tensor(pred_d), 1e-4, 1e-4, verbose=False)
    print(f"  serving batch of {wbs}: {window_serve_ms:.3f} ms, 50 band_attention_window + 25 "
          f"band_spmm launches; within {werr:.3e} m of the default (dma) route's")
    # the same batch, and a train step at batch 8, under each route in turn: what
    # the routing rule costs or saves on this layout
    rbs = 8
    rbatch = wsnaps[:rbs]
    route_ms = {}
    for route in ("dma", "flash", "window", "dma"):
        inf_r = Inferencer(wmodel, bstats, device=dev, band_attn=route)
        pred_r = inf_r.infer(btpl, wsnaps, wobs, scaled=True, batch_size=wbs).pred
        check_close(f"bigtown served batch under {route!r} vs the default route",
                    torch.as_tensor(pred_r), torch.as_tensor(pred_d), 1e-4, 1e-4, verbose=False)
        serve = cuda_ms(lambda: inf_r.infer(btpl, wsnaps, wobs, scaled=True, batch_size=wbs), 1, 3)
        rmodel, _ = select_model("gatres_large", device=dev)
        rmodel.load_state_dict(wmodel.state_dict())
        trr = Trainer(rmodel, wpreset.train_config(batch_size=rbs, band_attn=route), bstats, btpl,
                      device=dev)
        rgen = torch.Generator().manual_seed(0)
        step = cuda_ms(lambda: trr.train_step(btpl, rbatch, generator=rgen), 2, 5)
        route_ms.setdefault(route, []).append((serve, step))
        del inf_r, trr, rmodel
        torch.cuda.empty_cache()
    for route, runs in route_ms.items():
        print(f"  bigtown under band_attn={route!r}: " + "; ".join(
            f"serving batch of {wbs} {a:.3f} ms, train step at batch {rbs} {b:.3f} ms"
            for a, b in runs))
    # the window backward in that step: 25 launches at H·C 256 and 25 at 128
    window_b8 = {}
    for H, C in ((2, 128), (1, 128)):
        a_dst, a_src, x_win, d_out, _ = check_window("bigtown", big["mask"], big["mask_ix"], rbs, H, C)
        window_b8[H * C] = device_ms(lambda: ba.band_attention_window_bwd(
            a_dst, a_src, x_win, big["mask"], d_out, 0.2, big["mask_ix"]))
        del a_dst, a_src, x_win, d_out
        torch.cuda.empty_cache()
    print(f"  band_attention_window_bwd in the batch-{rbs} step: 25 x {fmt_ms(window_b8[256])} + 25 x "
          f"{fmt_ms(window_b8[128])} = {fmt_ms(step_device_ms(window_b8))} ms of device time")
    tfx = big["tfx"]
    tstats = NormStats(norm_type="znorm", mean=float(tfx["stats_mean"]), std=float(tfx["stats_std"]))
    tmodel, _ = select_model("gatres_large", device=dev)
    tmodel.load_state_dict(params_from_parity_npz(bnpz))
    trw = Trainer(tmodel, wpreset.train_config(batch_size=1, band_attn="window"), tstats, btpl,
                  device=dev)
    g1, x1, m1, k1 = trw._prepare(btpl, big["x"][:, 0][None, :], tfx["mask"], None, None)
    trw.model.train()
    reset_launches()
    loss_w, _, _ = trw._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
    grads_w = torch.autograd.grad(loss_w, list(trw.model.parameters()))
    torch.cuda.synchronize()
    window_step = read_launches()
    if window_step != counts(band_attention_window=50, band_spmm=25, band_attention_window_bwd=50,
                             band_spmm_bwd=25):
        raise SystemExit(f"FAIL window train step launches {window_step}")
    loss_w = float(loss_w.detach())
    if abs(loss_w - float(tfx["loss"])) > 1e-4 * abs(float(tfx["loss"])):
        raise SystemExit(f"FAIL window train loss {loss_w!r} against {float(tfx['loss'])!r}")
    wnames = [k for k, _ in tmodel.named_parameters()]
    worst_w = grads_within("window B 1 step vs JAX", wnames, grads_w,
                           [torch.as_tensor(tfx[f"grad_{k}"], device=dev) for k in wnames])
    print(f"  B 1 step vs the JAX Trainer's fixture: loss {loss_w:.7f} against "
          f"{float(tfx['loss']):.7f}; {len(wnames)} gradients within their bound, the worst at "
          f"{worst_w:.1%}; launches 50 + 25 forward, 50 + 25 backward")
    del trw, grads_w, inf_w, inf_d, wmodel, tmodel
    torch.cuda.empty_cache()

    # ---- 19: kernel times ---------------------------------------------------------
    print(f"[19] times of the flash kernels (meganet) and the window kernels (bigtown) on {card}")
    rows = []

    def bound(r):
        t_bytes, t_ops = r["bytes"] / PEAK_BYTES_S * 1e3, r["ops"] / PEAK_F32_S * 1e3
        r["bound_ms"], r["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        r["library_ms"] = None
        rows.append(r)
        print(f"  {r['name']} {r['net']} B {r['B']} H·C {r['hc']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library none (no PyTorch call computes a masked softmax over "
              f"band windows), bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bytes'] / 1e6:.1f} MB)")

    f_ix = 4 * (n_pad + 1 + ix.nnz)                       # row_ptr, col
    b_ix = 4 * (n_pad + 1 + n_ext + 1 + 3 * ix.nnz)       # row_ptr, col, t_ptr, t_entry, t_row
    v2_ms, delta_ms = {}, {}
    for B in (bs, tbs):
        for H, C in ((2, 128), (1, 128)):
            a_dst, a_src, x_ext, d_out, m, Z, delta = check_flash("meganet", mask, ix, B, H, C)
            # a_src counted once per extended row, not as its windowed copy
            small, wide_ = 4 * B * n_pad * H, 4 * B * H * C
            bound(dict(
                name="band_attention_flash", net="meganet", B=B, hc=H * C,
                ms=cuda_ms(lambda: ba.band_attention_flash_fwd(a_dst, a_src, x_ext, mask, 0.2, ix), 3, 20),
                plain_ms=cuda_ms(lambda: ba.band_attention_flash_plain(a_dst, a_src, x_ext, mask, 0.2), 1, 2),
                bytes=3 * small + 4 * B * n_ext * H + wide_ * (n_ext + n_pad) + f_ix,
                ops=B * H * ix.nnz * (2 * C + 8)))
            flash_bwd = lambda: ba.band_attention_flash_bwd(  # noqa: E731
                a_dst, a_src, x_ext, mask, m, Z, delta, d_out, 0.2, ix)
            split = device_split(flash_bwd)
            bound(dict(
                name="band_attention_flash_bwd", net="meganet", B=B, hc=H * C,
                ms=cuda_ms(flash_bwd, 3, 20), device_ms=sum(ms for _, ms in split) or None,
                plain_ms=cuda_ms(lambda: ba.band_attention_flash_bwd_plain(
                    a_dst, a_src, x_ext, mask, m, Z, delta, d_out, 0.2), 1, 2),
                bytes=5 * small + 4 * B * n_ext * H + 4 * nB * B * W * H
                + wide_ * (2 * n_ext + n_pad) + b_ix,
                ops=B * H * ix.nnz * (4 * C + 12)))
            print(f"  band_attention_flash_bwd meganet B {B} H·C {H * C}, device ms by pass: "
                  + ", ".join(f"{k} {ms:.4f}" for k, ms in split))
            # the row term BandAttentionFlash.backward forms before the kernel: plain glue
            out = ba.band_attention_flash_fwd(a_dst, a_src, x_ext, mask, 0.2, ix)[0]
            delta_ms[(B, H * C)] = device_ms(lambda: (d_out * out).sum(dim=-1))
            print(f"  its delta = (d_out * out).sum(-1), device {fmt_ms(delta_ms[(B, H * C)])} ms")
            del out
            if B == bs:
                # the v2 kernels on the same inputs: both forwards are one row walk
                # (csrc/band_rowwalk.cuh), v2's without the statistics; v2's backward
                # recomputes the softmax where the flash backward takes m, Z and delta
                held("band_attention", f"band_attention meganet B{B} H{H} C{C}",
                     ba.band_attention_fwd(a_dst, a_src, x_ext, mask, 0.2, ix),
                     ba.band_attention_plain(a_dst, a_src, x_ext, mask, 0.2), verbose=False)
                for part, g, r in zip(
                        ("d a_dst", "d a_src_win", "d x_ext"),
                        ba.band_attention_bwd(a_dst, a_src, x_ext, mask, d_out, 0.2, ix),
                        ba.band_attention_bwd_plain(a_dst, a_src, x_ext, mask, d_out, 0.2)):
                    held("band_attention_bwd", f"band_attention_bwd meganet B{B} H{H} C{C} {part}",
                         g, r, verbose=False)
                v2_ms[H * C] = (
                    cuda_ms(lambda: ba.band_attention_fwd(a_dst, a_src, x_ext, mask, 0.2, ix), 3, 20),
                    cuda_ms(lambda: ba.band_attention_bwd(a_dst, a_src, x_ext, mask, d_out, 0.2, ix),
                            3, 20))
                print(f"  on the same inputs, band_attention (v2: the same row walk, without m and Z) "
                      f"forward {v2_ms[H * C][0]:.4f} ms; its backward (the softmax recomputed, dp "
                      f"in the columns pass) {v2_ms[H * C][1]:.4f} ms")
            del a_dst, a_src, x_ext, d_out, m, Z, delta
            torch.cuda.empty_cache()
    a_dst, a_src, x_ext, d_out = operands(mask, 32, 2, 128)
    out, m, Z = ba.band_attention_flash_fwd(a_dst, a_src, x_ext, mask, 0.2, ix)
    delta = (d_out * out).sum(dim=-1)
    ms_b32 = {
        "band_attention_flash": cuda_ms(
            lambda: ba.band_attention_flash_fwd(a_dst, a_src, x_ext, mask, 0.2, ix), 3, 20),
        "band_attention_flash_bwd": cuda_ms(lambda: ba.band_attention_flash_bwd(
            a_dst, a_src, x_ext, mask, m, Z, delta, d_out, 0.2, ix), 3, 20)}
    print(f"  the flash forward's m equal to the plain row maximum, bit for bit, at every "
          f"meganet and ragged shape: {all(m_exact)} ({sum(m_exact)} of {len(m_exact)})")
    print(f"  kernels alone at B 32, H·C 256 (no plain version there: it holds several "
          f"[nB, B, BLK, W, H] tensors of 11 GB each): "
          f"forward {ms_b32['band_attention_flash']:.4f} ms, backward "
          f"{ms_b32['band_attention_flash_bwd']:.4f} ms")
    del a_dst, a_src, x_ext, d_out, out, m, Z, delta
    torch.cuda.empty_cache()

    # the band SpMM forward at the serving batch: the other band kernel of the meganet forward
    from gnn_pressure_estimation_tpu_torch.ops import band_spmm as bsp
    cnt = torch.as_tensor(bl.adj_cnt, device=dev)
    cix = tpl.band_index("adj_cnt").to(dev)
    x_ext = randn(bs, n_ext, 128)
    held("band_spmm", f"band_spmm meganet B{bs} C128", bsp.band_spmm_fwd(cnt, x_ext, cix),
         bsp.band_spmm_plain(cnt, x_ext), verbose=False)
    blk_i, r_i, j_i = np.nonzero(bl.adj_cnt)
    csr = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([blk_i * BLK + r_i, blk_i * BLK + j_i]), device=dev),
        torch.as_tensor(bl.adj_cnt[blk_i, r_i, j_i].astype(np.float32), device=dev),
        (n_pad, n_ext)).to_sparse_csr()
    x2d = x_ext.permute(1, 0, 2).reshape(n_ext, bs * 128).contiguous()
    spmm_b8 = dict(
        ms=cuda_ms(lambda: bsp.band_spmm_fwd(cnt, x_ext, cix), 3, 20),
        plain_ms=cuda_ms(lambda: bsp.band_spmm_plain(cnt, x_ext), 1, 3),
        library_ms=cuda_ms(lambda: torch.sparse.mm(csr, x2d), 3, 20),
        bound_ms=4 * (bs * (n_ext + n_pad) * 128 + n_pad + 1 + 2 * cix.nnz) / PEAK_BYTES_S * 1e3)
    print(f"  band_spmm meganet B {bs} C 128: kernel {spmm_b8['ms']:.4f} ms, plain "
          f"{spmm_b8['plain_ms']:.4f} ms, torch.sparse.mm {spmm_b8['library_ms']:.4f} ms, bound "
          f"{spmm_b8['bound_ms']:.4f} ms (bytes; {spmm_b8['bound_ms'] / spmm_b8['ms']:.1%} of it reached)")
    del x_ext, x2d, csr
    # its backward at the serving and the training batch, beside torch.sparse.mm on the
    # transposed CSR (phase 6's yardstick on bigtown)
    csr_t = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([blk_i * BLK + j_i, blk_i * BLK + r_i]), device=dev),
        torch.as_tensor(bl.adj_cnt[blk_i, r_i, j_i].astype(np.float32), device=dev),
        (n_ext, n_pad)).to_sparse_csr()
    spmm_bwd = {}
    for B in (bs, tbs):
        d_out = randn(B, n_pad, 128)
        d2d = d_out.permute(1, 0, 2).reshape(n_pad, B * 128).contiguous()
        held("band_spmm_bwd", f"band_spmm_bwd meganet B{B} C128", bsp.band_spmm_bwd(cnt, d_out, cix),
             bsp.band_spmm_bwd_plain(cnt, d_out), verbose=False)
        check_close(f"band_spmm_bwd meganet B{B} vs torch.sparse.mm", bsp.band_spmm_bwd(cnt, d_out, cix),
                    torch.sparse.mm(csr_t, d2d).reshape(n_ext, B, 128).permute(1, 0, 2), TOL, TOL,
                    verbose=False)
        r = spmm_bwd[B] = dict(
            ms=cuda_ms(lambda: bsp.band_spmm_bwd(cnt, d_out, cix), 3, 20),
            device_ms=device_ms(lambda: bsp.band_spmm_bwd(cnt, d_out, cix)),
            plain_ms=cuda_ms(lambda: bsp.band_spmm_bwd_plain(cnt, d_out), 1, 3),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr_t, d2d), 3, 20),
            bound_ms=4 * (B * (n_pad + n_ext) * 128 + n_ext + 1 + 2 * cix.nnz) / PEAK_BYTES_S * 1e3)
        print(f"  band_spmm_bwd meganet B {B} C 128: kernel {r['ms']:.4f} ms (device "
              f"{fmt_ms(r['device_ms'])}), plain {r['plain_ms']:.4f} ms, torch.sparse.mm on the "
              f"transposed CSR {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes; "
              f"{r['bound_ms'] / r['ms']:.1%} of it reached)")
        del d_out, d2d
    spmm_dev = spmm_bwd[tbs]["device_ms"]
    print(f"  launch-weighted in a meganet B {tbs} step: band_spmm_bwd 25 x {fmt_ms(spmm_dev)} = "
          f"{fmt_ms(None if spmm_dev is None else 25 * spmm_dev)} ms of device time; "
          f"band_attention_flash_bwd 25 x H·C 256 + 25 x H·C 128 = " + fmt_ms(step_device_ms(
              {q["hc"]: q["device_ms"] for q in rows
               if q["name"] == "band_attention_flash_bwd" and q["B"] == tbs})) + " ms")
    print(f"  the delta reductions in that step: 25 x H·C 256 + 25 x H·C 128 = "
          f"{fmt_ms(step_device_ms({hc: delta_ms[(tbs, hc)] for hc in (256, 128)}))} ms of device time")
    del cnt, csr_t
    torch.cuda.empty_cache()

    bbl = btpl.band_layout()
    bnB, bBLK, bW = bbl.adj_mask.shape
    bix, bmask = big["mask_ix"], big["mask"]
    bn_pad = bbl.n_pad
    # the window cells that some row of their block reads: what the forward must fetch
    blk_i, _, j_i = np.nonzero(bbl.adj_mask)
    cells = len(np.unique(blk_i * bW + j_i))
    wb_ix = 4 * (bn_pad + 1 + bix.nnz) + 4 * (bn_pad + bW - bBLK + 1 + 2 * bix.nnz)
    for H, C in ((2, 128), (1, 128)):
        B = wbs
        a_dst, a_src, x_win, d_out, x_ext = check_window("bigtown", bmask, bix, B, H, C)
        small, wide_ = 4 * B * bn_pad * H, 4 * B * H * C
        # beside it v2's forward on the x_ext the windows were cut from: the same row
        # walk, reading x_ext[b, blk*BLK + j] where the window forward reads x_win[blk, b, j]
        win_fwd = lambda: ba.band_attention_window_fwd(a_dst, a_src, x_win, bmask, 0.2, bix)  # noqa: E731
        v2_fwd = lambda: ba.band_attention_fwd(a_dst, a_src, x_ext, bmask, 0.2, bix)  # noqa: E731
        bound(dict(
            name="band_attention_window", net="bigtown", B=B, hc=H * C,
            ms=cuda_ms(win_fwd, 3, 20), device_ms=device_ms(win_fwd),
            v2_ms=cuda_ms(v2_fwd, 3, 20), v2_device_ms=device_ms(v2_fwd),
            plain_ms=cuda_ms(lambda: ba.band_attention_window_plain(a_dst, a_src, x_win, bmask, 0.2), 1, 3),
            bytes=small + 4 * B * H * cells + wide_ * (cells + bn_pad) + 4 * (bn_pad + 1 + bix.nnz),
            ops=B * H * bix.nnz * (2 * C + 6)))
        r = rows[-1]
        print(f"  band_attention_window bigtown B {B} H·C {H * C}: device {fmt_ms(r['device_ms'])} ms; "
              f"v2's forward on the same x_ext {r['v2_ms']:.4f} ms (device {fmt_ms(r['v2_device_ms'])})")
        # the backward writes both window cotangents densely: every cell once; beside
        # it v2's backward on the x_ext the windows were cut from (the same passes
        # with the column walk in extended layout)
        win_bwd = lambda: ba.band_attention_window_bwd(  # noqa: E731
            a_dst, a_src, x_win, bmask, d_out, 0.2, bix)
        v2_bwd = lambda: ba.band_attention_bwd(a_dst, a_src, x_ext, bmask, d_out, 0.2, bix)  # noqa: E731
        split, v2_split = device_split(win_bwd), device_split(v2_bwd)
        bound(dict(
            name="band_attention_window_bwd", net="bigtown", B=B, hc=H * C,
            ms=cuda_ms(win_bwd, 3, 20), device_ms=sum(ms for _, ms in split) or None,
            v2_ms=cuda_ms(v2_bwd, 3, 20), v2_device_ms=sum(ms for _, ms in v2_split) or None,
            plain_ms=cuda_ms(lambda: ba.band_attention_window_bwd_plain(
                a_dst, a_src, x_win, bmask, d_out, 0.2), 1, 3),
            bytes=2 * small + 4 * B * H * cells + wide_ * (cells + bn_pad)
            + 4 * bnB * B * bW * H * (1 + C) + wb_ix,
            ops=B * H * bix.nnz * (4 * C + 12)))
        r = rows[-1]
        print(f"  band_attention_window_bwd bigtown B {B} H·C {H * C}: device {fmt_ms(r['device_ms'])} ms; "
              f"v2's backward on the same x_ext {r['v2_ms']:.4f} ms (device {fmt_ms(r['v2_device_ms'])}); "
              "device ms by pass: " + ", ".join(f"{k} {ms:.4f}" for k, ms in split)
              + "; v2's: " + ", ".join(f"{k} {ms:.4f}" for k, ms in v2_split))
        del a_dst, a_src, x_win, d_out, x_ext
        torch.cuda.empty_cache()
    print("  the window backward's columns instances (kWindow), registers and spills: "
          + columns_registers(big["ptxas"].get("band_attention_window_bwd", ())))
    return dict(rows=rows, ms_b32=ms_b32, v2_ms=v2_ms, spmm_b8=spmm_b8, spmm_bwd=spmm_bwd,
                window_b8=window_b8, window_da_equal=all(win_da_equal),
                window_fwd_equal=len(win_fwd_equal),
                serve_launches=serve_launches,
                serve_ms=serve_ms,
                serve_batch=bs, fit_launches=fit_launches, step_launches=step_launches,
                step_ms=step_ms, train_batch=tbs, fit_peak=fit_peak, window_serve=window_serve,
                window_step=window_step, window_serve_ms=window_serve_ms, route_ms=route_ms,
                serve_batches=n_batches, tpl=tpl,
                shape=f"n_pad {n_pad}, W {W}", window_shape=f"n_pad {bn_pad}, W {bW}")


def check_equal(name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """Bit-for-bit agreement (a gather copies; it adds nothing)."""
    if got.shape != ref.shape or not torch.equal(got, ref):
        err = float((got - ref).abs().max()) if got.shape == ref.shape else float("nan")
        raise SystemExit(f"FAIL {name}: not equal (shape {tuple(got.shape)} against "
                         f"{tuple(ref.shape)}, max abs err {err:.3e})")


def slice5_phases(dev, card, rng, held, reset_launches, read_launches, counts, big,
                  kernel_batches=(1, 8, 32), tbs=8, sbs=32):
    """Phases 20-24: bigtown training through ``band_attn="acc"`` (path A) and
    the degree-padded mode, with the windowed gather driven on its tables
    (path B). ``big`` carries the bigtown template, fixtures and layout; the
    batch sizes are the card's (a rehearsal on the host passes smaller ones).
    Returns the kernel rows and the launch counts of its runs."""
    import contextlib
    import tempfile

    from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset, _Member
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model
    from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.ops import window_gather as wg
    from gnn_pressure_estimation_tpu_torch.train import Trainer
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    tpl, npz, tfx = big["tpl"], big["npz"], big["tfx"]
    mask, mask_ix = big["mask"], big["mask_ix"]
    n = tpl.n_node
    bl = tpl.band_layout()
    nB, BLK, W = bl.adj_mask.shape
    n_pad, n_ext = bl.n_pad, bl.n_pad + W - BLK
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def operands(msk, B, H, C):
        """a_dst, a_src_win, x_ext, d_out; a third of the nodes zeroed, so
        that a_dst + a_src == 0 occurs."""
        nB_, BLK_, W_ = msk.shape
        np_, ne_ = nB_ * BLK_, nB_ * BLK_ + W_ - BLK_
        a_dst, a_src = randn(B, np_, H), randn(nB_, B, W_, H)
        a_dst[:, ::3] = 0.0
        a_src[:, :, ::3] = 0.0
        return a_dst, a_src, randn(B, ne_, H, C), randn(B, np_, H, C)

    def check_acc(tag, msk, index, B, H, C, verbose=False):
        """Against the plain version (1e-4), and against v2's backward on the
        same inputs, bit for bit: the acc route runs v2's passes."""
        a_dst, a_src, x_ext, d_out = operands(msk, B, H, C)
        got = ba.band_attention_acc_bwd(a_dst, a_src, x_ext, msk, d_out, 0.2, index)
        ref = ba.band_attention_acc_bwd_plain(a_dst, a_src, x_ext, msk, d_out, 0.2)
        v2 = ba.band_attention_bwd(a_dst, a_src, x_ext, msk, d_out, 0.2, index)
        for part, g, r, q in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref, v2):
            held("band_attention_acc_bwd", f"band_attention_acc_bwd {tag} B{B} H{H} C{C} {part}",
                 g, r, verbose)
            check_equal(f"band_attention_acc_bwd {tag} B{B} H{H} C{C} {part} vs band_attention_bwd", g, q)
        return a_dst, a_src, x_ext, d_out

    # ---- 20: the acc backward against its plain version and v2's ----------------
    print(f"[20] band_attention_acc_bwd vs its plain version and band_attention_bwd: bigtown layout "
          f"(nB {nB}, BLK {BLK}, W {W}) at B {', '.join(map(str, kernel_batches))}, H·C 256 and 128; "
          f"ragged shapes")
    for B in kernel_batches:
        for H in (2, 1):
            check_acc("bigtown", mask, mask_ix, B, H, 128, verbose=B == kernel_batches[0])
            torch.cuda.empty_cache()
    rmask = rng.random((3, 16, 70)) < 0.3
    rmask[-1, -5:] = False                        # fully masked (padded) rows
    wide = rng.random((2, 16, 200)) < 0.4         # rows of ~80 entries
    tall = rng.random((1, 1056, 1100)) < 0.01     # BLK 1056: one block wider than 1024 rows
    for m_np, shapes in ((rmask, ((3, 2, 32), (2, 1, 300), (2, 3, 33))),
                         (wide, ((2, 2, 32), (1, 1, 300))), (tall, ((1, 1, 8),))):
        m_t = torch.as_tensor(m_np.view(np.int8), device=dev)
        for B, H, C in shapes:
            check_acc("ragged", m_t, None, B, H, C)          # index built from the mask's values
    torch.cuda.synchronize()
    print("  all within atol/rtol 1e-4 of the plain version, and equal to band_attention_bwd's "
          "outputs bit for bit")

    # ---- 21: path A, training through band_attn="acc" ---------------------------
    print('[21] path A: GATRes-large training on bigtown with band_attn="acc"')
    tstats = NormStats(norm_type="znorm", mean=float(tfx["stats_mean"]), std=float(tfx["stats_std"]))

    def fixture_trainer(batch_size, **kw):
        m, preset = select_model("gatres_large", device=dev)
        m.load_state_dict(params_from_parity_npz(npz))
        return Trainer(m, preset.train_config(batch_size=batch_size, **kw), tstats, tpl, device=dev)

    xb1 = big["x"][:, 0][None, :]

    def b1_step(tr):
        g1, x1, m1, k1 = tr._prepare(tpl, xb1, tfx["mask"], None, None)
        tr.model.train()
        loss, mets, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return g1, float(loss.detach()), mets, grads

    def against_fixture(label, tr, loss1, mets1, grads1):
        """The B 1 step of ``parity_train_bigtown.npz`` under phase 7's bounds."""
        names = [k for k, _ in tr.model.named_parameters()]
        if abs(loss1 - float(tfx["loss"])) > 1e-4 * abs(float(tfx["loss"])):
            raise SystemExit(f"FAIL {label} loss {loss1!r} against the fixture's {float(tfx['loss'])!r}")
        for k, v in mets1.items():
            ref = float(tfx[f"metric_{k}"])
            if abs(float(v) - ref) > 1e-3 * abs(ref) + 1e-4:
                raise SystemExit(f"FAIL {label} metric {k}: {float(v)!r} against {ref!r}")
        worst = grads_within(f"{label} B 1 step vs JAX", names, grads1,
                             [torch.as_tensor(tfx[f"grad_{k}"], device=dev) for k in names])
        losses3 = [float(tr.train_step(tpl, xb1, mask=tfx["mask"])[0]) for _ in range(3)]
        perr, pnoise = adam_param_errors(tr.model.named_parameters(), tfx)
        lerr = max(abs(a - b) / abs(b) for a, b in zip(losses3, tfx["step_losses"]))
        if perr > 3e-4 or pnoise > 3 * 2 * 5e-4 or lerr > 1e-3:
            raise SystemExit(f"FAIL {label} after 3 Adam steps: parameters off by {perr:.3e} (atol "
                             f"3e-4; {pnoise:.3e} where the gradient is noise, bound 3e-3), step "
                             f"losses by {lerr:.3e} relative (1e-3)")
        print(f"  B 1 step vs the JAX Trainer's fixture: loss {loss1:.7f} against "
              f"{float(tfx['loss']):.7f}; {len(names)} gradients within 1e-3·max|g_ref| + 1e-6, the "
              f"worst at {worst:.1%}; after 3 Adam steps parameters within {perr:.3e} ({pnoise:.3e} "
              f"where the first gradient is below its tolerance), step losses within {lerr:.3e}")
        return worst

    per_step = counts(band_attention=50, band_spmm=25, band_attention_acc_bwd=50, band_spmm_bwd=25)
    tr1 = fixture_trainer(1, band_attn="acc")
    reset_launches()
    g1, loss1, mets1, grads1 = b1_step(tr1)
    acc_step = read_launches()
    if g1.band_attn != "acc" or acc_step != per_step:
        raise SystemExit(f"FAIL launches per acc train step {acc_step}, expected {per_step}")
    acc_worst = against_fixture("acc", tr1, loss1, mets1, grads1)
    print("  launches per step: 50 band_attention (the v2 forward) + 25 band_spmm, 50 "
          "band_attention_acc_bwd + 25 band_spmm_bwd, 0 band_attention_bwd")
    del tr1, grads1
    torch.cuda.empty_cache()

    n_train, n_val = 4 * tbs, 2 * tbs
    arr = (xb1 + 0.1 * rng.standard_normal((n_train + n_val, n))).astype(np.float32)
    amask = (rng.random((tbs, n)).argsort(1) < int(n * 0.95)).reshape(-1)

    def batch_step(route, xb, xmask, plain=False, f64=False):
        """One batch step's loss and gradients (as float64 tensors) through the
        route's kernels, or through the plain versions in f32 or in float64.
        The float64 step runs with ``remat``: one block's [nB, B, BLK, W, H]
        tensors alive at a time."""
        tr = fixture_trainer(tbs, band_attn=route)
        if f64:
            tr.model.double()
            tr.model.remat = True
        g, x, m, k = tr._prepare(tpl, xb, xmask, None, None)
        tr.model.train()
        x = x.double() if f64 else x
        with bops.plain_versions() if plain or f64 else contextlib.nullcontext():
            loss, _, _ = tr._masked_loss_and_metrics(g, x, x, m, k, "train")
            grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return float(loss.detach()), [gr.double() for gr in grads]

    # at batch 8 a gradient sums 8·n_pad rows, and the att_src / att_dst gradients
    # cancel: every f32 order of summation, the plain versions' included, can land
    # beyond 1e-3·max|g| + 1e-6 of the exact gradient on some of them (draws 1 and 3
    # below show it for the plain versions). So each f32 side (the dma and acc
    # kernels, the plain versions) is held against the same step in float64, on the
    # fixture batch and on three more draws of snapshots and masks, to 3 × that bound
    pnames = [k for k, _ in select_model("gatres_large", device="cpu")[0].named_parameters()]
    draws = [(arr[:tbs], amask)]
    for seed in (0, 1, 2):
        drng = np.random.default_rng(seed)
        draws.append(((xb1 + 0.1 * drng.standard_normal((tbs, n))).astype(np.float32),
                      (drng.random((tbs, n)).argsort(1) < int(n * 0.95)).reshape(-1)))
    for d, (xb, xmask) in enumerate(draws):
        loss_64, g64 = batch_step("acc", xb, xmask, f64=True)
        bounds = [1e-3 * float(r.abs().max()) + 1e-6 for r in g64]
        line, side_grads = [], {}
        for side, route, plain in (("plain f32", "acc", True), ("dma", "dma", False),
                                   ("acc", "acc", False)):
            loss, grads = batch_step(route, xb, xmask, plain=plain)
            side_grads[side] = grads
            shares = []
            for name, g, r, bnd in zip(pnames, grads, g64, bounds):
                if not torch.isfinite(g).all():
                    raise SystemExit(f"FAIL {side} step at batch {tbs}: gradient of {name} is not finite")
                shares.append((float((g - r).abs().max()) / bnd, name))
            worst, wname = max(shares)
            if worst > 3:
                raise SystemExit(f"FAIL {side} step at batch {tbs} (draw {d}): gradient of {wname} lies "
                                 f"{worst:.2f} × 1e-3·max|g| + 1e-6 from the float64 step's (bound 3)")
            att = dict(map(reversed, shares))["blocks.5.conv1.att_dst"]
            line.append(f"{side} loss {loss:.7f}: beyond 1× the bound {sum(q > 1 for q, _ in shares)}, "
                        f"worst {worst:.1%} ({wname}), sum of shares {sum(q for q, _ in shares):.2f}, "
                        f"blocks.5.conv1.att_dst {att:.1%}")
        print(f"  step at batch {tbs}, draw {d} ({'the fit data' if d == 0 else f'seed {d - 1}'}): "
              f"float64 loss {loss_64:.9f}; {len(pnames)} gradients against the float64 step's, as shares "
              f"of 1e-3·max|g| + 1e-6:\n    " + "\n    ".join(line))
        # the acc route's backward is v2's passes: the two steps agree to the bit
        for name, g, r in zip(pnames, side_grads["acc"], side_grads["dma"]):
            if not torch.equal(g, r):
                raise SystemExit(f"FAIL acc and dma steps at batch {tbs} (draw {d}): gradient of {name} "
                                 f"differs by {float((g - r).abs().max()):.3e}")
        print(f"    acc and dma: all {len(pnames)} gradients equal bit for bit")
        del g64, side_grads
        torch.cuda.empty_cache()

    def mk_ds(a):
        return WDNDataset.from_members([_Member(tpl, a, [], None)], tstats)

    def fit_and_resume(label, make):
        """``fit`` for 2 epochs, with the launch counts of that run; then one
        epoch, a restore of 'last' in a new trainer and the second epoch,
        which must end bit-identical."""
        log = []
        with tempfile.TemporaryDirectory() as dir_full, tempfile.TemporaryDirectory() as dir_cut:
            trn = make(epochs=2, save_path=dir_full)
            reset_launches()
            best = trn.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]),
                           log_fn=lambda m: print("  " + m), on_epoch_end=lambda ep, m: log.append(m))
            torch.cuda.synchronize()
            launched = read_launches()
            tl, vl = [m["train_loss"] for m in log], [m["val_loss"] for m in log]
            if len(tl) != 2 or not np.isfinite(tl + vl).all() or tl[1] >= 1.5 * tl[0]:
                raise SystemExit(f"FAIL {label} fit diverged or stopped: train {tl}, val {vl}")
            make(epochs=1, save_path=dir_cut).fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]),
                                                  log_fn=lambda m: None)
            resumed = make(epochs=2, save_path=dir_cut)
            meta = resumed.restore(os.path.join(dir_cut, "last_gatres_large.ckpt"))
            resumed.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: None)
            torch.cuda.synchronize()
            sa, sb = trn.opt_state_dict(), resumed.opt_state_dict()
            same = (all(torch.equal(a, b) for a, b in zip(trn.model.state_dict().values(),
                                                         resumed.model.state_dict().values()))
                    and sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa))
            if not same:
                raise SystemExit(f"FAIL the resumed {label} run did not end bit-identical")
        print(f"  fit: 2 epochs, batch {tbs}, {n_train} train + {n_val} val snapshots: train loss "
              f"{tl}, val loss {vl}, best epoch {best['epoch']}, {best['train_time_s']:.2f} s; "
              f"resumed from epoch 1 and ended bit-identical; checkpoint layout "
              f"{meta['extra']['layout']}")
        return trn, launched, meta

    trn, acc_fit, _ = fit_and_resume("acc", lambda **kw: fixture_trainer(tbs, band_attn="acc", **kw))
    n_tr, n_ev = 2 * (n_train // tbs), 2 * (n_val // tbs)
    expect = counts(band_attention=50 * (n_tr + n_ev), band_spmm=25 * (n_tr + n_ev),
                    band_attention_acc_bwd=50 * n_tr, band_spmm_bwd=25 * n_tr)
    if acc_fit != expect:
        raise SystemExit(f"FAIL acc fit launches {acc_fit}, expected {expect}")
    print(f"  fit launches: {acc_fit['band_attention']} band_attention + {acc_fit['band_spmm']} "
          f"band_spmm forward, {acc_fit['band_attention_acc_bwd']} band_attention_acc_bwd + "
          f"{acc_fit['band_spmm_bwd']} band_spmm_bwd, 0 band_attention_bwd")
    del trn
    torch.cuda.empty_cache()
    # the same batch-8 step under the dma route's backward and under acc's, in turns
    route_step = []
    tgen = torch.Generator().manual_seed(0)
    for route in ("dma", "acc", "dma"):
        trr = fixture_trainer(tbs, band_attn=route)
        route_step.append((route, cuda_ms(lambda: trr.train_step(tpl, arr[:tbs], generator=tgen), 2, 5)))
        del trr
        torch.cuda.empty_cache()
    print(f"  train step at batch {tbs}: " + ", ".join(f"{r} {ms:.3f} ms" for r, ms in route_step))

    # ---- 22: path B, the degree-padded mode ---------------------------------------
    print('[22] path B: GATRes-large on bigtown with agg_mode="padded"')
    D = tpl.max_degree
    fx = np.load(npz)
    model = GATRes(int(fx["num_blocks"]), int(fx["nc"]))
    model.load_state_dict(params_from_parity_npz(npz))
    model = model.to(dev).eval()
    graph = tpl.batch(1, mode="padded", device=dev)
    acts = {}
    hooks = [blk.register_forward_hook(lambda m, i, o, k=k: acts.__setitem__(k, o))
             for k, blk in enumerate(model.blocks)]
    reset_launches()
    with torch.inference_mode():
        out = model(torch.as_tensor(fx["x"], device=dev), graph)
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if read_launches() != counts():
        raise SystemExit(f"FAIL the padded forward launched a band kernel: {read_launches()}")
    pblock = max(check_close(f"padded block {k}", a.cpu(), torch.as_tensor(fx[f"ours_act_block_{k}"]),
                             1e-3, 0.0, verbose=False) for k, a in sorted(acts.items()))
    pout = check_close("padded output", out.cpu(), torch.as_tensor(fx["ours_out"]), 1e-3, 0.0,
                       verbose=False)
    print(f"  max in-degree {D} ({D + 1} slots with the self-loop); trained fixture forward vs JAX: "
          f"worst block {pblock:.3e}, output {pout:.3e}; no kernel launched (plain gathers, the "
          f"counterpart of the reference's XLA gather)")
    del acts

    sstats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    snaps = (fx["x"][:, 0][None, :] + 0.1 * rng.standard_normal((2 * sbs, n))).astype(np.float32)
    inf_p = Inferencer(model, sstats, agg_mode="padded", device=dev)
    obs = inf_p.observed_indices(tpl, "random", mask_rate=0.95, seed=0)
    inf_p.infer(tpl, snaps, obs, scaled=True, batch_size=sbs)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = inf_p.infer(tpl, snaps, obs, scaled=True, batch_size=sbs, with_truth=True)
    end.record()
    end.synchronize()
    padded_serve_ms = start.elapsed_time(end) / 2
    padded_serve_peak = torch.cuda.max_memory_allocated() / 1e9
    if read_launches() != counts():
        raise SystemExit(f"FAIL padded serving launched a band kernel: {read_launches()}")
    if res.pred.shape != snaps.shape or not np.isfinite(res.pred).all():
        raise SystemExit("FAIL padded serving output is not a finite [S, n] field")
    pred_b = Inferencer(model, sstats, device=dev).infer(tpl, snaps, obs, scaled=True,
                                                        batch_size=sbs).pred
    serr = check_close("padded served fields vs the banded route's", torch.as_tensor(res.pred),
                       torch.as_tensor(pred_b), 1e-3, 1e-4, verbose=False)
    print(f"  serving: {len(snaps)} snapshots, batch {sbs}: {padded_serve_ms:.3f} ms per batch "
          f"({sbs / padded_serve_ms * 1e3:.1f} snapshots/s), peak device memory "
          f"{padded_serve_peak:.3f} GB; within {serr:.3e} m of the banded (dma) route's fields")
    profile_batch(lambda: inf_p.infer(tpl, snaps[:sbs], obs, scaled=True, batch_size=sbs),
                  "one padded serving batch", top=10)

    trp = fixture_trainer(1, agg_mode="padded")
    reset_launches()
    g1, loss1, mets1, grads1 = b1_step(trp)
    if not g1.padded or read_launches() != counts():
        raise SystemExit(f"FAIL the padded step is not on the padded path: {read_launches()}")
    padded_worst = against_fixture("padded", trp, loss1, mets1, grads1)
    del trp, grads1
    torch.cuda.empty_cache()
    trn, padded_fit, meta = fit_and_resume(
        "padded", lambda **kw: fixture_trainer(tbs, agg_mode="padded", **kw))
    if padded_fit != counts() or meta["extra"]["layout"]["agg_mode"] != "padded":
        raise SystemExit(f"FAIL padded fit: launches {padded_fit}, layout {meta['extra']['layout']}")
    torch.cuda.reset_peak_memory_stats()
    trn.train_step(tpl, arr[:tbs], generator=tgen)
    torch.cuda.synchronize()
    padded_step_peak = torch.cuda.max_memory_allocated() / 1e9
    padded_step_ms = cuda_ms(lambda: trn.train_step(tpl, arr[:tbs], generator=tgen), 2, 5)
    print(f"  train step at batch {tbs}: {padded_step_ms:.3f} ms "
          f"({tbs * tpl.n_edge / padded_step_ms * 1e3:.0f} edges/s), peak device memory "
          f"{padded_step_peak:.3f} GB")
    profile_batch(lambda: trn.train_step(tpl, arr[:tbs], generator=tgen), "one padded train step",
                  top=12)
    del trn
    torch.cuda.empty_cache()

    # ---- 23: the windowed gather on the padded mode's tables -----------------------
    print("[23] window_gather on the degree-padded tables of bigtown")
    layouts = {}
    for B in (tbs, sbs):
        gB = tpl.batch(B, mode="padded", device=dev)
        t0 = time.perf_counter()
        lay = wg.build_window_layout(gB.senders_dp_sl.cpu().numpy().astype(np.int32),
                                     gB.mask_dp_sl.cpu().numpy(), B * n)
        layouts[B] = (gB, lay, lay.fwd.to(dev), lay.bwd.to(dev))
        print(f"  B {B}: {B * n} nodes, {D + 1} slots; layout built on the host in "
              f"{time.perf_counter() - t0:.1f} s: n_pad {lay.n_pad}, forward W {lay.fwd.W}, "
              f"transpose D2 {lay.bwd.D}, W {lay.bwd.W}")

    def check_gather(B, C):
        gB, lay, fwd_t, bwd_t = layouts[B]
        xp = randn(lay.n_pad, C)
        xp[B * n:] = 0.0
        g = randn(lay.n_pad * lay.fwd.D, C)
        slots = wg.window_gather_fwd(xp, fwd_t)
        check_equal(f"window_gather B{B} C{C} vs plain", slots, wg.window_gather_fwd_plain(xp, fwd_t))
        # the same slots as the padded mode's own tables give them, in perm space
        inv = torch.as_tensor(lay.inv_perm, dtype=torch.long, device=dev)
        idx_perm = torch.empty_like(gB.senders_dp_sl)
        idx_perm[inv] = inv[gB.senders_dp_sl]
        mask_perm = torch.empty_like(gB.mask_dp_sl)
        mask_perm[inv] = gB.mask_dp_sl
        check_equal(f"window_gather B{B} C{C} vs x_perm[idx_perm]", slots[:B * n],
                    torch.where(mask_perm[..., None], xp[idx_perm], 0.0))
        held("window_gather_bwd", f"window_gather_bwd B{B} C{C}", wg.window_gather_bwd(g, bwd_t),
             wg.window_gather_bwd_plain(g, bwd_t), False)
        return xp, g

    for B in (tbs, sbs):
        for C in (256, 128):
            check_gather(B, C)
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"  forward bit-equal to the plain version and to x_perm[idx_perm], backward within "
          f"atol/rtol 1e-4, at B {tbs} and {sbs}, C 256 and 128")

    # the drive: conv1's projected features of block 0 on a padded serving batch,
    # gathered forward and backward, against the padded mode's own gather
    gB, lay, _, _ = layouts[tbs]
    conv = model.blocks[0].conv1
    seen = {}
    hook = conv.register_forward_pre_hook(lambda m, a: seen.__setitem__("x", a[0].clone()))
    with torch.no_grad():
        model(torch.as_tensor(snaps[:tbs].reshape(-1, 1), device=dev), gB)
    hook.remove()
    with torch.no_grad():
        xp_real = conv.lin(seen.pop("x").clone())                     # [B·n, H·C]
    C = xp_real.shape[1]
    perm = torch.as_tensor(lay.perm, dtype=torch.long, device=dev)
    inv = torch.as_tensor(lay.inv_perm, dtype=torch.long, device=dev)
    x_perm = torch.zeros((lay.n_pad, C), device=dev)
    x_perm[:tbs * n] = xp_real[perm]
    x_perm.requires_grad_()
    cot = randn(lay.n_pad, lay.fwd.D, C)
    gather = wg.make_window_gather(lay)
    reset_launches()
    slots = gather(x_perm)
    (d_x_perm,) = torch.autograd.grad(slots, x_perm, cot)
    torch.cuda.synchronize()
    drive = read_launches()
    if drive != counts(window_gather=1, window_gather_bwd=1):
        raise SystemExit(f"FAIL window gather drive launches {drive}")
    xl = xp_real.clone().requires_grad_()
    ref = torch.where(gB.mask_dp_sl[..., None], gB.gather_dp_sl(xl), 0.0)
    check_equal("window gather of conv1's features vs the padded gather", slots.detach()[:tbs * n][inv],
                ref.detach())
    (d_ref,) = torch.autograd.grad(ref, xl, cot[:tbs * n][inv])
    derr = check_close("window gather backward vs the padded gather's", d_x_perm[:tbs * n][inv],
                       d_ref, TOL, TOL, verbose=False)
    print(f"  drive on conv1's features of block 0 (B {tbs}, C {C}): slots bit-equal to the padded "
          f"mode's gather, backward within {derr:.3e} of its gather-based backward; launches "
          f"{drive['window_gather']} + {drive['window_gather_bwd']}")
    del model, inf_p, xp_real, x_perm, cot, slots, d_x_perm, xl, ref, d_ref
    torch.cuda.empty_cache()

    # ---- 24: kernel times ---------------------------------------------------------------
    print(f"[24] times of the two new kernels on {card}")
    rows = []

    def bound(r):
        t_bytes, t_ops = r["bytes"] / PEAK_BYTES_S * 1e3, r["ops"] / PEAK_F32_S * 1e3
        r["bound_ms"], r["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        rows.append(r)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms ({r['library']})"
        v2 = "" if "v2_ms" not in r else f", v2's backward on the same inputs {r['v2_ms']:.4f} ms"
        print(f"  {r['name']} B {r['B']} C {r['hc']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB){v2}")

    nnz = mask_ix.nnz
    n_empty = int(mask_ix.empty_row.shape[0])
    for B in (tbs, sbs):
        for H, C in ((2, 128), (1, 128)):
            a_dst, a_src, x_ext, d_out = check_acc("bigtown", mask, mask_ix, B, H, C)
            # inputs a_dst, a_src (once per extended row), x_ext, dO and the index the
            # passes walk (row_ptr, col, t_ptr, t_entry, t_row, the padded-row lists);
            # outputs d a_dst, d a_src_win (window layout), d x_ext
            io = 4 * (B * n_pad * H + B * n_ext * H + B * n_ext * H * C + B * n_pad * H * C)
            out_b = 4 * (B * n_pad * H + nB * B * W * H + B * n_ext * H * C)
            acc_bwd = lambda: ba.band_attention_acc_bwd(  # noqa: E731
                a_dst, a_src, x_ext, mask, d_out, 0.2, mask_ix)
            v2_bwd = lambda: ba.band_attention_bwd(a_dst, a_src, x_ext, mask, d_out, 0.2, mask_ix)  # noqa: E731
            split, v2_split = device_split(acc_bwd), device_split(v2_bwd)
            bound(dict(
                name="band_attention_acc_bwd", B=B, hc=H * C, library=None, library_ms=None,
                ms=cuda_ms(acc_bwd, 3, 20), device_ms=sum(ms for _, ms in split) or None,
                v2_ms=cuda_ms(v2_bwd, 3, 20), v2_device_ms=sum(ms for _, ms in v2_split) or None,
                plain_ms=cuda_ms(lambda: ba.band_attention_acc_bwd_plain(a_dst, a_src, x_ext, mask,
                                                                         d_out, 0.2), 1, 3),
                bytes=io + out_b + 4 * (n_pad + 1 + n_ext + 1 + 3 * nnz + nB + 1 + n_empty),
                ops=B * H * nnz * (4 * C + 12)))
            print(f"  device ms at B {B}, H·C {H * C}: acc {fmt_ms(rows[-1]['device_ms'])} by pass "
                  + ", ".join(f"{k} {ms:.4f}" for k, ms in split)
                  + f"; v2 {fmt_ms(rows[-1]['v2_device_ms'])} "
                  "by pass " + ", ".join(f"{k} {ms:.4f}" for k, ms in v2_split))
            del a_dst, a_src, x_ext, d_out
            torch.cuda.empty_cache()
    acc_b8 = {q["hc"]: q["device_ms"] for q in rows if q["name"] == "band_attention_acc_bwd" and q["B"] == tbs}
    print(f"  band_attention_acc_bwd in a batch-{tbs} step: 25 x {fmt_ms(acc_b8[256])} + 25 x "
          f"{fmt_ms(acc_b8[128])} = {fmt_ms(step_device_ms(acc_b8))} ms of device time")
    print("  its columns instances, registers and spills (v2's, kWindow false): "
          + columns_registers(big["ptxas"].get("band_attention_acc_bwd", ())))
    for B in (tbs, sbs):
        _, lay, fwd_t, bwd_t = layouts[B]
        for C in (256, 128):
            xp, g = check_gather(B, C)
            # library yardsticks on the same rows: index_select over x with one zero row
            # appended for the empty slots, and index_add_ of the slot grid onto the sources
            rel = fwd_t.rel.long()
            src = torch.where(rel != lay.fwd.W, fwd_t.win_start.long()[:, None] + rel,
                              lay.n_pad).reshape(-1)
            x_z = torch.cat([xp, xp.new_zeros(1, C)])
            check_equal(f"window_gather B{B} C{C} vs index_select", wg.window_gather_fwd(xp, fwd_t),
                        torch.index_select(x_z, 0, src).reshape(-1, lay.fwd.D, C))
            n_slots = lay.n_pad * lay.fwd.D
            bound(dict(
                name="window_gather", B=B, hc=C, library="torch.index_select",
                ms=cuda_ms(lambda: wg.window_gather_fwd(xp, fwd_t), 3, 20),
                plain_ms=cuda_ms(lambda: wg.window_gather_fwd_plain(xp, fwd_t), 1, 3),
                library_ms=cuda_ms(lambda: torch.index_select(x_z, 0, src), 3, 20),
                bytes=4 * (lay.n_pad * C + n_slots + lay.fwd.win_start.size + n_slots * C), ops=0))
            lib_bwd = x_z.new_zeros(lay.n_pad + 1, C)
            check_close(f"window_gather_bwd B{B} C{C} vs index_add_", wg.window_gather_bwd(g, bwd_t),
                        lib_bwd.index_add_(0, src, g)[:lay.n_pad], TOL, TOL, verbose=False)
            # the backward reads the valid slots' rows of the grid, not the empty ones
            n_valid = int(lay.bwd.mask.sum())
            bound(dict(
                name="window_gather_bwd", B=B, hc=C, library="Tensor.index_add_",
                ms=cuda_ms(lambda: wg.window_gather_bwd(g, bwd_t), 3, 20),
                plain_ms=cuda_ms(lambda: wg.window_gather_bwd_plain(g, bwd_t), 1, 3),
                library_ms=cuda_ms(lambda: lib_bwd.zero_().index_add_(0, src, g), 3, 20),
                bytes=4 * (n_valid * C + lay.bwd.rel.size + lay.bwd.win_start.size + lay.n_pad * C),
                ops=n_valid * C))
            del xp, g, x_z, lib_bwd, src
            torch.cuda.empty_cache()
    return dict(rows=rows, acc_step=acc_step, acc_fit=acc_fit, route_step=route_step, acc_b8=acc_b8,
                acc_worst=acc_worst, padded_worst=padded_worst, drive=drive,
                padded_serve_ms=padded_serve_ms, padded_serve_peak=padded_serve_peak,
                padded_step_ms=padded_step_ms, padded_step_peak=padded_step_peak,
                acc_shape=f"bigtown, n_pad {n_pad}, W {W}",
                gather_shape={B: f"bigtown B {B}: {B * n} nodes, {D + 1} slots, forward W "
                                 f"{lay_.fwd.W}, transpose D2 {lay_.bwd.D}"
                              for B, (_, lay_, _, _) in layouts.items()})


def dense_walk_phase(dev, card, held, reset_launches, read_launches, counts, ptxas, bs=32):
    """Phase 25: the dense factored pair as one walk over the mask index
    (``csrc/dense_walk.cuh``). Returns the kernel rows at B 32 (device time,
    einsum formulation, bounds) and the device time of the factored launches
    in a serving batch and a train step of each preset."""
    from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model
    from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
    from gnn_pressure_estimation_tpu_torch.train import Trainer
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

    print(f"[25] the dense factored pair's walk (csrc/dense_walk.cuh) on {card}")
    for name in ("fused_factored", "fused_factored_bwd"):
        inst = [r for r in ptxas.get(name, ()) if r[0].startswith("dense_walk_kernel")]
        print(f"  {name} instances: " + ("; ".join(
            f"{fn.removeprefix('dense_walk_kernel')} {regs} registers, {stack} bytes stack, spill "
            f"{st} / {ld}" for fn, regs, stack, st, ld in inst) or "not built in this run"))
    wn = parse_inp(os.path.join(REPO, "inputs", "synthctown.inp"))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name="synthctown")
    n = tpl.n_node
    mask = torch.as_tensor(tpl.dense_operators()["adj_sl_mask"], device=dev)
    ix = tpl.dense_index().to(dev)
    nnz = ix.nnz
    gen = torch.Generator(device=dev).manual_seed(25)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = []
    for H, C in ((2, 32), (1, 32), (2, 128), (1, 128)):      # conv1, conv2 of small; of large
        D = C + 1
        a_d, a_s = randn(bs, n, H), randn(bs, n, H)
        a_d[:, ::3] = 0.0                    # a_d + a_s == 0 where two zeroed nodes meet
        a_s[:, ::3] = 0.0
        rv, rq, g_pv, g_nq = (randn(bs, n, H, D) for _ in range(4))
        # a_dst, a_src, two wide inputs and two outputs, the list bounds and indices
        nbytes = 4 * (2 * bs * n * H + 4 * bs * n * H * D + n + 1 + nnz)
        ops = bs * H * nnz * (D + 1)
        for name, fn, plain, einsum, parts in (
            ("fused_factored", lambda: ga.fused_factored_fwd(a_d, a_s, rv, rq, mask, ix),
             lambda: ga.fused_factored_plain(a_d, a_s, rv, rq, mask),
             lambda: factored_einsum(mask, a_d, a_s, rv, rq), ("t_pv", "t_nq")),
            ("fused_factored_bwd", lambda: ga.fused_factored_bwd(a_d, a_s, mask, g_pv, g_nq, ix),
             lambda: ga.fused_factored_bwd_plain(a_d, a_s, mask, g_pv, g_nq),
             lambda: factored_bwd_einsum(mask, a_d, a_s, g_pv, g_nq), ("d rhs_v", "d rhs_q")),
        ):
            for part, g, r in zip(parts, fn(), plain()):
                held(name, f"{name} B{bs} H{H} C{C} {part}", g, r, verbose=False)
            t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
            r = dict(name=name, H=H, C=C, device_ms=device_ms(fn), ms=cuda_ms(fn, 5, 50),
                     plain_ms=cuda_ms(plain, 2, 5), einsum_ms=cuda_ms(einsum, 2, 5),
                     einsum_device_ms=device_ms(einsum, 5), library_ms=None, bytes=nbytes, ops=ops,
                     bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
            rows.append(r)
            share = "" if r["device_ms"] is None else f" ({r['bound_ms'] / r['device_ms']:.1%} of it)"
            print(f"  {name} H {H} C {C} (H·D {H * D}): device {fmt_ms(r['device_ms'])} ms, events "
                  f"{r['ms']:.4f} ms a call; bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                  f"{nbytes / 1e6:.2f} MB){share}; plain {r['plain_ms']:.4f} ms; einsum formulation "
                  f"(several calls) {r['einsum_ms']:.4f} ms, device {fmt_ms(r['einsum_device_ms'])}; "
                  f"library none")
        del a_d, a_s, rv, rq, g_pv, g_nq
        torch.cuda.empty_cache()

    # the factored launches of one synthctown serving batch and one train step
    sstats = NormStats(norm_type="znorm", mean=40.0, std=15.0)
    snaps = np.random.default_rng(25).standard_normal((bs, n)).astype(np.float32)
    walk = {}
    for preset, blocks in (("gatres_small", 15), ("gatres_large", 25)):
        model, _ = select_model(preset, device=dev, seed=0)
        inf = Inferencer(model, sstats, device=dev)
        obs = inf.observed_indices(tpl, "random", mask_rate=0.95, seed=0)
        serve = lambda: inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs)  # noqa: E731
        tmodel, ps = select_model(preset, device=dev, seed=0)
        tr = Trainer(tmodel, ps.train_config(batch_size=bs, mask_rate=0.95, seed=0), sstats, tpl,
                     device=dev)
        tgen = torch.Generator().manual_seed(0)
        step = lambda: tr.train_step(tpl, snaps, generator=tgen)  # noqa: E731
        serve(), step()
        torch.cuda.synchronize()
        reset_launches()
        serve()
        torch.cuda.synchronize()
        fwd = read_launches()
        reset_launches()
        step()
        torch.cuda.synchronize()
        stp = read_launches()
        if (fwd != counts(fused_factored=2 * blocks)
                or stp != counts(fused_factored=2 * blocks, fused_factored_bwd=2 * blocks)):
            raise SystemExit(f"FAIL {preset} factored launches: a forward {fwd}, a step {stp}")
        # fused_factored and fused_factored_bwd run the same dense_walk_kernel instances: in a
        # step the profiler reads the two directions under one name
        out = {}
        for what, fn in (("serve", serve), ("step", step)):
            split = device_split(fn)
            mine = [(k, ms) for k, ms in split if k.startswith("dense_walk_kernel")]
            out[what] = sum(ms for _, ms in mine) or None
            out[what + "_total"] = sum(ms for _, ms in split) or None
            print(f"  {preset} {'serving batch' if what == 'serve' else 'train step'} at B {bs}: "
                  f"{fmt_ms(out[what])} ms of device time in the "
                  f"{2 * blocks if what == 'serve' else 4 * blocks} factored launches ("
                  + ", ".join(f"{k} {ms:.4f}" for k, ms in mine)
                  + f") of {fmt_ms(out[what + '_total'])} ms in all")
        out.update(launches_per_forward=fwd["fused_factored"],
                   launches_per_step=stp["fused_factored"] + stp["fused_factored_bwd"])
        walk[preset] = out
        print(f"  {preset} launches: {fwd['fused_factored']} a forward; {stp['fused_factored']} + "
              f"{stp['fused_factored_bwd']} a train step")
        del model, inf, tmodel, tr
        torch.cuda.empty_cache()
    return dict(rows=rows, walk=walk)


# the f32 band-attention instances as they compiled before the bf16-operand switch
# (kBf16) existed, read from -Xptxas -v on an NVIDIA H100 80GB HBM3: registers, stack
# bytes, spill stores, spill loads. kBf16 adds a last template argument, the row
# walk's window layout (kWindow) the one before it; the f32 instances must compile
# to exactly these. The window forward's row walk and the dense softmax backward
# (the band backward's passes on one block) are recorded as they first compiled;
# the dense softmax forward (v2's row walk on one block) builds v2's instances.
V2_ROWWALK_F32 = {
    "band_rowwalk_kernel<2, false, false, false, false, false>": (64, 96, 108, 180),
    "band_rowwalk_kernel<2, true, false, false, false, false>": (64, 80, 88, 104),
    "band_rowwalk_kernel<1, false, false, false, false, false>": (64, 24, 24, 24),
    "band_rowwalk_kernel<1, true, false, false, false, false>": (64, 24, 20, 20),
    "window_mean_kernel<false>": (32, 0, 0, 0),
}
F32_BAND_INSTANCES = {
    "band_attention": V2_ROWWALK_F32,
    "fused_attention": V2_ROWWALK_F32,
    "band_attention_flash": {
        "band_rowwalk_kernel<2, false, true, false, false, false>": (64, 96, 104, 184),
        "band_rowwalk_kernel<2, true, true, false, false, false>": (64, 72, 80, 104),
        "band_rowwalk_kernel<1, false, true, false, false, false>": (64, 8, 4, 4),
        "band_rowwalk_kernel<1, true, true, false, false, false>": (64, 8, 4, 4),
        "window_mean_kernel<false>": (32, 0, 0, 0),
    },
    "band_attention_window": {
        "band_rowwalk_kernel<2, false, false, true, false, false>": (64, 96, 104, 164),
        "band_rowwalk_kernel<2, true, false, true, false, false>": (64, 80, 84, 108),
        "band_rowwalk_kernel<1, false, false, true, false, false>": (64, 24, 24, 24),
        "band_rowwalk_kernel<1, true, false, true, false, false>": (64, 24, 24, 24),
        "window_mean_kernel<true>": (32, 0, 0, 0),
    },
    **{src: {
        "columns_kernel<2, true, true, false, false>": (80, 16, 12, 24),
        "columns_kernel<2, false, false, false, false>": (80, 144, 160, 316),
        "columns_kernel<2, true, false, false, false>": (80, 8, 8, 8),
        "columns_kernel<1, true, true, false, false>": (64, 40, 40, 60),
        "columns_kernel<1, false, false, false, false>": (64, 120, 132, 260),
        "columns_kernel<1, true, false, false, false>": (64, 40, 36, 56),
        "cells_kernel": (38, 0, 0, 0), "empties_kernel": (32, 0, 0, 0),
        **({"rows_kernel": (40, 0, 0, 0), "weights_kernel": (40, 0, 0, 0)}
           if src == "band_attention_flash_bwd" else
           {"rows_kernel": (32, 8, 4, 4), "weights_kernel<false, false>": (32, 0, 0, 0)}),
    } for src in ("band_attention_bwd", "band_attention_acc_bwd", "band_attention_flash_bwd",
                  "fused_attention_bwd")},
    "band_attention_window_bwd": {
        "columns_kernel<2, true, true, true, false>": (80, 40, 48, 56),
        "columns_kernel<2, false, false, true, false>": (80, 224, 284, 484),
        "columns_kernel<2, true, false, true, false>": (80, 56, 64, 68),
        "columns_kernel<1, true, true, true, false>": (64, 24, 32, 32),
        "columns_kernel<1, false, false, true, false>": (64, 184, 228, 416),
        "columns_kernel<1, true, false, true, false>": (64, 64, 84, 124),
        "rows_kernel": (32, 8, 4, 4), "weights_kernel<false, false>": (32, 0, 0, 0),
        "cells_kernel": (38, 0, 0, 0), "empties_kernel": (32, 0, 0, 0),
    },
}
# the bf16-operand instances of the same sources, held like the f32 ones (read on an
# NVIDIA H100 80GB HBM3; the row walks of v2 and v4 as the walk over bf16 rows
# compiled when the extended rows were first stored in bf16: at NV 2 less spill
# than the f32 instance, at NV 1 held to 48 registers for a fifth thread block;
# the column walk as it compiled when it first read those rows: x_ext[e] as packed
# quads, a dO slot rounded two channels a conversion, no more spill than the
# instance that read f32 rows and rounded them on load; the dense softmax pair's
# bf16 instances are v2's, with the rows pass that rounds dp as it first compiled,
# at rows_kernel's numbers)
V2_ROWWALK_BF16 = {
    "band_rowwalk_kernel<2, false, false, false, true, false>": (64, 64, 72, 92),
    "band_rowwalk_kernel<2, true, false, false, true, false>": (64, 24, 28, 28),
    "band_rowwalk_kernel<1, false, false, false, true, false>": (48, 112, 108, 140),
    "band_rowwalk_kernel<1, true, false, false, true, false>": (48, 96, 64, 60),
    "window_mean_bf16_kernel": (32, 0, 0, 0),
}
BF16_BAND_INSTANCES = {
    "band_attention": V2_ROWWALK_BF16,
    "fused_attention": V2_ROWWALK_BF16,
    "band_attention_flash": {
        "band_rowwalk_kernel<2, false, true, false, true, false>": (64, 64, 88, 180),
        "band_rowwalk_kernel<2, true, true, false, true, false>": (64, 16, 12, 12),
        "band_rowwalk_kernel<1, false, true, false, true, false>": (48, 112, 96, 164),
        "band_rowwalk_kernel<1, true, true, false, true, false>": (48, 96, 56, 60),
        "window_mean_bf16_kernel": (32, 0, 0, 0),
    },
    **{src: {
        "columns_kernel<2, true, true, false, true>": (80, 8, 4, 8),
        "columns_kernel<2, false, false, false, true>": (80, 136, 152, 308),
        "columns_kernel<2, true, false, false, true>": (80, 8, 8, 8),
        "columns_kernel<1, true, true, false, true>": (64, 40, 40, 60),
        "columns_kernel<1, false, false, false, true>": (64, 112, 120, 232),
        "columns_kernel<1, true, false, false, true>": (64, 40, 40, 64),
        **({} if src == "band_attention_flash_bwd" else {"weights_kernel<true, false>": (40, 0, 0, 0)}),
        **({"rows_round_dp_kernel": (32, 8, 4, 4)} if src == "fused_attention_bwd" else {}),
    } for src in ("band_attention_bwd", "band_attention_acc_bwd", "band_attention_flash_bwd",
                  "fused_attention_bwd")},
}
# the instances of a GATConv whose activations are bf16 (dtype; logit_bf16 on the
# wrappers): the bf16 walk and the weights and rows passes with the logits and their
# cotangents rounded (kLogit), v2's and the dense softmax's, as they first compiled
# (read on an NVIDIA H100 80GB HBM3 at 700.00 W: no more spill than the bf16 instances)
V2_ROWWALK_LOGIT = {
    "band_rowwalk_kernel<2, false, false, false, true, true>": (64, 64, 72, 92),
    "band_rowwalk_kernel<2, true, false, false, true, true>": (64, 24, 28, 28),
    "band_rowwalk_kernel<1, false, false, false, true, true>": (48, 104, 108, 140),
    "band_rowwalk_kernel<1, true, false, false, true, true>": (48, 88, 64, 60),
}
LOGIT_BAND_INSTANCES = {
    "band_attention": V2_ROWWALK_LOGIT,
    "fused_attention": V2_ROWWALK_LOGIT,
    **{src: {"weights_kernel<true, true>": (40, 0, 0, 0), "rows_logit_kernel": (32, 0, 0, 0)}
       for src in ("band_attention_bwd", "fused_attention_bwd")},
}
# the bf16-operand instances: counter name → (the source, and the kernel of ``main``'s
# wrappers, that holds it; the line of the Pallas program it replaces, built with
# mx = bfloat16, in TPU_SRC)
BF16_INSTANCES = {
    "band_attention_bf16": ("band_attention", 289),
    "band_attention_flash_bf16": ("band_attention_flash", 626),
    "band_attention_bwd_bf16": ("band_attention_bwd", 313),
    "band_attention_acc_bwd_bf16": ("band_attention_acc_bwd", 1416),
    "band_attention_flash_bwd_bf16": ("band_attention_flash_bwd", 677),
}
# the dense softmax pair's bf16 instances (GATConv's attn_dtype=bfloat16 with
# attn_impl="softmax"): counter name → (the kernel of ``main``'s wrappers; the line in
# TPU_DENSE_SRC of the Pallas program of that direction, which has no bf16 build: the
# instances follow the JAX layer's XLA branch, gnn_pressure_estimation_tpu/models/layers.py)
DENSE_BF16_INSTANCES = {
    "fused_attention_bf16": ("fused_attention", 70),
    "fused_attention_bwd_bf16": ("fused_attention_bwd", 82),
}


def check_band_instances(ptxas) -> list:
    """Phase 2: every band-attention instance, f32 and bf16, at its recorded
    registers and spills (``F32_BAND_INSTANCES``, ``BF16_BAND_INSTANCES``),
    or the run fails; and the logit-rounding instances (``LOGIT_BAND_INSTANCES``).
    Returns the bf16 and logit instances' rows."""
    for src, ref in [*F32_BAND_INSTANCES.items(), *BF16_BAND_INSTANCES.items(),
                     *LOGIT_BAND_INSTANCES.items()]:
        got = {fn: tuple(v) for fn, *v in ptxas.get(src, ())}
        if not got:
            raise SystemExit(f"FAIL {src} was not built in this run: its registers were not read")
        for fn, want in ref.items():
            if got.get(fn) != want:
                raise SystemExit(f"FAIL {src}: {fn} {got.get(fn)} (registers, stack, spill stores, "
                                 f"spill loads) against the recorded {want}")
    return [(src, fn, *v) for src, ref in [*BF16_BAND_INSTANCES.items(),
                                          *LOGIT_BAND_INSTANCES.items()] for fn, v in ref.items()]


def bf16_phases(dev, card, rng, held, max_err, reset_launches, read_launches, counts, big,
                mega_tpl, sbs=32, tbs=8, mbs=8, mtbs=2):
    """Phases 26-30: the band attention's bf16-operand instances (GATRes's
    ``attn_dtype=bfloat16``): each against its plain version and its f32
    instance, bigtown GATRes-large through "dma" and "acc" on the trained
    weights (the bf16 fixture, serving, a train step), meganet through
    "flash" (its bf16 fixture, serving, a train step), and the instances'
    times beside the f32 ones. ``big`` carries the bigtown template,
    fixtures and layout, ``max_err`` the kernels' deviations from their plain
    versions. Returns the kernel rows and the launch counts."""
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.presets import (
        MODEL_REGISTRY, apply_model_knobs, select_model,
    )
    from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
    from gnn_pressure_estimation_tpu_torch.train import Trainer
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def operands(msk, B, H, C):
        """a_dst, a_src_win, x_ext, d_out; a third of the nodes zeroed, so
        that a_dst + a_src == 0 occurs."""
        nB_, BLK_, W_ = msk.shape
        np_, ne_ = nB_ * BLK_, nB_ * BLK_ + W_ - BLK_
        a_dst, a_src = randn(B, np_, H), randn(nB_, B, W_, H)
        a_dst[:, ::3] = 0.0
        a_src[:, :, ::3] = 0.0
        return a_dst, a_src, randn(B, ne_, H, C), randn(B, np_, H, C)

    gaps = {}                                     # instance → least share of 1e-3·max|ref|

    def apart(name, label, got, f32, ref):
        """The bf16 instance at least 1e-3·max|ref| from the f32 instance on
        the same inputs."""
        gap, top = float((got - f32).abs().max()), float(ref.abs().max())
        if gap < 1e-3 * top:
            raise SystemExit(f"FAIL {label}: only {gap:.3e} from the f32 instance (max |ref| {top:.3e})")
        gaps[name] = min(gaps.get(name, np.inf), gap / (1e-3 * top))
        return gap

    def check_v2(tag, msk, index, B, H, C, gap=True):
        """v2's forward and v2's and v3's backwards, bf16, against their plain
        versions (1e-4); v3's equal to v2's bit for bit; with ``gap``, each
        output's distance to the f32 instance's, which must be at least
        1e-3·max|ref|."""
        a_dst, a_src, x_ext, d_out = operands(msk, B, H, C)
        xb = x_ext.to(torch.bfloat16)            # the stored rows the model's path hands it
        label = f"{tag} B{B} H{H} C{C}"
        got = ba.band_attention_fwd(a_dst, a_src, xb, msk, 0.2, index, True)
        ref = ba.band_attention_plain(a_dst, a_src, xb, msk, 0.2, True)
        held("band_attention_bf16", f"band_attention bf16 {label}", got, ref, False)
        check_equal(f"band_attention bf16 {label}, f32 rows through the wrapper's cast",
                    ba.band_attention_fwd(a_dst, a_src, x_ext, msk, 0.2, index, True), got)
        line = []
        if gap:
            f32 = ba.band_attention_fwd(a_dst, a_src, x_ext, msk, 0.2, index)
            line.append(f"out {apart('band_attention_bf16', label, got, f32, ref):.3e}")
        got = ba.band_attention_bwd(a_dst, a_src, xb, msk, d_out, 0.2, index, True)
        ref = ba.band_attention_bwd_plain(a_dst, a_src, xb, msk, d_out, 0.2, True)
        acc = ba.band_attention_acc_bwd(a_dst, a_src, xb, msk, d_out, 0.2, index, True)
        cast = ba.band_attention_bwd(a_dst, a_src, x_ext, msk, d_out, 0.2, index, True)
        f32 = ba.band_attention_bwd(a_dst, a_src, x_ext, msk, d_out, 0.2, index) if gap else ref
        for part, g, r, q, c, f in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref, acc, cast,
                                       f32):
            held("band_attention_bwd_bf16", f"band_attention_bwd bf16 {label} {part}", g, r, False)
            held("band_attention_acc_bwd_bf16", f"band_attention_acc_bwd bf16 {label} {part}", q, r,
                 False)
            check_equal(f"band_attention_acc_bwd bf16 {label} {part} vs band_attention_bwd bf16", q, g)
            check_equal(f"band_attention_bwd bf16 {label} {part}, f32 rows through the wrapper's "
                        f"cast", c, g)
            if gap:
                line.append(f"{part} {apart('band_attention_bwd_bf16', label, g, f, r):.3e}")
                apart("band_attention_acc_bwd_bf16", label, q, f, r)
        print(f"  v2 / v3 bf16 {label}: within 1e-4 of the plain versions (max so far: forward "
              f"{max_err_of('band_attention_bf16'):.3e}, backward "
              f"{max_err_of('band_attention_bwd_bf16'):.3e}), v3's backward v2's bit for bit, "
              f"forward and backward of f32 rows (cast once in the wrapper) those of the bf16 rows"
              + (f"; from the f32 instance: " + ", ".join(line) if gap else ""))
        return a_dst, a_src, x_ext, d_out

    def check_v4(tag, msk, index, B, H, C, gap=True):
        """v4's forward (out, m, Z) and backward, bf16, against their plain
        versions; the backward from the plain forward's m, Z and delta, and
        from the kernel's own."""
        a_dst, a_src, x_ext, d_out = operands(msk, B, H, C)
        xb = x_ext.to(torch.bfloat16)
        label = f"{tag} B{B} H{H} C{C}"
        own = ba.band_attention_flash_fwd(a_dst, a_src, xb, msk, 0.2, index, True)
        ref = ba.band_attention_flash_plain(a_dst, a_src, xb, msk, 0.2, True)
        cast = ba.band_attention_flash_fwd(a_dst, a_src, x_ext, msk, 0.2, index, True)
        for part, g, r, c in zip(("out", "m", "Z"), own, ref, cast):
            held("band_attention_flash_bf16", f"band_attention_flash bf16 {label} {part}", g, r, False)
            check_equal(f"band_attention_flash bf16 {label} {part}, f32 rows through the wrapper's "
                        f"cast", c, g)
        line = []
        if gap:
            f32 = ba.band_attention_flash_fwd(a_dst, a_src, x_ext, msk, 0.2, index)[0]
            line.append(f"out {apart('band_attention_flash_bf16', label, own[0], f32, ref[0]):.3e}")
        out, m, Z = ref
        delta = (d_out * out).sum(dim=-1)
        args = (a_dst, a_src, xb, msk, m, Z, delta, d_out, 0.2)
        got = ba.band_attention_flash_bwd(*args, index, True)
        ref = ba.band_attention_flash_bwd_plain(*args, True)
        mine = ba.band_attention_flash_bwd(a_dst, a_src, xb, msk, own[1], own[2],
                                           (d_out * own[0]).sum(dim=-1), d_out, 0.2, index, True)
        cast = ba.band_attention_flash_bwd(a_dst, a_src, x_ext, msk, m, Z, delta, d_out, 0.2, index,
                                           True)
        f32 = ba.band_attention_flash_bwd(a_dst, a_src, x_ext, msk, m, Z, delta, d_out, 0.2,
                                          index) if gap else ref
        for part, g, g2, r, c, f in zip(("d a_dst", "d a_src_win", "d x_ext"), got, mine, ref, cast,
                                        f32):
            held("band_attention_flash_bwd_bf16", f"band_attention_flash_bwd bf16 {label} {part}", g, r,
                 False)
            held("band_attention_flash_bwd_bf16",
                 f"band_attention_flash_bwd bf16 {label} {part}, from the kernel's out, m, Z", g2, r,
                 False)
            check_equal(f"band_attention_flash_bwd bf16 {label} {part}, f32 rows through the "
                        f"wrapper's cast", c, g)
            if gap:
                line.append(f"{part} {apart('band_attention_flash_bwd_bf16', label, g, f, r):.3e}")
        print(f"  v4 bf16 {label}: within 1e-4 of the plain versions (max so far: forward "
              f"{max_err_of('band_attention_flash_bf16'):.3e}, backward "
              f"{max_err_of('band_attention_flash_bwd_bf16'):.3e}); f32 rows through the cast: "
              f"the same out, m, Z and gradients"
              + (f"; from the f32 instance: " + ", ".join(line) if gap else ""))
        return a_dst, a_src, x_ext, d_out, m, Z, delta

    max_err_of = max_err.get
    tpl, mask, mask_ix = big["tpl"], big["mask"], big["mask_ix"]
    bl = tpl.band_layout()
    nB, BLK, W = bl.adj_mask.shape
    n_pad, n_ext = bl.n_pad, bl.n_pad + W - BLK
    mbl = mega_tpl.band_layout()
    mmask = torch.as_tensor(mbl.adj_mask.view(np.int8), device=dev)
    mix = mega_tpl.band_index("adj_mask").to(dev)

    # ---- 26: each bf16 instance against its plain version and its f32 instance ----
    print(f"[26] the bf16-operand instances vs their plain versions (atol/rtol 1e-4) and their "
          f"f32 instances on the same inputs (at least 1e-3·max|ref| apart); the forwards read "
          f"the rows stored in bf16, and f32 rows through the wrappers' cast give the same")
    for B in (1, tbs, sbs):
        for H in (2, 1):
            check_v2("bigtown", mask, mask_ix, B, H, 128)
            torch.cuda.empty_cache()
    for B in (1, mtbs, mbs):
        for H in (2, 1):
            check_v4("meganet", mmask, mix, B, H, 128)
            torch.cuda.empty_cache()
    rmask = rng.random((3, 16, 70)) < 0.3
    rmask[-1, -5:] = False                        # fully masked (padded) rows
    wide = rng.random((2, 16, 200)) < 0.4         # rows of ~80 entries: the sweeps for m and Z
    for m_np, shapes in ((rmask, ((3, 2, 64), (2, 1, 300), (2, 3, 33), (2, 40, 4))),
                         (wide, ((2, 2, 64), (1, 1, 160), (1, 33, 3)))):
        m_t = torch.as_tensor(m_np.view(np.int8), device=dev)
        for B, H, C in shapes:
            check_v2("ragged", m_t, None, B, H, C, gap=False)
            check_v4("ragged", m_t, None, B, H, C, gap=False)
    # bf16 rows 2 bytes off 16-byte alignment: the scalar loads, forward and backward
    a_dst, a_src, x_ext, d_out = operands(mask, 1, 2, 128)
    xo = torch.empty(x_ext.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(x_ext.shape)
    xo.copy_(x_ext)
    held("band_attention_bf16", "band_attention bf16 bigtown B1 H2 C128, rows off alignment",
         ba.band_attention_fwd(a_dst, a_src, xo, mask, 0.2, mask_ix, True),
         ba.band_attention_plain(a_dst, a_src, xo, mask, 0.2, True))
    for part, g, r in zip(("out", "m", "Z"),
                          ba.band_attention_flash_fwd(a_dst, a_src, xo, mask, 0.2, mask_ix, True),
                          ba.band_attention_flash_plain(a_dst, a_src, xo, mask, 0.2, True)):
        held("band_attention_flash_bf16", f"band_attention_flash bf16 bigtown B1 H2 C128 {part}, "
             f"rows off alignment", g, r)
    parts = ("d a_dst", "d a_src_win", "d x_ext")
    for name, fn in (("band_attention_bwd_bf16", ba.band_attention_bwd),
                     ("band_attention_acc_bwd_bf16", ba.band_attention_acc_bwd)):
        got = fn(a_dst, a_src, xo, mask, d_out, 0.2, mask_ix, True)
        ref = ba.band_attention_bwd_plain(a_dst, a_src, xo, mask, d_out, 0.2, True)
        for part, g, r in zip(parts, got, ref):
            held(name, f"{name[:-5]} bf16 bigtown B1 H2 C128 {part}, rows off alignment", g, r)
    out, m, Z = ba.band_attention_flash_plain(a_dst, a_src, xo, mask, 0.2, True)
    stats = (m, Z, (d_out * out).sum(dim=-1), d_out, 0.2)
    for part, g, r in zip(parts, ba.band_attention_flash_bwd(a_dst, a_src, xo, mask, *stats, mask_ix,
                                                             True),
                          ba.band_attention_flash_bwd_plain(a_dst, a_src, xo, mask, *stats, True)):
        held("band_attention_flash_bwd_bf16", f"band_attention_flash_bwd bf16 bigtown B1 H2 C128 "
             f"{part}, rows off alignment", g, r)
    del a_dst, a_src, x_ext, xo, d_out, out, m, Z, stats
    torch.cuda.synchronize()
    print("  every gap to the f32 instance, as a share of 1e-3·max|ref|, at least: "
          + ", ".join(f"{k} {v:.1f}×" for k, v in gaps.items()))

    # ---- 27: bigtown, GATRes-large, attn_dtype bf16, on the trained weights ------------
    print("[27] bigtown: GATRes-large with attn_dtype='bfloat16' (apply_model_knobs) on the trained "
          "weights")
    npz = big["npz"]
    n = tpl.n_node
    fxb = np.load(os.path.join(REPO, "artifacts", "parity_train_bigtown_bf16.npz"))
    if bytes(fxb["attn_dtype"]).decode() != "bfloat16":
        raise SystemExit("FAIL parity_train_bigtown_bf16.npz is not a bf16 fixture")
    tstats = NormStats(norm_type="znorm", mean=float(fxb["stats_mean"]), std=float(fxb["stats_std"]))
    xb1 = big["x"][:, 0][None, :]

    def bigtown_model(dtype="bfloat16"):
        m, preset = select_model("gatres_large", device=dev)
        m.load_state_dict(params_from_parity_npz(npz))
        return apply_model_knobs(m, attn_dtype=dtype), preset

    def fixture_forward(model, graph, fx, nn, hard=True):
        """The serving forward of the fixture's masked input: the output and
        each block's |act| max and mean over the real rows against the JAX
        values, held to 1e-3 where ``hard``. Returns the output's deviation,
        each block's and the launch counts."""
        acts = {}
        hooks = [blk.register_forward_hook(lambda m_, i, o, k=k: acts.__setitem__(k, o))
                 for k, blk in enumerate(model.blocks)]
        reset_launches()
        with torch.inference_mode():
            out = graph.unpack_nodes(
                model(graph.pack_nodes(torch.as_tensor(fx["x_in"], device=dev), nn), graph), nn)
            torch.cuda.synchronize()
        launched = read_launches()
        for h in hooks:
            h.remove()
        if not torch.isfinite(out).all():
            raise SystemExit("FAIL bf16 fixture forward: non-finite output")
        out_err = float((out.cpu() - torch.as_tensor(fx["ours_out"])).abs().max())
        real = [graph.unpack_nodes(acts[k], nn) for k in range(len(model.blocks))]
        blocks = [max(abs(float(a.abs().max()) - float(fx["block_absmax"][k])),
                      abs(float(a.double().mean()) - float(fx["block_mean"][k])))
                  for k, a in enumerate(real)]
        if hard and max(out_err, *blocks) > 1e-3:
            raise SystemExit(f"FAIL bf16 fixture forward: output off by {out_err:.3e}, block "
                             f"statistics by {max(blocks):.3e} (1e-3)")
        return out_err, blocks, launched

    def fixture_step(label, make, tpl_, fx, xb, fx32=None):
        """The fixture's B 1 step: loss, metrics, every gradient and the
        parameters after 3 Adam steps under the bounds of phase 7; with
        ``fx32`` (the same step's f32 fixture) the deviations are reported
        beside the f32 step's own distance from the bf16 fixture, the size of
        the knob's effect, and the run fails only on a loss no nearer the
        bf16 fixture's than the f32 fixture's is (bf16 rounding flips:
        ROADMAP Queue 3). Returns the launch counts and the gradients."""
        tr = make()
        g1, x1, m1, k1 = tr._prepare(tpl_, xb, fx["mask"], None, None)
        tr.model.train()
        reset_launches()
        loss, mets, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        launched = read_launches()
        loss = float(loss.detach())
        names = [k for k, _ in tr.model.named_parameters()]
        refs = [torch.as_tensor(fx[f"grad_{k}"], device=dev) for k in names]
        if fx32 is not None:
            if not all(torch.isfinite(g).all() for g in grads):
                raise SystemExit(f"FAIL {label}: non-finite gradients")
            l16, l32 = float(fx["loss"]), float(fx32["loss"])
            if abs(loss - l16) >= abs(l32 - l16):
                raise SystemExit(f"FAIL {label} loss {loss!r}: no nearer the bf16 fixture's {l16!r} "
                                 f"than the f32 fixture's {l32!r} is")

            def shares(gs):
                return [float((g - r).abs().max()) / (1e-3 * float(r.abs().max()) + 1e-6)
                        for g, r in zip(gs, refs)]
            mine = shares(grads)
            f32 = shares([torch.as_tensor(fx32[f"grad_{k}"], device=dev) for k in names])
            print(f"  {label}: B 1 step against the JAX Trainer's bf16 fixture: loss {loss:.7f} "
                  f"against {l16:.7f} ({abs(loss - l16) / l16:.2e} relative; the f32 fixture's "
                  f"{l32:.7f}, {abs(l32 - l16) / l16:.2e}); gradients as shares of 1e-3·max|g_ref| + "
                  f"1e-6: {sum(q > 1 for q in mine)} of {len(names)} beyond 1, the worst "
                  f"{max(mine):.1%} ({names[int(np.argmax(mine))]}), the median "
                  f"{float(np.median(mine)):.1%}; the f32 fixture's gradients against the bf16 "
                  f"fixture's: {sum(q > 1 for q in f32)} beyond 1, the worst {max(f32):.1%}, the "
                  f"median {float(np.median(f32)):.1%}; launches "
                  f"{({k: v for k, v in launched.items() if v})}")
            del tr
            torch.cuda.empty_cache()
            return launched, grads
        if abs(loss - float(fx["loss"])) > 1e-4 * abs(float(fx["loss"])):
            raise SystemExit(f"FAIL {label} loss {loss!r} against the fixture's {float(fx['loss'])!r}")
        for k, v in mets.items():
            ref, atol = float(fx[f"metric_{k}"]), 1e-3 if k in ("train_corr", "train_r2") else 1e-4
            if abs(float(v) - ref) > 1e-3 * abs(ref) + atol:
                raise SystemExit(f"FAIL {label} metric {k}: {float(v)!r} against {ref!r}")
        worst = grads_within(f"{label} B 1 step vs JAX", names, grads, refs)
        losses3 = [float(tr.train_step(tpl_, xb, mask=fx["mask"])[0]) for _ in range(3)]
        perr, pnoise = adam_param_errors(tr.model.named_parameters(), fx)
        lerr = max(abs(a - b) / abs(b) for a, b in zip(losses3, fx["step_losses"]))
        if perr > 3e-4 or pnoise > 3 * 2 * 5e-4 or lerr > 1e-3:
            raise SystemExit(f"FAIL {label} after 3 Adam steps: parameters off by {perr:.3e} (atol "
                             f"3e-4; {pnoise:.3e} where the gradient is noise, bound 3e-3), step "
                             f"losses by {lerr:.3e} relative (1e-3)")
        print(f"  {label}: B 1 step vs the JAX Trainer's bf16 fixture: loss {loss:.7f} against "
              f"{float(fx['loss']):.7f}; {len(names)} gradients within 1e-3·max|g_ref| + 1e-6, the "
              f"worst at {worst:.1%}; after 3 Adam steps parameters within {perr:.3e} ({pnoise:.3e} "
              f"where the first gradient is below its tolerance), step losses within {lerr:.3e}; "
              f"launches {({k: v for k, v in launched.items() if v})}")
        del tr
        torch.cuda.empty_cache()
        return launched, grads

    # bigtown's trained 25 blocks carry a bf16 rounding flip (an operand that the
    # two packages' f32 values put on either side of a rounding boundary) to every
    # block after it: the deviations are reported beside the size of the knob's
    # effect, and the run fails on a loss no nearer the bf16 fixture than f32's
    model, preset = bigtown_model()
    out_err, blocks, fwd_launches = fixture_forward(model.eval(), tpl.batch(1, device=dev), fxb, n,
                                                    hard=False)
    if fwd_launches != counts(band_attention_bf16=50, band_spmm=25):
        raise SystemExit(f"FAIL launches per bf16 forward {fwd_launches}")
    first = next((k for k, e in enumerate(blocks) if e > 1e-3), None)
    out_f32, blocks_f32, _ = fixture_forward(bigtown_model("float32")[0].eval(),
                                             tpl.batch(1, device=dev), fxb, n, hard=False)
    print(f"  forward vs JAX: output within {out_err:.3e} (the f32 model's {out_f32:.3e}, block "
          f"statistics {max(blocks_f32):.3e}); "
          f"per-block |act| max and mean: " + ("all within 1e-3" if first is None else
          f"within 1e-3 up to block {first - 1}, block {first} off by {blocks[first]:.3e}, the worst "
          f"{max(blocks):.3e}") + "; launches: 50 band_attention bf16 + 25 band_spmm, 0 "
          "band_attention f32")
    per_step, route_grads = {}, {}
    for route, bwd in (("dma", "band_attention_bwd_bf16"), ("acc", "band_attention_acc_bwd_bf16")):
        launched, route_grads[route] = fixture_step(
            f'bigtown "{route}"',
            lambda: Trainer(bigtown_model()[0], preset.train_config(batch_size=1, band_attn=route),
                            tstats, tpl, device=dev), tpl, fxb, xb1, fx32=big["tfx"])
        want = counts(band_attention_bf16=50, band_spmm=25, band_spmm_bwd=25, **{bwd: 50})
        if launched != want:
            raise SystemExit(f"FAIL launches per bf16 {route} step {launched}, expected {want}")
        per_step[route] = launched
    if not all(torch.equal(a, b) for a, b in zip(route_grads["dma"], route_grads["acc"])):
        raise SystemExit("FAIL the bf16 steps under dma and acc differ: v3's backward is v2's")
    print("  the B 1 step's gradients under \"dma\" and \"acc\" equal bit for bit")
    del route_grads

    # serving at batch 32, bf16 and f32 in turns on the same snapshots
    sstats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    snaps = (xb1 + 0.1 * rng.standard_normal((2 * sbs, n))).astype(np.float32)
    infs = {d: Inferencer(bigtown_model(d)[0], sstats, device=dev) for d in ("float32", "bfloat16")}
    obs = infs["bfloat16"].observed_indices(tpl, "random", mask_rate=0.95, seed=0)
    for inf in infs.values():
        inf.infer(tpl, snaps[:sbs], obs, scaled=True, batch_size=sbs)       # warm-up
    serve_ms = {d: [] for d in infs}
    for d in ("float32", "bfloat16", "bfloat16", "float32"):
        reset_launches()
        serve_ms[d].append(cuda_ms(lambda: infs[d].infer(tpl, snaps, obs, scaled=True, batch_size=sbs),
                                   0, 1) / 2)
        launched = read_launches()
        want = counts(band_spmm=50, **{"band_attention_bf16" if d == "bfloat16" else "band_attention": 100})
        if launched != want:
            raise SystemExit(f"FAIL bigtown {d} serving launches {launched}, expected {want}")
    reset_launches()
    res = infs["bfloat16"].infer(tpl, snaps, obs, scaled=True, batch_size=sbs)
    big_serve = read_launches()
    f32res = infs["float32"].infer(tpl, snaps, obs, scaled=True, batch_size=sbs)
    if not np.isfinite(res.pred).all() or res.pred.shape != snaps.shape:
        raise SystemExit("FAIL bf16 serving output is not a finite [S, n] field")
    dfield = float(np.abs(res.pred - f32res.pred).max())
    print(f"  serving {2 * sbs} snapshots at batch {sbs}: bf16 "
          + " / ".join(f"{v:.3f}" for v in serve_ms["bfloat16"]) + " ms a batch, f32 "
          + " / ".join(f"{v:.3f}" for v in serve_ms["float32"]) + f" ms (in turns f32, bf16, bf16, "
          f"f32; {card}); 50 band_attention bf16 + 25 band_spmm launches a forward, none of the f32 "
          f"band attention; the bf16 fields {dfield:.3e} m from the f32 ones")
    profile_batch(lambda: infs["bfloat16"].infer(tpl, snaps[:sbs], obs, scaled=True, batch_size=sbs),
                  "one bf16 serving batch of bigtown")
    del infs
    torch.cuda.empty_cache()

    # a train step at batch 8, bf16 and f32 in turns
    tmask = (rng.random((tbs, n)).argsort(1) < int(n * 0.95)).reshape(-1)
    batch = snaps[:tbs]
    step_ms, big_trace = {"float32": [], "bfloat16": []}, {}
    for d in ("float32", "bfloat16", "bfloat16", "float32"):
        tr = Trainer(bigtown_model(d)[0], preset.train_config(batch_size=tbs), tstats, tpl, device=dev)
        tr.train_step(tpl, batch, mask=tmask)                            # warm-up
        torch.cuda.synchronize()
        reset_launches()
        step_ms[d].append(cuda_ms(lambda: tr.train_step(tpl, batch, mask=tmask), 0, 3))
        launched = read_launches()
        names = (("band_attention_bf16", "band_attention_bwd_bf16") if d == "bfloat16"
                 else ("band_attention", "band_attention_bwd"))
        want = counts(band_spmm=75, band_spmm_bwd=75, **{names[0]: 150, names[1]: 150})
        if launched != want:
            raise SystemExit(f"FAIL bigtown {d} step launches {launched}, expected {want}")
        losses = [float(tr.train_step(tpl, batch, mask=tmask)[0])]
        if not np.isfinite(losses).all():
            raise SystemExit(f"FAIL bigtown {d} step at batch {tbs}: loss {losses}")
        if len(step_ms[d]) == 1:
            if d == "bfloat16":
                profile_batch(lambda: tr.train_step(tpl, batch, mask=tmask),
                              f"one bf16 bigtown train step at batch {tbs}", top=12)
            big_trace[d] = step_trace(lambda: tr.train_step(tpl, batch, mask=tmask), tbs, n_ext)
        del tr
        torch.cuda.empty_cache()
    print(f"  train step at batch {tbs}: bf16 " + " / ".join(f"{v:.3f}" for v in step_ms["bfloat16"])
          + " ms, f32 " + " / ".join(f"{v:.3f}" for v in step_ms["float32"]) + f" ms (in turns; {card});"
          " 50 band_attention bf16 + 50 band_attention_bwd bf16 launches a step")
    print(f"  train step at batch {tbs}, " + no_row_copies(f"bigtown bf16 step at batch {tbs}",
                                                        big_trace))

    # ---- 28: meganet through "flash" -----------------------------------------------
    mn = mega_tpl.n_node
    fxm = np.load(os.path.join(REPO, "artifacts", "parity_train_meganet_bf16.npz"))
    depth = int(fxm["num_blocks"])
    mnpz = os.path.join(REPO, "artifacts", "parity_train_meganet_bf16.npz")
    print(f"[28] meganet: GATRes nc {int(fxm['nc'])}, attn_dtype bf16, the {depth}-block fixture, "
          f"then 25 blocks at full width")
    mstats = NormStats(norm_type="znorm", mean=float(fxm["stats_mean"]), std=float(fxm["stats_std"]))

    def mega_fixture_model():
        m = GATRes(depth, int(fxm["nc"]), attn_impl="factored")
        m.load_state_dict(params_from_parity_npz(mnpz))
        return apply_model_knobs(m.to(dev), attn_dtype="bfloat16")

    out_err, blocks, launched = fixture_forward(mega_fixture_model().eval(),
                                                mega_tpl.batch(1, device=dev), fxm, mn)
    stat_err = max(blocks)
    if launched != counts(band_attention_flash_bf16=2 * depth, band_spmm=depth):
        raise SystemExit(f"FAIL launches per meganet bf16 fixture forward {launched}")
    print(f"  forward vs JAX: output within {out_err:.3e}, per-block |act| max and mean within "
          f"{stat_err:.3e}; launches {2 * depth} band_attention_flash bf16 + {depth} band_spmm")
    launched, _ = fixture_step(
        "meganet", lambda: Trainer(mega_fixture_model(),
                                   MODEL_REGISTRY["gatres_large"].train_config(batch_size=1),
                                   mstats, mega_tpl, device=dev), mega_tpl, fxm, fxm["x"][:, 0][None, :])
    if launched != counts(band_attention_flash_bf16=2 * depth, band_spmm=depth,
                          band_attention_flash_bwd_bf16=2 * depth, band_spmm_bwd=depth):
        raise SystemExit(f"FAIL launches per meganet bf16 fixture step {launched}")

    msnaps = rng.standard_normal((2 * mbs, mn)).astype(np.float32)
    mmodels = {}
    for d in ("float32", "bfloat16"):
        mmodel, mpreset = select_model("gatres_large", device=dev, seed=0)
        mmodels[d] = apply_model_knobs(mmodel, attn_dtype=d)
    minfs = {d: Inferencer(m, sstats, device=dev) for d, m in mmodels.items()}
    mobs = minfs["bfloat16"].observed_indices(mega_tpl, "random", mask_rate=0.95, seed=0)
    for inf in minfs.values():
        inf.infer(mega_tpl, msnaps[:mbs], mobs, scaled=True, batch_size=mbs)
    mserve_ms = {d: [] for d in minfs}
    for d in ("float32", "bfloat16", "bfloat16", "float32"):
        reset_launches()
        mserve_ms[d].append(cuda_ms(lambda: minfs[d].infer(mega_tpl, msnaps, mobs, scaled=True,
                                                            batch_size=mbs), 0, 1) / 2)
        launched = read_launches()
        want = counts(band_spmm=50, **{"band_attention_flash_bf16" if d == "bfloat16"
                                       else "band_attention_flash": 100})
        if launched != want:
            raise SystemExit(f"FAIL meganet {d} serving launches {launched}, expected {want}")
    reset_launches()
    mres = minfs["bfloat16"].infer(mega_tpl, msnaps, mobs, scaled=True, batch_size=mbs)
    mega_serve = read_launches()
    if not np.isfinite(mres.pred).all():
        raise SystemExit("FAIL meganet bf16 serving output is not finite")
    print(f"  serving {2 * mbs} snapshots at batch {mbs}: bf16 "
          + " / ".join(f"{v:.3f}" for v in mserve_ms["bfloat16"]) + " ms a batch, f32 "
          + " / ".join(f"{v:.3f}" for v in mserve_ms["float32"]) + f" ms (in turns; {card}); 50 "
          "band_attention_flash bf16 + 25 band_spmm launches a forward")
    del minfs
    torch.cuda.empty_cache()
    mtmask = (rng.random((mtbs, mn)).argsort(1) < int(mn * 0.95)).reshape(-1)
    mbatch = msnaps[:mtbs]
    mstep_ms, mega_trace = {"float32": [], "bfloat16": []}, {}
    mpeak = {"float32": [], "bfloat16": []}             # GB, each turn
    for d in ("float32", "bfloat16", "bfloat16", "float32"):
        m = GATRes(25, 128, attn_impl="factored")
        m.load_state_dict(mmodels[d].state_dict())
        tr = Trainer(apply_model_knobs(m, attn_dtype=d), mpreset.train_config(batch_size=mtbs), sstats,
                     mega_tpl, device=dev)
        tr.train_step(mega_tpl, mbatch, mask=mtmask)
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        mstep_ms[d].append(cuda_ms(lambda: tr.train_step(mega_tpl, mbatch, mask=mtmask), 0, 3))
        mpeak[d].append(torch.cuda.max_memory_allocated() / 1e9)
        launched = read_launches()
        names = (("band_attention_flash_bf16", "band_attention_flash_bwd_bf16") if d == "bfloat16"
                 else ("band_attention_flash", "band_attention_flash_bwd"))
        want = counts(band_spmm=75, band_spmm_bwd=75, **{names[0]: 150, names[1]: 150})
        if launched != want:
            raise SystemExit(f"FAIL meganet {d} step launches {launched}, expected {want}")
        if len(mstep_ms[d]) == 1:
            if d == "bfloat16":
                mega_step = launched
            mega_trace[d] = step_trace(lambda: tr.train_step(mega_tpl, mbatch, mask=mtmask), mtbs,
                                       mbl.n_pad + mbl.W - mbl.BLK)
        del tr, m
        torch.cuda.empty_cache()
    print(f"  train step at batch {mtbs}: bf16 " + " / ".join(f"{v:.3f}" for v in mstep_ms["bfloat16"])
          + " ms, f32 " + " / ".join(f"{v:.3f}" for v in mstep_ms["float32"]) + f" ms (in turns; {card});"
          " 50 band_attention_flash bf16 + 50 band_attention_flash_bwd bf16 launches a step")
    print(f"  peak device memory of the step at batch {mtbs} (each turn): bf16 "
          + " / ".join(f"{v:.3f}" for v in mpeak["bfloat16"]) + " GB, f32 "
          + " / ".join(f"{v:.3f}" for v in mpeak["float32"]) + " GB (the bf16 step saves its "
          "extended rows in bf16); "
          + no_row_copies(f"meganet bf16 step at batch {mtbs}", mega_trace))
    del mmodels
    torch.cuda.empty_cache()

    rows = bf16_times(dev, card, randn, operands, big, mega_tpl, sbs, tbs, mbs, mtbs)
    return dict(rows=rows, gaps=gaps, step=per_step, big_serve=big_serve, mega_serve=mega_serve,
                mega_step=mega_step, traces={"bigtown_b8": big_trace, "meganet_b2": mega_trace},
                mega_peak_gb=mpeak)


def bf16_times(dev, card, randn, operands, big, mega_tpl, sbs, tbs, mbs, mtbs):
    """Phase 29: the bf16-operand instances timed beside their f32 instances
    on the same inputs, with their plain versions and bounds. Returns the
    rows."""
    from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba

    tpl, mask, mask_ix = big["tpl"], big["mask"], big["mask_ix"]
    bl = tpl.band_layout()
    nB, BLK, W = bl.adj_mask.shape
    n_pad, n_ext = bl.n_pad, bl.n_pad + W - BLK
    mbl = mega_tpl.band_layout()
    mmask = torch.as_tensor(mbl.adj_mask.view(np.int8), device=dev)
    mix = mega_tpl.band_index("adj_mask").to(dev)
    # ---- 29: times of the bf16 instances beside the f32 ones ----------------------------
    print(f"[29] times of the bf16-operand instances beside their f32 instances on {card} (CUDA "
          f"events, 20 launches after 3, in turns f32, bf16, bf16, f32; the bf16 instances read "
          f"the rows stored in bf16, their bounds at 2-byte x rows)")
    rows = []

    def timed(name, B, hc, net, f32, bf, plain, nbytes, ops):
        t = {"f32": [], "bf16": []}
        for which in ("f32", "bf16", "bf16", "f32"):
            t[which].append(cuda_ms(f32 if which == "f32" else bf, 3, 20))
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
        r = dict(name=name, B=B, hc=hc, net=net, ms=float(np.mean(t["bf16"])),
                 f32_ms=float(np.mean(t["f32"])), device_ms=device_ms(bf),
                 plain_ms=cuda_ms(plain, 1, 2), bytes=nbytes, library_ms=None,
                 bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        rows.append(r)
        print(f"  {name} {net} B {B} H·C {hc}: bf16 {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), "
              f"f32 {r['f32_ms']:.4f} ms ({r['ms'] / r['f32_ms'] - 1:+.1%}); plain bf16 "
              f"{r['plain_ms']:.4f} ms; library none; bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{nbytes / 1e6:.1f} MB; {r['bound_ms'] / r['ms']:.1%} of it reached)")

    f_ix = 4 * (n_pad + 1 + mask_ix.nnz)
    for B in (sbs, tbs):
        for H, C in ((2, 128), (1, 128)):
            a_dst, a_src, x_ext, d_out = operands(mask, B, H, C)
            xb = x_ext.to(torch.bfloat16)
            io = 4 * (B * n_pad * H + B * n_ext * H + B * n_ext * H * C + B * n_pad * H * C)
            timed("band_attention_bf16", B, H * C, "bigtown",
                  lambda: ba.band_attention_fwd(a_dst, a_src, x_ext, mask, 0.2, mask_ix),
                  lambda: ba.band_attention_fwd(a_dst, a_src, xb, mask, 0.2, mask_ix, True),
                  lambda: ba.band_attention_plain(a_dst, a_src, xb, mask, 0.2, True),
                  io - 2 * B * n_ext * H * C + f_ix + 4 * (nB + 1), B * H * mask_ix.nnz * (2 * C + 4))
            bbytes = band_bwd_bytes(B, nB, BLK, W, H, C, mask_ix.nnz, 2)
            for name, fn in (("band_attention_bwd_bf16", ba.band_attention_bwd),
                             ("band_attention_acc_bwd_bf16", ba.band_attention_acc_bwd)):
                timed(name, B, H * C, "bigtown",
                      lambda: fn(a_dst, a_src, x_ext, mask, d_out, 0.2, mask_ix),
                      lambda: fn(a_dst, a_src, xb, mask, d_out, 0.2, mask_ix, True),
                      lambda: ba.band_attention_bwd_plain(a_dst, a_src, xb, mask, d_out, 0.2, True),
                      bbytes, B * H * mask_ix.nnz * (4 * C + 12))
            del a_dst, a_src, x_ext, xb, d_out
            torch.cuda.empty_cache()
    mn_pad = mbl.n_pad
    mn_ext = mn_pad + mbl.W - mbl.BLK
    mf_ix = 4 * (mn_pad + 1 + mix.nnz)
    for B in (mbs, mtbs):
        for H, C in ((2, 128), (1, 128)):
            a_dst, a_src, x_ext, d_out = operands(mmask, B, H, C)
            xb = x_ext.to(torch.bfloat16)
            out, m, Z = ba.band_attention_flash_fwd(a_dst, a_src, xb, mmask, 0.2, mix, True)
            delta = (d_out * out).sum(dim=-1)
            small, wide_ = 4 * B * mn_pad * H, 4 * B * H * C
            timed("band_attention_flash_bf16", B, H * C, "meganet",
                  lambda: ba.band_attention_flash_fwd(a_dst, a_src, x_ext, mmask, 0.2, mix),
                  lambda: ba.band_attention_flash_fwd(a_dst, a_src, xb, mmask, 0.2, mix, True),
                  lambda: ba.band_attention_flash_plain(a_dst, a_src, xb, mmask, 0.2, True),
                  3 * small + 4 * B * mn_ext * H + wide_ // 2 * mn_ext + wide_ * mn_pad + mf_ix,
                  B * H * mix.nnz * (2 * C + 8))
            stats = (m, Z, delta, d_out, 0.2)
            timed("band_attention_flash_bwd_bf16", B, H * C, "meganet",
                  lambda: ba.band_attention_flash_bwd(a_dst, a_src, x_ext, mmask, *stats, mix),
                  lambda: ba.band_attention_flash_bwd(a_dst, a_src, xb, mmask, *stats, mix, True),
                  lambda: ba.band_attention_flash_bwd_plain(a_dst, a_src, xb, mmask, *stats, True),
                  band_bwd_bytes(B, mbl.adj_mask.shape[0], mbl.BLK, mbl.W, H, C, mix.nnz, 2, True),
                  B * H * mix.nnz * (4 * C + 12))
            del a_dst, a_src, x_ext, xb, d_out, out, m, Z, delta, stats
            torch.cuda.empty_cache()
    return rows


EVAL_EXACT = ("test_loss", "test_error", "test_0.1", "test_mae", "test_rmse", "test_mynse")


def sha(a) -> str:
    """SHA-256 of an array's bytes, dtype and shape (``tools/eval_parity_export.py``)."""
    import hashlib

    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.tobytes() + f"{a.dtype.str}{a.shape}".encode()).hexdigest()


def eval_values_within(label: str, got, ref, names) -> tuple[float, str]:
    """Per-trial rows [loss, metrics in ``names`` order] against the JAX
    fixture's: loss and five metrics within 1e-3 relative + 1e-4, corr and r2
    within 1e-3. Returns the worst share of its gate reached and where."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise SystemExit(f"FAIL {label}: {got.shape[0]} trials, the fixture has {ref.shape[0]}")
    worst = (0.0, "")
    for j, name in enumerate(["test_loss", *names]):
        corr = name.startswith(("test_corr", "test_r2"))
        gate = np.full(len(ref), 1e-3) if corr else 1e-4 + 1e-3 * np.abs(ref[:, j])
        share = float(np.max(np.abs(got[:, j] - ref[:, j]) / gate))
        if share > 1.0:
            raise SystemExit(f"FAIL {label} {name}: {got[:, j].tolist()} against the JAX "
                             f"{ref[:, j].tolist()}")
        worst = max(worst, (share, f"{label} {name}"))
    return worst


def eval_phases(dev, card, reset_launches, read_launches, counts, weights_npz):
    """Phases 30-32: the snapshot store, the hydraulic solver and the
    multi-trial evaluation of the trained GATRes-large on bigtown against
    ``artifacts/parity_eval_bigtown.npz``. Returns the times."""
    from gnn_pressure_estimation_tpu_torch.data import noisy
    from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset
    from gnn_pressure_estimation_tpu_torch.data.zarrzip import ZarrZipReader
    from gnn_pressure_estimation_tpu_torch.evaluation import harness
    from gnn_pressure_estimation_tpu_torch.evaluation.harness import (
        EvalConfig, Evaluator, make_noisy_scenes)
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model
    from gnn_pressure_estimation_tpu_torch.simgen import solver_cpp
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    fx = np.load(os.path.join(REPO, "artifacts", "parity_eval_bigtown.npz"))
    zip_path = os.path.join(REPO, "artifacts", "eval_bigtown.zip")
    inp = os.path.join(REPO, "inputs", "bigtown.inp")
    names = [str(v) for v in fx["metric_names"]]

    # ---- 30: the store and the solver -------------------------------------------
    print("[30] the zarr-zip store and the hydraulic solver")
    t0 = time.perf_counter()
    so = solver_cpp.build()
    print(f"  hydraulic solver built in {time.perf_counter() - t0:.2f} s ({so.name}, -march=native "
          f"on this host)")
    t0 = time.perf_counter()
    with ZarrZipReader(zip_path) as r:
        raw = {s: r.read_array(f"pressure/{s}") for s in ("train", "valid", "test")}
    t_read = time.perf_counter() - t0
    train = WDNDataset([zip_path], [inp], from_set="train")
    test = WDNDataset([zip_path], [inp], from_set="test", stats=train.stats)
    t_ds = time.perf_counter() - t0 - t_read
    got_sha = {**{f"sha_raw_{s}": sha(a) for s, a in raw.items()},
               "sha_train": sha(train.members[0].array), "sha_test": sha(test.members[0].array)}
    for k, v in got_sha.items():
        if v != bytes(fx[k]).decode():
            raise SystemExit(f"FAIL {k}: the port's array is not the JAX package's bit for bit")
    for k in ("mean", "std", "min", "max"):
        got, ref = getattr(train.stats, k), float(fx[f"stats_{k}"])
        if abs(got - ref) > 1e-12 * abs(ref):
            raise SystemExit(f"FAIL stats {k}: {got!r} against the JAX {ref!r}")
    stats = train.stats
    print(f"  eval_bigtown.zip (blosc-lz4): splits {', '.join(f'{s} {a.shape}' for s, a in raw.items())} "
          f"read in {t_read:.2f} s, train and test WDNDatasets in {t_ds:.2f} s; the raw splits and "
          f"the scaled arrays bit-equal to the JAX package's (SHA-256), stats within 1e-12 "
          f"(mean {stats.mean:.6f}, std {stats.std:.6f})")

    common = dict(mask_rate=float(fx["mask_rate"]), seed=int(fx["seed"]), gpu_warmup_times=10,
                  sensor_names=[str(v) for v in fx["sensor_names"]])
    n_scenes = int(fx["num_scenes"])
    ncfg = dict(num_test_trials=n_scenes, batch_size=int(fx["batch_size"]),
                mean_dmd=float(fx["mean_dmd"]), std_dmd=float(fx["std_dmd"]), **common)
    solves, solve = [], noisy.solve

    def timed_solve(ns, backend=None):
        t = time.perf_counter()
        res = solve(ns, backend=backend)
        solves.append((ns.demand.copy(), res.pressure.copy(), time.perf_counter() - t))
        return res

    noisy.solve = timed_solve
    try:
        t0 = time.perf_counter()
        scenes = make_noisy_scenes([inp], EvalConfig(test_type="noisy11", **ncfg), stats,
                                   backend="cpp")
        t_scenes = time.perf_counter() - t0
    finally:
        noisy.solve = solve
    if len(solves) != n_scenes or len({id(s.members[0].template) for s in scenes}) != 1:
        raise SystemExit("FAIL the noise scenes are not one solve each on one shared template")
    gap = 0.0
    for i, (demand, pressure, _) in enumerate(solves):
        if not np.array_equal(demand, fx["scene_demand"][i]):
            raise SystemExit(f"FAIL scene {i}: the perturbed demands differ from the JAX package's")
        gap = max(gap, float(np.max(np.abs(pressure - fx["scene_pressure"][i]))))
    if gap > 1e-4:
        raise SystemExit(f"FAIL scene pressures {gap:.3e} m from the JAX package's (bound 1e-4)")
    solve_s = [t for _, _, t in solves]
    print(f"  {n_scenes} noise scenes of bigtown (seed {common['seed']}, backend cpp): perturbed "
          f"demands bit-equal to the JAX package's, pressures within {gap:.3e} m of them; solver "
          f"{np.mean(solve_s) * 1e3:.1f} ms a scene ({', '.join(f'{t * 1e3:.1f}' for t in solve_s)}), "
          f"{t_scenes:.2f} s with parsing and the template")

    model, _ = select_model("gatres_large", device=dev)
    model.load_state_dict(params_from_parity_npz(weights_npz))

    def evaluate(kind, cfg, datasets, replay=True):
        """One ``Evaluator.evaluate`` with the fixture's masks replayed (or the
        port's own draws); returns the results, the per-call rows, the
        forwards, the launches and the wall time."""
        rows, forwards = [], [0]
        queue = [np.unpackbits(r)[:int(fx[f"{kind}_mask_width"])].astype(bool)
                 for r in fx[f"{kind}_masks"]]

        def replayed(generator, n_graph, n, mask_rate, required_idx=None, shared=False,
                     device="cpu"):
            if not queue:
                raise SystemExit(f"FAIL {kind}: the port draws more masks than the JAX package")
            m = queue.pop(0)
            if m.size != n_graph * n:
                raise SystemExit(f"FAIL {kind}: a mask of {n_graph} x {n} where JAX drew {m.size}")
            return torch.as_tensor(m, device=device)

        run_trial, run_scenes, draw = Evaluator.run_trial, Evaluator.run_scene_trials, \
            harness.batch_node_mask

        def trial(self, *a, **kw):
            loss, mets = run_trial(self, *a, **kw)
            rows.append([loss, *(mets[k] for k in names)])
            return loss, mets

        def scene_rows(self, *a, **kw):
            out = run_scenes(self, *a, **kw)
            rows.extend([[r["loss"], *(r["mets"][k] for k in names)] for r in out]
                        + [[r["s_loss"], *(r["s_mets"][k] for k in names)] for r in out])
            return out

        Evaluator.run_trial, Evaluator.run_scene_trials = trial, scene_rows
        if replay:
            harness.batch_node_mask = replayed
        hook = model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        ev = Evaluator(model, cfg, stats, device=dev)
        try:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            res = ev.evaluate(datasets, log_fn=lambda m: print("    " + m.strip()) if m.strip() else None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        finally:
            Evaluator.run_trial, Evaluator.run_scene_trials = run_trial, run_scenes
            harness.batch_node_mask = draw
            hook.remove()
        if replay and queue:
            raise SystemExit(f"FAIL {kind}: {len(queue)} of the fixture's masks were not drawn")
        routes = {(g.band_attn, g.banded) for g in ev._graphs.values()}
        if routes != {("dma", True)}:
            raise SystemExit(f"FAIL {kind}: graphs {routes}, expected banded through 'dma'")
        return res, rows, forwards[0], launches, wall, ev

    def held(kind, res, rows, fwd, launches, wall, expect_fwd):
        if fwd != expect_fwd:
            raise SystemExit(f"FAIL {kind}: {fwd} forwards, expected {expect_fwd}")
        expect = counts(band_attention=50 * fwd, band_spmm=25 * fwd)
        if launches != expect:
            raise SystemExit(f"FAIL {kind} launches {launches}, expected {expect}")
        if kind == "clean":          # run_trial calls: all-nodes, then sensors, per trial
            got_a, got_s = rows[0::2], rows[1::2]
        else:                        # scene rows: all-nodes rows, then sensor rows
            got_a, got_s = rows[:len(rows) // 2], rows[len(rows) // 2:]
        worst, where = max(
            eval_values_within(f"{kind} all nodes", got_a, fx[f"{kind}_values"], names),
            eval_values_within(f"{kind} sensors", got_s, fx[f"{kind}_sensor_values"], names))
        loss_d, met_d, sen_d = res
        for key, v in {**loss_d, **met_d, **sen_d}.items():
            if not np.isfinite(v):
                raise SystemExit(f"FAIL {kind} {key} is not finite")
        t_ms, thr = met_d["test_time_mean"], met_d["test_throughput_mean"]
        print(f"  {kind}: {len(got_a)} trials, MAE {met_d['test_mae_mean']:.4f} m (sensors "
              f"{sen_d['test_mae_sensor_mean']:.4f}), corr {met_d['test_corr_mean']:.4f}; every "
              f"trial's loss and metrics within their gates of the JAX values (worst {worst:.1%} "
              f"of a gate, {where}); {fwd} forwards, launches {launches['band_attention']} band_attention + "
              f"{launches['band_spmm']} band_spmm (50 + 25 a forward), no other kernel; Timer "
              f"(CUDA events, 10 warm-ups): test_time {t_ms:.4f} ms (the reference's formula: "
              f"batch times weighted by their snapshots over the dataset), test_throughput "
              f"{thr:.2f} snapshots/s, on {card}; {wall:.2f} s for the {2 * len(got_a)} passes")
        return dict(trials=len(got_a), forwards=fwd, ms_per_snapshot=t_ms, snapshots_per_s=thr,
                    mae=met_d["test_mae_mean"], worst_gate_share=worst, worst_at=where, wall_s=wall)

    # ---- 31: clean evaluation on the card ----------------------------------------
    print("[31] clean evaluation: GATRes-large (trained) on the bigtown test split")
    trials, bs = int(fx["num_trials"]), int(fx["batch_size"])
    ccfg = EvalConfig(test_type="clean", num_test_trials=trials, batch_size=bs, **common)
    n_batches = -(-len(test) // bs)
    out = {"clean": held("clean", *evaluate("clean", ccfg, test)[:5], 10 + trials * 2 * n_batches)}
    own = []
    for _ in range(2):
        res = evaluate("clean", ccfg, test, replay=False)[0]
        own.append([{k: v for k, v in d.items() if not k.startswith(("test_time", "test_throughput"))}
                    for d in res])
    if own[0] != own[1]:
        raise SystemExit("FAIL two clean evaluations from one seed differ")
    print(f"  the port's own mask draws, twice from seed {common['seed']}: bit-identical results "
          f"(MAE {own[0][1]['test_mae_mean']:.4f} m)")

    # ---- 32: noisy evaluation on the card ----------------------------------------
    print("[32] noisy11 and noisyNN on the scenes of phase 30, the scene-batched path")
    for kind, draws in (("noisy11", 1), ("noisyNN", n_scenes)):
        cfg = EvalConfig(test_type=kind, **ncfg)
        res, rows, fwd, launches, wall, ev = evaluate(kind, cfg, scenes)
        if [bs_ for _, bs_ in ev._graphs] != [n_scenes]:
            raise SystemExit(f"FAIL {kind} did not batch the {n_scenes} scenes into one graph")
        out[kind] = held(kind, res, rows, fwd, launches, wall, 10 + 2 * draws)
    out["solver_ms_per_scene"] = float(np.mean(solve_s) * 1e3)
    print(f"  evaluation summary on {card}: " + json.dumps(out))
    return out


BAND_KERNELS = ("band_rowwalk_kernel", "columns_kernel", "band_spmm_fwd_kernel",
                "band_spmm_bwd_kernel")


def cli_phases(dev, card, reset_launches, read_launches, counts, weights_npz, device_flags=()):
    """Phases 33-36: the port's command line through ``cli.main``, on the card
    (``device_flags`` stays empty there; a CPU rehearsal passes ``--device
    cpu``). Returns the times."""
    import configparser
    import contextlib
    import importlib.util
    import io
    import shutil
    import tempfile

    from gnn_pressure_estimation_tpu_torch import cli
    from gnn_pressure_estimation_tpu_torch.data import WDNDataset
    from gnn_pressure_estimation_tpu_torch.data.zarrzip import ZarrZipReader
    from gnn_pressure_estimation_tpu_torch.evaluation import Evaluator
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model
    from gnn_pressure_estimation_tpu_torch.train import Trainer, load_checkpoint, save_checkpoint
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    inp = os.path.join(REPO, "inputs", "bigtown.inp")
    ref_zip = os.path.join(REPO, "artifacts", "eval_bigtown.zip")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    forwards, steps, epoch_ms, evals = [0], [], [], []

    def count_forward(module, args, out):
        if isinstance(module, GATRes):
            forwards[0] += 1

    def counted_step(self, *a, **kw):
        before = read_launches()
        out = train_step(self, *a, **kw)
        after = read_launches()
        steps.append({k: after[k] - before[k] for k in after})
        return out

    def timed(fn, kind):
        def run(self, *a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            sync()
            epoch_ms.append((kind, (time.perf_counter() - t0) * 1e3))
            return out
        return run

    def captured_evaluate(self, *a, **kw):
        res = evaluate(self, *a, **kw)
        evals.append(res)
        return res

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run(label, argv):
        """``cli.main(argv)``; its output shown (indented, the temporary
        directory as <tmp>) and returned with the seconds taken."""
        buf = io.StringIO()
        sync()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            sync()
        finally:
            for ln in buf.getvalue().strip().splitlines():
                print("    " + ln.replace(tmp, "<tmp>"))
        if rc != 0:
            raise SystemExit(f"FAIL cli {label} exited {rc}")
        return buf.getvalue(), time.perf_counter() - t0

    def held_launches(label, n_steps=0):
        launches, fwd = read_launches(), forwards[0]
        expect = counts(band_attention=50 * fwd, band_spmm=25 * fwd,
                        band_attention_bwd=50 * n_steps, band_spmm_bwd=25 * n_steps)
        if not fwd or launches != expect:
            raise SystemExit(f"FAIL {label}: {fwd} forwards, {n_steps} steps, launches {launches}, "
                             f"expected {expect}")
        return fwd

    def start():
        reset_launches()
        forwards[0] = 0
        steps.clear()
        epoch_ms.clear()
        evals.clear()

    train_step, evaluate = Trainer.train_step, Evaluator.evaluate
    one_epoch = (Trainer.train_one_epoch, Trainer.eval_one_epoch)
    hook = torch.nn.modules.module.register_module_forward_hook(count_forward)
    Trainer.train_step, Evaluator.evaluate = counted_step, captured_evaluate
    Trainer.train_one_epoch = timed(one_epoch[0], "train")
    Trainer.eval_one_epoch = timed(one_epoch[1], "val")
    out = {}
    try:
        # ---- 33: generate ----------------------------------------------------------
        print("[33] cli generate: bigtown, 80 scenarios, the options of artifacts/eval_bigtown.zip")
        cp = configparser.ConfigParser()
        cp.read(os.path.join(REPO, "configs", "bigtown.ini"))
        cp.set("general", "wn_inp_path", inp)
        cp.set("general", "storage_dir", os.path.join(tmp, "bigtown"))
        cp.set("general", "num_scenarios", "80")
        ini = os.path.join(tmp, "bigtown.ini")
        with open(ini, "w") as f:
            cp.write(f)
        text, gen_s = run("generate", [
            "generate", "--config", ini, "--gen_demand", "--gen_res_total_head",
            "--update_totalhead_method", "add_max_elevation", "--accept_warning_code",
            "--pressure_lowerbound", "-5", "--pressure_upperbound", "500", "--att", "pressure",
            "--batch_size", "10", "--executors", "1", "--train_ratio", "0.5", "--valid_ratio",
            "0.1", "--seed", "1234", "--no-save_params", "--backend", "cpp"])
        backend = next(ln.split(":", 1)[1].strip() for ln in text.splitlines()
                       if ln.startswith("solver backend:"))
        gen_zip = os.path.join(tmp, "bigtown.zip")
        splits = ("train", "valid", "test")
        with ZarrZipReader(gen_zip) as r:
            got = {s: r.read_array(f"pressure/{s}") for s in splits}
        with ZarrZipReader(ref_zip) as r:
            ref = {s: r.read_array(f"pressure/{s}") for s in splits}
        shapes = {s: got[s].shape for s in splits}
        if shapes != {s: ref[s].shape for s in splits} or \
                shapes != {"train": (40, 5821), "valid": (8, 5821), "test": (32, 5821)}:
            raise SystemExit(f"FAIL generate: splits {shapes}, the JAX store's "
                             f"{ {s: ref[s].shape for s in splits} }")
        gap = max(float(np.max(np.abs(got[s] - ref[s]))) for s in splits)
        if gap > 1e-6:
            raise SystemExit(f"FAIL generate: pressures {gap:.3e} m from the JAX store's (bound 1e-6)")
        print(f"  generated in {gen_s:.2f} s, solver backend {backend}: splits "
              f"{', '.join(f'{s} {shapes[s]}' for s in splits)}, pressures within {gap:.3e} m of "
              f"eval_bigtown.zip (the JAX generator's)")
        out["generate"] = dict(seconds=gen_s, backend=backend, max_abs_gap_m=gap)

        # ---- 34: train ---------------------------------------------------------------
        print("[34] cli train --model gatres_large on phase 33's zip: 2 epochs at batch 8, "
              "--do_test, JSONL log, profiler trace; then a resume")
        if importlib.util.find_spec("wandb") is not None:
            sys.modules["wandb"] = None   # a wandb run would reach for the network
            print("  wandb is installed here: blocked, so the run takes the JSONL fallback")
        save, prof_dir = os.path.join(tmp, "run"), os.path.join(tmp, "prof")
        train = ["train", "--model", "gatres_large", "--dataset_paths", gen_zip,
                 "--input_paths", inp, "--batch_size", "8", "--mask_rate", "0.95",
                 "--agg_mode", "banded", "--band_block", "256", "--save_path", save,
                 "--variant", "smoke", *device_flags]
        start()
        text, train_s = run("train", train + [
            "--epochs", "2", "--do_test", "--log_method", "wandb", "--profile_dir", prof_dir,
            "--profile_epochs", "1"])
        per_step = counts(band_attention=50, band_spmm=25, band_attention_bwd=50, band_spmm_bwd=25)
        if len(steps) != 10 or any(s != per_step for s in steps):
            raise SystemExit(f"FAIL train: {len(steps)} steps (expected 10), launches a step "
                             f"{[s for s in steps if s != per_step][:1]} where {per_step}")
        fwd = held_launches("train", len(steps))
        if "falling back to JSONL logging" not in text:
            raise SystemExit("FAIL train: --log_method wandb did not fall back to JSONL")
        log = os.path.join(save, "gatres_large_smoke.jsonl")
        with open(log) as f:
            events = [json.loads(ln)["event"] for ln in f]
        if events != ["start", "epoch", "epoch", "finish"]:
            raise SystemExit(f"FAIL train: the JSONL log holds {events}")
        trace = os.path.join(prof_dir, "gatres_large_smoke.trace.json")
        with open(trace) as f:
            trace_text = f.read()
        missing = [k for k in BAND_KERNELS if k not in trace_text]
        if missing and dev.type == "cuda":
            raise SystemExit(f"FAIL train: the profiler trace names no {missing}")
        for which in ("best", "last"):
            _, opt, meta = load_checkpoint(os.path.join(save, f"{which}_gatres_large_smoke.ckpt"))
            lay = meta["extra"]["layout"]
            if (lay["agg_mode"], lay["band_block"]) != ("banded", 256) or not opt:
                raise SystemExit(f"FAIL train: the {which} checkpoint's layout {lay}")
        if meta["epoch"] != 2:
            raise SystemExit(f"FAIL train: the last checkpoint is of epoch {meta['epoch']}")
        ep = [round(ms, 3) for _, ms in epoch_ms]
        do_test = evals[0][1]
        print(f"  {train_s:.2f} s: {len(steps)} train steps of 50 + 50 band attention and 25 + 25 "
              f"band SpMM launches (dma, no other kernel), {fwd} forwards of 50 + 25 (steps, "
              f"validation, the --do_test evaluation); epochs (train, val) ms {ep}; --do_test "
              f"MAE {do_test['test_mae_mean']:.4f} m, test_time {do_test['test_time_mean']:.4f} ms; "
              f"checkpoints banded / 256, log {events}, trace "
              f"{os.path.getsize(trace) / 1e6:.1f} MB naming "
              f"{[k for k in BAND_KERNELS if k in trace_text]}")
        out["train"] = dict(seconds=train_s, epoch_ms=ep, steps=len(steps), forwards=fwd,
                            do_test_ms=do_test["test_time_mean"])
        start()
        text, resume_s = run("resume", train + [
            "--epochs", "3", "--model_path", os.path.join(save, "last_gatres_large_smoke.ckpt")])
        if "continuing at 3" not in text or len(steps) != 5 or any(s != per_step for s in steps):
            raise SystemExit(f"FAIL resume: {len(steps)} steps, 'continuing at 3' "
                             f"{'continuing at 3' in text}")
        held_launches("resume", len(steps))
        ep3 = [round(ms, 3) for _, ms in epoch_ms]
        print(f"  resumed at epoch 3 in {resume_s:.2f} s: 5 steps at the same launches; epoch 3 "
              f"(train, val) ms {ep3}")
        out["resume"] = dict(seconds=resume_s, epoch_ms=ep3)

        # ---- 35: eval ---------------------------------------------------------------------
        print("[35] cli eval of phase 34's best checkpoint: clean (2 trials, batch 16), noisyNN "
              "(1 scene, batch 4)")
        best = os.path.join(save, "best_gatres_large_smoke.ckpt")
        for kind, flags in (("clean", ["--num_test_trials", "2", "--batch_size", "16"]),
                            ("noisyNN", ["--num_test_trials", "1", "--batch_size", "4"])):
            start()
            _, eval_s = run(kind, ["eval", "--model", "gatres_large", "--model_path", best,
                                   "--test_data_path", gen_zip, "--test_input_path", inp,
                                   "--test_type", kind, *flags, *device_flags])
            fwd = held_launches(kind)
            met = evals[0][1]
            if not all(np.isfinite(v) for d in evals[0] for v in d.values()):
                raise SystemExit(f"FAIL eval {kind}: a non-finite value")
            print(f"  {kind}: {eval_s:.2f} s, {fwd} forwards of 50 + 25 launches; MAE "
                  f"{met['test_mae_mean']:.4f} m, test_time {met['test_time_mean']:.4f} ms, "
                  f"test_throughput {met['test_throughput_mean']:.2f} snapshots/s on {card}")
            out[kind] = dict(seconds=eval_s, forwards=fwd, test_time_ms=met["test_time_mean"],
                             test_throughput=met["test_throughput_mean"],
                             mae=met["test_mae_mean"])

        # ---- 36: infer against the JAX cli infer ------------------------------------------
        print("[36] cli infer on the trained weights against the JAX cli infer "
              "(artifacts/parity_infer_bigtown.npz)")
        fx = np.load(os.path.join(REPO, "artifacts", "parity_infer_bigtown.npz"))
        model, _ = select_model("gatres_large", device=dev)
        model.load_state_dict(params_from_parity_npz(weights_npz))
        stats = WDNDataset([ref_zip], [inp], from_set="train").stats
        ckpt = os.path.join(tmp, "trained.ckpt")
        save_checkpoint(ckpt, model.state_dict(), stats=stats,
                        extra={"layout": {"agg_mode": None, "band_block": None}})
        del model
        flags = [os.path.join(REPO, a) if os.path.exists(os.path.join(REPO, a)) else str(a)
                 for a in fx["argv"]]
        npz, csv = os.path.join(tmp, "pred.npz"), os.path.join(tmp, "pred.csv")
        start()
        _, infer_s = run("infer", ["infer", "--model", "gatres_large", "--model_path", ckpt, *flags,
                                   "--out_npz", npz, "--out_csv", csv, *device_flags])
        fwd = held_launches("infer")
        res = np.load(npz)
        obs = res["observed"].astype(bool)
        if fwd != 1 or not np.array_equal(obs, fx["observed"]) or \
                not np.array_equal(res["node_names"], fx["node_names"]):
            raise SystemExit(f"FAIL infer: {fwd} forwards, or another observed set or node order")
        if not np.array_equal(res["pred"][:, obs], res["true"][:, obs]) or \
                np.abs(res["true"] - fx["true"]).max() > 1e-5:
            raise SystemExit("FAIL infer: observed nodes not served at their true values")
        with open(csv) as f:
            n_rows = sum(1 for _ in f)
        gap = float(np.abs(res["pred"] - fx["pred"]).max())
        print(f"  {infer_s:.2f} s: {res['pred'].shape[0]} snapshots x {res['pred'].shape[1]} nodes, "
              f"{int(obs.sum())} observed (served at their values), one forward of 50 + 25 "
              f"launches; pred within {gap:.3e} of the JAX cli infer's (bound 1e-3); csv "
              f"{n_rows} lines")
        if gap > 1e-3 or not np.isfinite(res["pred"]).all():
            raise SystemExit(f"FAIL infer: pred {gap:.3e} from the JAX cli infer's (bound 1e-3)")
        out["infer"] = dict(seconds=infer_s, max_abs_gap=gap)
    finally:
        hook.remove()
        Trainer.train_step, Evaluator.evaluate = train_step, evaluate
        Trainer.train_one_epoch, Trainer.eval_one_epoch = one_epoch
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  command-line summary on {card}: " + json.dumps(out))
    return out


# the model zoo's kernel launches on bigtown (banded, "dma") at the presets' size: one
# forward, and the backward of one train step (zoo_launches_of derives them from a
# model; phase 38 holds the presets to this table). A layer whose input needs no
# gradient launches no backward: GIN's first sum reads the input, and the Chebyshev
# terms of the input (a first ChebConv's, which no parameter enters) need none
ZOO = ("gin", "gat", "gcn2", "chebnet", "graphconvwat", "mgcn")
ZOO_BATCHES = (1, 8, 32)    # phase 37's batches: the fixtures', training's and serving's
ZOO_FWD = {"gin": {"band_spmm": 15}, "gat": {"band_attention": 10}, "gcn2": {"band_spmm": 64},
           "chebnet": {"band_spmm": 43}, "graphconvwat": {"band_spmm": 377}, "mgcn": {}}
ZOO_BWD = {"gin": {"band_spmm_bwd": 14}, "gat": {"band_attention_bwd": 10},
           "gcn2": {"band_spmm_bwd": 64}, "chebnet": {"band_spmm_bwd": 20},
           "graphconvwat": {"band_spmm_bwd": 138}, "mgcn": {}}


def zoo_launches_of(model) -> tuple[dict, dict]:
    """(launches of one banded forward, of its backward in a train step) of a
    zoo model, from its layers."""
    from gnn_pressure_estimation_tpu_torch.models import zoo

    n = len(getattr(model, "convs", ()))
    if isinstance(model, zoo.GIN):
        return {"band_spmm": n}, {"band_spmm_bwd": n - 1}
    if isinstance(model, zoo.GAT):
        return {"band_attention": n}, {"band_attention_bwd": n}
    if isinstance(model, zoo.GCN2):
        return {"band_spmm": n}, {"band_spmm_bwd": n}
    if isinstance(model, (zoo.ChebNet, zoo.GraphConvWat)):
        ks = [c.K - 1 for c in model.convs]
        return {"band_spmm": sum(ks)}, {"band_spmm_bwd": sum(ks[1:])}
    if isinstance(model, zoo.MGCN):
        return {}, {}
    raise TypeError(f"not a zoo model: {type(model).__name__}")


ZOO_WIDTHS = (1, 30, 32, 60, 120)


def fixture_gap(label: str, got, ref) -> float:
    """max|got − ref| against the fixture's gate, 1e-3 relative to max|ref|
    where its values exceed 1 (1e-3 absolute below); fails past it. Returns
    the deviation relative to max|ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise SystemExit(f"FAIL {label}: shape {got.shape} against {ref.shape}, or not finite")
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    if err > 1e-3 * max(1.0, top):
        raise SystemExit(f"FAIL {label}: off by {err:.3e} (max |ref| {top:.3e})")
    return err / max(top, 1e-30)


def relative_gap(label: str, got: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """max|got − ref| ≤ tol·max(1, max|ref|); fails past it. Returns the
    deviation relative to max|ref|."""
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {label}: shape {tuple(got.shape)} against {tuple(ref.shape)}, "
                         "or not finite")
    err, top = float((got - ref).abs().max()), float(ref.abs().max())
    if err > tol * max(1.0, top):
        raise SystemExit(f"FAIL {label}: off by {err:.3e} (max |ref| {top:.3e}, gate "
                         f"{tol} x max(1, max|ref|))")
    return err / max(top, 1e-30)


def zoo_phases(dev, card, held, reset_launches, read_launches, counts, device_flags=()) -> dict:
    """Phases 37-42: the model zoo and the remask variants on the card
    (``device_flags`` stays empty there; a CPU rehearsal passes ``--device
    cpu`` to the command line). Returns what the ``kernels`` line reports of
    them."""
    import contextlib
    import io
    import json as js
    import shutil
    import tempfile

    from gnn_pressure_estimation_tpu_torch import cli
    from gnn_pressure_estimation_tpu_torch.data import WDNDataset
    from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.models import presets
    from gnn_pressure_estimation_tpu_torch.models.remask import GATResRemask, GATResRemaskStack
    from gnn_pressure_estimation_tpu_torch.models.zoo import GIN, MGCN
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
        band_attention_bwd, band_attention_bwd_plain, band_attention_fwd, band_attention_plain,
    )
    from gnn_pressure_estimation_tpu_torch.ops.band_spmm import (
        band_spmm_bwd, band_spmm_bwd_plain, band_spmm_fwd, band_spmm_plain,
    )
    from gnn_pressure_estimation_tpu_torch.ops.graph_attention import (
        fused_attention_bwd, fused_attention_bwd_plain, fused_attention_fwd, fused_attention_plain,
    )
    from gnn_pressure_estimation_tpu_torch.train import Trainer, load_checkpoint
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_fixture

    out, phase_s = {}, {}
    zip_path = os.path.join(REPO, "artifacts", "eval_bigtown.zip")
    inp = os.path.join(REPO, "inputs", "bigtown.inp")
    gen = torch.Generator(device=dev).manual_seed(37)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    splits = {}

    def bigtown(preset):
        """The train and test splits of ``eval_bigtown.zip`` read by the port,
        scaled by the preset's normalisation, with its edge attributes."""
        key = (preset.norm_type, preset.edge_attrs)
        if key not in splits:
            kw = dict(norm_type=preset.norm_type, edge_attrs=preset.edge_attrs)
            tr = WDNDataset([zip_path], [inp], from_set="train", **kw)
            va = WDNDataset([zip_path], [inp], from_set="valid", stats=tr.stats, **kw)
            te = WDNDataset([zip_path], [inp], from_set="test", stats=tr.stats, **kw)
            splits[key] = (tr, va, te)
        return splits[key]

    tpl0 = bigtown(presets.MODEL_REGISTRY["gin"])[2].members[0].template
    bl = tpl0.band_layout()
    nB, BLK, W = bl.adj_mask.shape
    n_pad, n_ext = bl.n_pad, bl.n_pad + W - BLK

    # ---- 37: the kernels against their plain versions at the zoo's shapes ----------
    t_phase = time.perf_counter()
    print("[37] kernels vs plain versions at the zoo's shapes: the band SpMM over the two count "
          "bands it is given (cnt: adj, mean, cheb; cnt_sl: gcn) on bigtown at C 1, 30, 32, 60, "
          "120; v2 and fused_attention at H 2 C 32 and H 1 C 1; B 1, 8 and 32 (serving)")
    bands = {"cnt": (torch.as_tensor(bl.adj_cnt, device=dev), tpl0.band_index("adj_cnt").to(dev)),
             "cnt_sl": (torch.as_tensor(bl.adj_cnt_sl, device=dev),
                        tpl0.band_index("adj_cnt_sl").to(dev))}
    for B in ZOO_BATCHES:
        for C in ZOO_WIDTHS:
            for tag, (band, ix) in bands.items():
                x_ext, d_out = randn(B, n_ext, C), randn(B, n_pad, C)
                label = f"{tag} B{B} C{C}"
                held("band_spmm", f"band_spmm {label}", band_spmm_fwd(band, x_ext, ix),
                     band_spmm_plain(band, x_ext), verbose=False)
                held("band_spmm_bwd", f"band_spmm_bwd {label}", band_spmm_bwd(band, d_out, ix),
                     band_spmm_bwd_plain(band, d_out), verbose=False)
    mask = torch.as_tensor(bl.adj_mask.view(np.int8), device=dev)
    mask_ix = tpl0.band_index("adj_mask").to(dev)
    for B in ZOO_BATCHES:
        for H, C in ((2, 32), (1, 1)):
            args = (randn(B, n_pad, H), randn(nB, B, W, H), randn(B, n_ext, H, C), mask)
            d_out = randn(B, n_pad, H, C)
            label = f"bigtown B{B} H{H} C{C}"
            held("band_attention", f"band_attention {label}", band_attention_fwd(*args, 0.2, mask_ix),
                 band_attention_plain(*args, 0.2), verbose=False)
            for part, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"),
                                  band_attention_bwd(*args, d_out, 0.2, mask_ix),
                                  band_attention_bwd_plain(*args, d_out, 0.2)):
                held("band_attention_bwd", f"band_attention_bwd {label} {part}", g, r, verbose=False)
    swn = parse_inp(os.path.join(REPO, "inputs", "synthctown.inp"))
    stpl, _ = build_template(swn, get_keep_list(swn, "keep_junction", None, "pressure"), None,
                             name="synthctown")
    sn = stpl.n_node
    smask = torch.as_tensor(stpl.dense_operators()["adj_sl_mask"], device=dev)
    sidx = stpl.dense_index().to(dev)
    for B in ZOO_BATCHES:
        for H, C in ((2, 32), (1, 1)):
            a_d, a_s, v = randn(B, sn, H), randn(B, sn, H), randn(B, sn, H, C)
            d_o = randn(B, sn, H, C)
            label = f"synthctown B{B} H{H} C{C}"
            o = fused_attention_fwd(a_d, a_s, v, smask, 0.2, sidx)
            held("fused_attention", f"fused_attention {label}", o,
                 fused_attention_plain(a_d, a_s, v, smask, 0.2), verbose=False)
            for part, g, r in zip(("d a_d", "d a_s", "d v"),
                                  fused_attention_bwd(a_d, a_s, v, smask, d_o, 0.2, sidx),
                                  fused_attention_bwd_plain(a_d, a_s, v, smask, d_o, 0.2)):
                held("fused_attention_bwd", f"fused_attention_bwd {label} {part}", g, r,
                     verbose=False)
    print("  every shape within atol and rtol 1e-4: band_spmm at 2 bands x 5 widths x 3 batches, "
          "forward and backward; v2 and fused_attention at 2 shapes x 3 batches, forward and "
          "backward")
    # the band SpMM at the zoo's widths, serving batch: kernel, plain, torch.sparse.mm
    # (CSR over the same band, extended rows as columns; its transpose for the
    # backward), byte bound over the nonzeros
    cnt, cnt_ix = bands["cnt"]
    blk_i, r_i, j_i = np.nonzero(bl.adj_cnt)
    vals = torch.as_tensor(bl.adj_cnt[blk_i, r_i, j_i].astype(np.float32), device=dev)
    rows_g, cols_e = blk_i * BLK + r_i, blk_i * BLK + j_i
    csr = torch.sparse_coo_tensor(torch.as_tensor(np.stack([rows_g, cols_e]), device=dev), vals,
                                  (n_pad, n_ext)).to_sparse_csr()
    csr_t = torch.sparse_coo_tensor(torch.as_tensor(np.stack([cols_e, rows_g]), device=dev), vals,
                                    (n_ext, n_pad)).to_sparse_csr()
    nnz = cnt_ix.nnz
    widths = {}
    bs = 32
    for C in ZOO_WIDTHS + (128,):
        x_ext, d_out = randn(bs, n_ext, C), randn(bs, n_pad, C)
        x2d = x_ext.permute(1, 0, 2).reshape(n_ext, bs * C).contiguous()
        d2d = d_out.permute(1, 0, 2).reshape(n_pad, bs * C).contiguous()
        check_close(f"band_spmm B{bs} C{C} vs torch.sparse.mm", band_spmm_fwd(cnt, x_ext, cnt_ix),
                    torch.sparse.mm(csr, x2d).reshape(n_pad, bs, C).permute(1, 0, 2), TOL, TOL,
                    verbose=False)
        io_bytes = 4 * (bs * n_ext * C + bs * n_pad * C)
        fwd_b = (io_bytes + 4 * (n_pad + 1 + 2 * nnz)) / PEAK_BYTES_S * 1e3
        bwd_b = (io_bytes + 4 * (n_ext + 1 + 2 * nnz)) / PEAK_BYTES_S * 1e3
        ops = 2 * bs * C * nnz / PEAK_F32_S * 1e3
        r = widths[C] = dict(
            ms=cuda_ms(lambda: band_spmm_fwd(cnt, x_ext, cnt_ix), 3, 20),
            device_ms=device_ms(lambda: band_spmm_fwd(cnt, x_ext, cnt_ix)),
            plain_ms=cuda_ms(lambda: band_spmm_plain(cnt, x_ext), 1, 3),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr, x2d), 3, 20),
            bound_ms=max(fwd_b, ops), bound_by="bytes" if fwd_b >= ops else "operations",
            bwd_ms=cuda_ms(lambda: band_spmm_bwd(cnt, d_out, cnt_ix), 3, 20),
            bwd_device_ms=device_ms(lambda: band_spmm_bwd(cnt, d_out, cnt_ix)),
            bwd_plain_ms=cuda_ms(lambda: band_spmm_bwd_plain(cnt, d_out), 1, 3),
            bwd_library_ms=cuda_ms(lambda: torch.sparse.mm(csr_t, d2d), 3, 20),
            bwd_bound_ms=max(bwd_b, ops), vector_loads=bool(bops.vector_loads(x_ext, C)))
        print(f"  band_spmm bigtown B {bs} C {C} ({'packed' if r['vector_loads'] else 'scalar'} "
              f"loads): kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), plain "
              f"{r['plain_ms']:.4f}, torch.sparse.mm {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} reached); "
              f"backward {r['bwd_ms']:.4f} (device {fmt_ms(r['bwd_device_ms'])}), plain "
              f"{r['bwd_plain_ms']:.4f}, transposed CSR {r['bwd_library_ms']:.4f}, bound "
              f"{r['bwd_bound_ms']:.5f}")
        del x_ext, d_out, x2d, d2d
    out["widths"] = widths
    torch.cuda.empty_cache()
    phase_s[37] = time.perf_counter() - t_phase

    # ---- 38: fixture parity on bigtown, banded, B 1 ----------------------------------
    t_phase = time.perf_counter()
    print("[38] fixture parity: the six presets on bigtown (banded, BLK 256, dma, B 1) against "
          "artifacts/parity_zoo_<model>.npz")
    zoo_launches = dict.fromkeys(("band_spmm", "band_spmm_bwd", "band_attention",
                                  "band_attention_bwd", "fused_attention"), 0)

    def tally(launched):
        for k in zoo_launches:
            zoo_launches[k] += launched.get(k, 0)

    def fixture_model(fx):
        name = fx["model"].item().decode()
        preset = presets.MODEL_REGISTRY[name]
        # the preset's model class and widths with the fixture's cut (m_GCN's n_aggr)
        model = preset.build(**js.loads(fx["hparams"].item())).to(dev)
        model.load_state_dict(params_from_fixture(fx, model, "param"))
        return model, preset

    def one_step(tr, tpl, fx):
        g1, x1, m1, k1 = tr._prepare(tpl, fx["x"][None], fx["mask"], None, None)
        tr.model.train()
        loss, _, _ = tr._masked_loss_and_metrics(g1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return float(loss.detach()), grads

    fixture_report = {}
    for name in ZOO:
        fx = np.load(os.path.join(REPO, "artifacts", f"parity_zoo_{name}.npz"))
        model, preset = fixture_model(fx)
        if zoo_launches_of(model) != (ZOO_FWD[name], ZOO_BWD[name]):
            raise SystemExit(f"FAIL {name}: its layers launch {zoo_launches_of(model)}, the "
                             f"table says {(ZOO_FWD[name], ZOO_BWD[name])}")
        _, _, te = bigtown(preset)
        tpl = te.members[0].template
        if not np.array_equal(te.members[0].array[0], fx["x"]):
            raise SystemExit(f"FAIL {name}: the port's scaled snapshot differs from the fixture's")
        if preset.edge_attrs and np.abs(tpl.edge_attr - fx["edge_attr"]).max() > \
                1e-6 * np.abs(fx["edge_attr"]).max():
            raise SystemExit(f"FAIL {name}: the port's scaled edge attributes differ")
        n = tpl.n_node
        graph = tpl.batch(1, device=dev)
        if not graph.banded or graph.band_attn != "dma":
            raise SystemExit(f"FAIL {name}: bigtown did not take the banded dma layout")
        x = torch.as_tensor(fx["x"][:, None], device=dev)
        m = torch.as_tensor(fx["mask"], device=dev)
        xp = graph.pack_nodes(torch.where(m[:, None], 0.0, x), n)
        acts = {}
        hooks = [model.get_submodule(str(k)).register_forward_hook(
            lambda mod, a, o, k=str(k): acts.__setitem__(k, o)) for k in fx["act_layers"]]
        model.eval()
        reset_launches()
        with torch.no_grad():
            y = graph.unpack_nodes(model(xp, graph), n)
        torch.cuda.synchronize()
        fwd = read_launches()
        for h in hooks:
            h.remove()
        if fwd != counts(**ZOO_FWD[name]):
            raise SystemExit(f"FAIL {name} forward launches {fwd}, expected {ZOO_FWD[name]}")
        rows = fx["act_rows"]
        layer_gap = max(fixture_gap(f"{name} layer {k}",
                                    graph.unpack_nodes(acts[str(k)], n)[rows].cpu(),
                                    fx[f"act/{k}"]) for k in fx["act_layers"])
        out_gap = fixture_gap(f"{name} output", y.cpu(), fx["out"])
        del acts
        # one train step, then the same step through the plain versions
        tr = Trainer(model, preset.train_config(batch_size=1), te.stats, tpl, device=dev)
        names = [k for k, _ in model.named_parameters()]
        reset_launches()
        loss, grads = one_step(tr, tpl, fx)
        step = read_launches()
        expect = counts(**ZOO_FWD[name], **ZOO_BWD[name])
        if step != expect:
            raise SystemExit(f"FAIL {name} step launches {step}, expected {expect}")
        tally(step)
        if abs(loss - float(fx["loss"])) > 1e-4 * abs(float(fx["loss"])):
            raise SystemExit(f"FAIL {name} loss {loss!r} against the fixture's {float(fx['loss'])!r}")
        gref = params_from_fixture(fx, model, "grad")
        worst = grads_within(f"{name} step vs JAX", names, grads,
                             [gref[k].to(dev) for k in names])
        plain_model, _ = fixture_model(fx)
        trp = Trainer(plain_model, preset.train_config(batch_size=1), te.stats, tpl, device=dev)
        reset_launches()
        with bops.plain_versions():
            loss_p, grads_p = one_step(trp, tpl, fx)
        if any(read_launches().values()):
            raise SystemExit(f"FAIL {name}: the plain step launched a kernel")
        worst_p = grads_within(f"{name} kernel step vs plain step", names, grads, grads_p)
        del trp, plain_model, grads_p
        reset_launches()
        losses3 = [float(tr.train_step(tpl, fx["x"][None], mask=fx["mask"])[0]) for _ in range(3)]
        tally(read_launches())
        p3 = params_from_fixture(fx, model, "p3")
        perr = pnoise = 0.0
        for k, p in model.named_parameters():
            if k not in p3:
                continue
            err = (p.detach().cpu() - p3[k]).abs()
            g_abs = gref[k].abs()
            real = g_abs > 1e-3 * g_abs.max() + 1e-6
            perr = max(perr, float(err[real].max()) if real.any() else 0.0)
            pnoise = max(pnoise, float(err[~real].max()) if (~real).any() else 0.0)
        lerr = max(abs(a - b) / abs(b) for a, b in zip(losses3, fx["step_losses"]))
        if perr > 3e-4 or pnoise > 3 * 2 * 5e-4 or lerr > 1e-3:
            raise SystemExit(f"FAIL {name} after 3 Adam steps: parameters off by {perr:.3e} "
                             f"(3e-4; {pnoise:.3e} where the gradient is noise, 3e-3), step "
                             f"losses by {lerr:.3e} relative (1e-3)")
        fixture_report[name] = dict(layer_rel=layer_gap, out_rel=out_gap, grad_share=worst,
                                    plain_grad_share=worst_p, p3=perr, p3_noise=pnoise,
                                    loss=loss, loss_plain=loss_p)
        print(f"  {name}: {len(fx['act_layers'])} layers within {layer_gap:.3e} of max|ref| (worst), "
              f"output {out_gap:.3e}; launches: a forward {ZOO_FWD[name] or 'none'}, a step's "
              f"backward {ZOO_BWD[name] or 'none'}; loss {loss:.7g} against "
              f"{float(fx['loss']):.7g}; {len(names)} gradients, the worst at {worst:.1%} of "
              f"1e-3·max|g_ref| + 1e-6 (kernels vs plain {worst_p:.1%}); 3 Adam steps: "
              f"parameters within {perr:.3e} ({pnoise:.3e} where the gradient is noise), step "
              f"losses within {lerr:.3e} relative")
        del tr, model, grads
        torch.cuda.empty_cache()
    out["fixtures"] = fixture_report
    phase_s[38] = time.perf_counter() - t_phase

    # ---- 39: serving ------------------------------------------------------------------
    t_phase = time.perf_counter()
    print("[39] serving: Inferencer answers 64 bigtown snapshots at batch 32 for each preset "
          "(seeded weights), and one batch of 32 of each preset that launches a kernel is held "
          "against the plain versions (max|d| <= 1e-4 max(1, max|ref|)); then GAT and GIN on "
          "synthctown (dense), one batch of 32 against the plain versions")
    serve = {}
    for name in ZOO:
        preset = presets.MODEL_REGISTRY[name]
        tr_ds, _, te = bigtown(preset)
        tpl = te.members[0].template
        snaps = np.concatenate([te.members[0].array, tr_ds.members[0].array])[:64]
        model, _ = presets.select_model(name, device=dev, seed=0)
        fwd_n = zoo_launches_of(model)[0]
        inf = Inferencer(model, te.stats, device=dev)
        obs = inf.observed_indices(tpl, "random", mask_rate=0.95, seed=0)
        inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs, with_truth=True)
        end.record()
        end.synchronize()
        got = read_launches()
        n_batches = len(snaps) // bs
        expect = counts(**{k: v * n_batches for k, v in fwd_n.items()})
        if got != expect:
            raise SystemExit(f"FAIL {name} serving launches {got}, expected {expect}")
        tally(got)
        if res.pred.shape != snaps.shape or not np.isfinite(res.pred).all():
            raise SystemExit(f"FAIL {name} serving output is not a finite [S, n] field")
        ms = start.elapsed_time(end) / n_batches
        peak = torch.cuda.max_memory_allocated() / 1e9
        gap = None
        if fwd_n:
            # the serving batch through the kernels and through their plain versions
            g = tpl.batch(bs, device=dev)
            xp = g.pack_nodes(torch.as_tensor(snaps[:bs].reshape(-1, 1), device=dev), tpl.n_node)
            reset_launches()
            with torch.no_grad():
                y = model(xp, g)
                torch.cuda.synchronize()
                launched = read_launches()
                reset_launches()
                with bops.plain_versions():
                    y_p = model(xp, g)
            torch.cuda.synchronize()
            if launched != counts(**fwd_n) or any(read_launches().values()):
                raise SystemExit(f"FAIL {name}: the held batch launched {launched} through the "
                                 f"kernels (expected {fwd_n}), or a kernel under plain_versions")
            gap = relative_gap(f"{name} bigtown batch of {bs} vs plain", y, y_p, TOL)
            del xp, y, y_p
        serve[name] = dict(ms=ms, peak_gb=peak, launches_per_batch=fwd_n, plain_gap=gap)
        print(f"  {name}: {len(snaps)} snapshots at batch {bs}: {ms:.3f} ms per batch, launches "
              f"per batch {fwd_n or 'none'}, peak device memory {peak:.3f} GB"
              + (f"; a batch within {gap:.3e} of max|ref| of the plain versions"
                 if gap is not None else ""))
        if name == "graphconvwat":
            profile_batch(lambda: inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs),
                          "one GraphConvWat batch of 32 (377 band SpMMs)", top=12)
        del inf, model
        torch.cuda.empty_cache()
    sstats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    srng = np.random.default_rng(39)
    ssnaps = srng.standard_normal((bs, sn)).astype(np.float32)
    sgraph = stpl.batch(bs, device=dev)
    for name, kernel in (("gat", "fused_attention"), ("gin", None)):
        model, _ = presets.select_model(name, device=dev, seed=0)
        inf = Inferencer(model, sstats, device=dev)
        obs = inf.observed_indices(stpl, "random", mask_rate=0.95, seed=0)
        inf.infer(stpl, ssnaps, obs, scaled=True, batch_size=bs)
        torch.cuda.synchronize()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        inf.infer(stpl, ssnaps, obs, scaled=True, batch_size=bs)
        end.record()
        end.synchronize()
        got = read_launches()
        expect = counts(**({kernel: len(model.convs)} if kernel else {}))
        if got != expect:
            raise SystemExit(f"FAIL synthctown {name} serving launches {got}, expected {expect}")
        tally(got)
        x = torch.as_tensor(ssnaps.reshape(-1, 1), device=dev)
        with torch.no_grad():
            y = model(x, sgraph)
            with bops.plain_versions():
                y_p = model(x, sgraph)
        err = check_close(f"synthctown {name} batch vs plain", y, y_p, TOL, TOL, verbose=False)
        serve[f"synthctown_{name}"] = dict(ms=start.elapsed_time(end), max_abs_err=err)
        print(f"  synthctown (dense) {name}: batch of {bs} {start.elapsed_time(end):.3f} ms, "
              f"launches {dict((k, v) for k, v in got.items() if v) or 'none'}, within {err:.3e} "
              f"of the plain versions")
        del inf, model
    out["serve"] = serve
    phase_s[39] = time.perf_counter() - t_phase

    # ---- 40: training ----------------------------------------------------------------
    t_phase = time.perf_counter()
    print("[40] training on bigtown: Trainer.fit for 2 epochs, GIN at batch 8 and m_GCN at batch "
          "4, each resumed from epoch 1 to a bit-identical end; 3 steps of the other four")
    train = {}
    for name, tbs in (("gin", 8), ("mgcn", 4)):
        preset = presets.MODEL_REGISTRY[name]
        tr_ds, va_ds, _ = bigtown(preset)
        tpl = tr_ds.members[0].template

        def trainer(save, epochs):
            m, p = presets.select_model(name, device=dev, seed=0)
            return Trainer(m, p.train_config(batch_size=tbs, mask_rate=0.95, seed=0, epochs=epochs,
                                              save_path=save), tr_ds.stats, tpl, device=dev)

        with tempfile.TemporaryDirectory() as dir_full, tempfile.TemporaryDirectory() as dir_cut:
            trn = trainer(dir_full, 2)
            fwd_n, bwd_n = zoo_launches_of(trn.model)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            log = []
            best = trn.fit(tr_ds, va_ds, log_fn=lambda s: None,
                           on_epoch_end=lambda ep, mets: log.append(mets))
            torch.cuda.synchronize()
            fit_launches = read_launches()
            fit_peak = torch.cuda.max_memory_allocated() / 1e9
            n_tr = 2 * -(-len(tr_ds.members[0].array) // tbs)
            n_va = 2 * -(-len(va_ds.members[0].array) // tbs)
            expect = counts(**{k: v * (n_tr + n_va) for k, v in fwd_n.items()},
                            **{k: v * n_tr for k, v in bwd_n.items()})
            if fit_launches != expect:
                raise SystemExit(f"FAIL {name} fit launches {fit_launches}, expected {expect}")
            tally(fit_launches)
            tl = [mt["train_loss"] for mt in log]
            vl = [mt["val_loss"] for mt in log]
            if len(tl) != 2 or not np.isfinite(tl + vl).all():
                raise SystemExit(f"FAIL {name} fit: train {tl}, val {vl}")
            trainer(dir_cut, 1).fit(tr_ds, va_ds, log_fn=lambda s: None)
            resumed = trainer(dir_cut, 2)
            resumed.restore(os.path.join(dir_cut, f"last_{name}.ckpt"), log_fn=lambda s: None)
            resumed.fit(tr_ds, va_ds, log_fn=lambda s: None)
            torch.cuda.synchronize()
            sa, sb = trn.opt_state_dict(), resumed.opt_state_dict()
            same = (all(torch.equal(a, b) for a, b in zip(trn.model.state_dict().values(),
                                                         resumed.model.state_dict().values()))
                    and sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa))
            if not same:
                raise SystemExit(f"FAIL the resumed {name} run did not end bit-identical")
            meta = load_checkpoint(os.path.join(dir_full, f"last_{name}.ckpt"))[2]
            if meta["epoch"] != 2 or meta["stats"].norm_type != preset.norm_type:
                raise SystemExit(f"FAIL {name} checkpoint meta {meta['epoch']}, {meta['stats']}")
            batch = tr_ds.members[0].array[:tbs]
            tgen = torch.Generator().manual_seed(0)
            torch.cuda.reset_peak_memory_stats()
            step_ms = cuda_ms(lambda: trn.train_step(tpl, batch, generator=tgen), 2, 10)
            peak = max(fit_peak, torch.cuda.max_memory_allocated() / 1e9)
        train[name] = dict(batch=tbs, step_ms=step_ms, edges_per_s=tbs * tpl.n_edge / step_ms * 1e3,
                           peak_gb=peak, train_loss=tl, val_loss=vl, fit_s=best["train_time_s"])
        print(f"  {name} fit at batch {tbs}: train loss {tl}, val loss {vl} ({preset.criterion}, "
              f"{preset.norm_type}), {best['train_time_s']:.2f} s; launches "
              f"{dict((k, v) for k, v in fit_launches.items() if v) or 'none'}; resumed from "
              f"epoch 1 and ended bit-identical; step {step_ms:.3f} ms "
              f"({tbs * tpl.n_edge / step_ms * 1e3:.0f} edges/s), peak device memory {peak:.3f} GB")
        del trn, resumed
        torch.cuda.empty_cache()
    for name in ("gat", "gcn2", "chebnet", "graphconvwat"):
        preset = presets.MODEL_REGISTRY[name]
        tr_ds, _, _ = bigtown(preset)
        tpl = tr_ds.members[0].template
        m, _ = presets.select_model(name, device=dev, seed=0)
        fwd_n, bwd_n = zoo_launches_of(m)
        tr = Trainer(m, preset.train_config(batch_size=8, seed=0), tr_ds.stats, tpl, device=dev)
        batch = tr_ds.members[0].array[:8]
        tgen = torch.Generator().manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses = [float(tr.train_step(tpl, batch, generator=tgen)[0]) for _ in range(3)]
        torch.cuda.synchronize()
        got = read_launches()
        expect = counts(**{k: 3 * v for k, v in fwd_n.items()},
                        **{k: 3 * v for k, v in bwd_n.items()})
        if got != expect or not np.isfinite(losses).all():
            raise SystemExit(f"FAIL {name} 3 steps: launches {got}, expected {expect}; {losses}")
        tally(got)
        step_ms = cuda_ms(lambda: tr.train_step(tpl, batch, generator=tgen), 1, 3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        train[name] = dict(batch=8, step_ms=step_ms, edges_per_s=8 * tpl.n_edge / step_ms * 1e3,
                           peak_gb=peak, losses=losses)
        print(f"  {name} 3 steps at batch 8: losses {[round(v, 6) for v in losses]}, launches a step "
              f"{fwd_n} + {bwd_n}; step {step_ms:.3f} ms "
              f"({8 * tpl.n_edge / step_ms * 1e3:.0f} edges/s), peak device memory {peak:.3f} GB")
        del tr, m
        torch.cuda.empty_cache()
    out["train"] = train
    phase_s[40] = time.perf_counter() - t_phase

    # ---- 41: remask --------------------------------------------------------------------
    t_phase = time.perf_counter()
    print("[41] remask: GATResRemask and GATResRemaskStack (15 blocks, nc 32) on bigtown, one "
          "forward at batch 4 against the plain versions")
    _, _, te = bigtown(presets.MODEL_REGISTRY["gin"])
    tpl = te.members[0].template
    n = tpl.n_node
    g4 = tpl.batch(4, device=dev)
    x = torch.as_tensor(te.members[0].array[:4].reshape(-1, 1), device=dev)
    bm = torch.as_tensor(np.random.default_rng(41).random(4 * n) < 0.95, device=dev)
    xp = g4.pack_nodes(torch.where(bm[:, None], 0.0, x), n)
    bmp = g4.pack_nodes(bm.to(torch.float32)[:, None], n)[:, 0] > 0.5
    remask = {}
    for cls, spmm in ((GATResRemask, 15), (GATResRemaskStack, 1)):
        torch.manual_seed(0)
        model = cls(15, 32).to(dev).eval()
        with torch.no_grad():
            reset_launches()
            y = model(xp, g4, bmp)
            torch.cuda.synchronize()
            got = read_launches()
            with bops.plain_versions():
                y_p = model(xp, g4, bmp)
        if got != counts(band_attention=30, band_spmm=spmm):
            raise SystemExit(f"FAIL {cls.__name__} launches {got}")
        err = check_close(f"{cls.__name__} vs plain", y, y_p, TOL, TOL, verbose=False)
        ms = cuda_ms(lambda: model(xp, g4, bmp), 1, 5)
        remask[cls.__name__] = dict(max_abs_err=err, ms=ms)
        print(f"  {cls.__name__}: 30 band_attention + {spmm} band_spmm launches, within {err:.3e} "
              f"of the plain versions, {ms:.3f} ms a batch of 4")
    out["remask"] = remask
    phase_s[41] = time.perf_counter() - t_phase

    # ---- 42: the command line ------------------------------------------------------------
    t_phase = time.perf_counter()
    print("[42] the command line: train (one epoch, batch 8), eval (clean) and infer with --model "
          "gin and --model mgcn on artifacts/eval_bigtown.zip, the store phase 33 regenerates")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    forwards, steps = [0], [0]

    def count_forward(module, args, o):
        if isinstance(module, (GIN, MGCN)):
            forwards[0] += 1

    def counted_step(self, *a, **kw):
        steps[0] += 1
        return train_step(self, *a, **kw)

    def run(label, argv):
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            torch.cuda.synchronize()
        finally:
            for ln in buf.getvalue().strip().splitlines()[-6:]:
                print("    " + ln.replace(tmp, "<tmp>"))
        if rc != 0:
            raise SystemExit(f"FAIL cli {label} exited {rc}")
        return time.perf_counter() - t0

    train_step = Trainer.train_step
    hook = torch.nn.modules.module.register_module_forward_hook(count_forward)
    Trainer.train_step = counted_step
    cli_report = {}
    try:
        for name in ("gin", "mgcn"):
            save = os.path.join(tmp, name)
            fwd_n, bwd_n = zoo_launches_of(presets.select_model(name, device=dev, seed=0)[0])
            for cmd, argv in (
                    ("train", ["train", "--model", name, "--dataset_paths", zip_path,
                               "--input_paths", inp, "--batch_size", "8", "--epochs", "1",
                               "--save_path", save, "--variant", "zoo"]),
                    ("eval", ["eval", "--model", name, "--model_path",
                              os.path.join(save, f"best_{name}_zoo.ckpt"), "--test_data_path",
                              zip_path, "--test_input_path", inp, "--test_type", "clean",
                              "--num_test_trials", "2", "--batch_size", "16"]),
                    ("infer", ["infer", "--model", name, "--model_path",
                               os.path.join(save, f"best_{name}_zoo.ckpt"), "--test_data_path",
                               zip_path, "--test_input_path", inp, "--from_set", "test",
                               "--observed", "random", "--batch_size", "8",
                               "--num_snapshots", "8"])):
                argv = argv + list(device_flags)
                reset_launches()
                forwards[0] = steps[0] = 0
                sec = run(f"{cmd} {name}", argv)
                got = read_launches()
                expect = counts(**{k: v * forwards[0] for k, v in fwd_n.items()},
                                **{k: v * steps[0] for k, v in bwd_n.items()})
                if got != expect or not forwards[0]:
                    raise SystemExit(f"FAIL cli {cmd} {name}: {forwards[0]} forwards, {steps[0]} "
                                     f"steps, launches {got}, expected {expect}")
                tally(got)
                cli_report[f"{cmd}_{name}"] = dict(seconds=sec, forwards=forwards[0],
                                                   steps=steps[0])
                print(f"  {cmd} --model {name}: {sec:.2f} s, {forwards[0]} forwards, {steps[0]} "
                      f"steps, launches {dict((k, v) for k, v in got.items() if v) or 'none'}")
            if name == "mgcn":
                sd = load_checkpoint(os.path.join(save, "best_mgcn_zoo.ckpt"))[0]
                meta = load_checkpoint(os.path.join(save, "best_mgcn_zoo.ckpt"))[2]
                if sd["edge.weight"].shape[1] != 2 or meta["stats"].norm_type != "minmax":
                    raise SystemExit("FAIL cli train mgcn: not the preset's edge attributes and "
                                     "minmax")
    finally:
        hook.remove()
        Trainer.train_step = train_step
        shutil.rmtree(tmp, ignore_errors=True)
    out["cli"] = cli_report
    phase_s[42] = time.perf_counter() - t_phase
    out["zoo_launches"] = zoo_launches
    out["phase_s"] = phase_s
    print(f"  zoo summary on {card}: phases' seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; zoo launches {zoo_launches}")
    return out


# ---- phases 43-50: the parallel strategies over torch.distributed -------------------------

MESH_ENTRY = "chip_smoke:mesh_rank"
# the kernels the mesh phases (44-49) run on their ranks
MESH_KERNELS = ("band_attention", "band_spmm", "band_attention_bwd", "band_spmm_bwd",
                "band_attention_flash", "band_attention_flash_bwd", "band_attention_window",
                "band_attention_window_bwd", "band_attention_acc_bwd", "fused_factored",
                "fused_factored_bwd")
_NETS: dict = {}


def kernel_wrappers() -> dict:
    """Every kernel's wrapper, by the kernel's name."""
    from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
        band_attention_acc_bwd, band_attention_bwd, band_attention_flash_bwd,
        band_attention_flash_fwd, band_attention_fwd, band_attention_window_bwd,
        band_attention_window_fwd,
    )
    from gnn_pressure_estimation_tpu_torch.ops.band_spmm import band_spmm_bwd, band_spmm_fwd
    from gnn_pressure_estimation_tpu_torch.ops.graph_attention import (
        fused_attention_bwd, fused_attention_fwd, fused_factored_bwd, fused_factored_fwd,
    )
    from gnn_pressure_estimation_tpu_torch.ops.window_gather import (
        window_gather_bwd, window_gather_fwd,
    )

    return {"band_attention": band_attention_fwd, "band_spmm": band_spmm_fwd,
            "band_attention_bwd": band_attention_bwd, "band_spmm_bwd": band_spmm_bwd,
            "fused_attention": fused_attention_fwd, "fused_attention_bwd": fused_attention_bwd,
            "fused_factored": fused_factored_fwd, "fused_factored_bwd": fused_factored_bwd,
            "band_attention_flash": band_attention_flash_fwd,
            "band_attention_flash_bwd": band_attention_flash_bwd,
            "band_attention_window": band_attention_window_fwd,
            "band_attention_window_bwd": band_attention_window_bwd,
            "band_attention_acc_bwd": band_attention_acc_bwd,
            "window_gather": window_gather_fwd, "window_gather_bwd": window_gather_bwd}


def network(name: str):
    """bigtown, synthctown (their INPs) or meganet (made from its seed), as
    templates; cached in the process."""
    if name not in _NETS:
        from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
        from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp

        if name == "meganet":
            from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_mega

            wn = make_mega()
        else:
            wn = parse_inp(os.path.join(REPO, "inputs", f"{name}.inp"))
        _NETS[name], _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"),
                                        None, name=name)
    return _NETS[name]


def _gatres(spec: dict, dev):
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes

    m = GATRes(**spec["kwargs"]).to(dev)
    m.load_state_dict(torch.load(spec["state"], map_location=dev, weights_only=True))
    return m


def _counted(counters, fn):
    """``fn()`` with the launch counters read around it: (result, launches)."""
    torch.cuda.synchronize()
    for w, attr in counters.values():
        setattr(w, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: getattr(w, attr) for k, (w, attr) in counters.items() if getattr(w, attr)}


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _rank_step(job, mesh, counters):
    """A ``MeshTrainer`` eval step, then a train step on the same batch and
    mask; then 3 more steps timed (step ms, exchange ms, peak memory)."""
    from gnn_pressure_estimation_tpu_torch.parallel import MeshTrainer
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

    tpl = network(job["net"])
    tr = MeshTrainer(_gatres(job["model"], mesh.device), TrainConfig(**job["cfg"]),
                     NormStats(**job["stats"]), tpl, mesh)
    x, mask = job["x"], job["mask"]
    (_, _, out, _), fwd = _counted(counters, lambda: tr.eval_step(tpl, x, mask=mask))
    (loss, mets), step = _counted(counters, lambda: tr.train_step(tpl, x, mask=mask))
    res = {"strategy": tr.strategy, "out": out, "loss": float(loss), "fwd_launches": fwd,
           "step_launches": step, "mae": float(mets["train_mae"]),
           "grads": {k: p.grad.detach().cpu() for k, p in tr.model.named_parameters()},
           "params": {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}}
    torch.cuda.reset_peak_memory_stats()
    st = mesh.exchanges
    st.update(calls=0, bytes=0, seconds=0.0, timing=True)
    t0 = time.perf_counter()
    for _ in range(3):
        tr.train_step(tpl, x, mask=mask)
    torch.cuda.synchronize()
    res["step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    res["exchange_ms"] = st["seconds"] / 3 * 1e3
    res["exchange_calls"] = st["calls"] // 3
    res["exchange_bytes"] = st["bytes"] // 3
    st["timing"] = False
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return _host(res)


def _rank_serve(job, mesh, counters):
    """A serving batch through ``make_mesh_forward``: the output in original
    node order, the launches, the batch's ms."""
    from gnn_pressure_estimation_tpu_torch.parallel.eval_forward import make_mesh_forward

    tpl = network(job["net"])
    model = _gatres(job["model"], mesh.device).eval()
    n, B = tpl.n_node, job["x"].shape[0]
    fwd, adapter = make_mesh_forward(model, tpl, B, mesh)
    x = torch.as_tensor(job["x"].reshape(-1, 1), device=mesh.device)
    m = torch.as_tensor(job["mask"], device=mesh.device)
    x_in = adapter.pack_nodes(torch.where(m[:, None], 0.0, x), n)
    with torch.inference_mode():
        out, launches = _counted(counters, lambda: adapter.unpack_nodes(fwd(x_in), n))
        ms = cuda_ms(lambda: fwd(x_in), 1, 3)
    return _host({"out": out, "launches": launches, "ms": ms, "route": adapter.part.band_attn,
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9})


def _rank_dist(job, mesh, counters):
    """``DistributedTrainer`` (the edge partition; no kernel): one step."""
    from gnn_pressure_estimation_tpu_torch.parallel import DistributedTrainer
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

    tpl = network(job["net"])
    dtr = DistributedTrainer(_gatres(job["model"], mesh.device), TrainConfig(**job["cfg"]),
                             NormStats(**job["stats"]), tpl, mesh)
    (loss, _), launches = _counted(counters, lambda: dtr.step(job["x"], mask=job["mask"]))
    grads = {k: p.grad.detach().cpu() for k, p in dtr.model.named_parameters()}
    t0 = time.perf_counter()
    dtr.step(job["x"], mask=job["mask"])
    torch.cuda.synchronize()
    return {"loss": float(loss), "launches": launches, "grads": grads,
            "step_ms": (time.perf_counter() - t0) * 1e3}


def _rank_eval(job, mesh, counters):
    """``Evaluator(mesh=...)``: clean trials on ``eval_bigtown.zip``'s test split."""
    from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset
    from gnn_pressure_estimation_tpu_torch.evaluation import EvalConfig, Evaluator
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats

    stats = NormStats(**job["stats"])
    test = WDNDataset([job["zip"]], [job["inp"]], from_set="test", stats=stats)
    ev = Evaluator(_gatres(job["model"], mesh.device), EvalConfig(**job["cfg"]), stats,
                   mesh=mesh)
    res, launches = _counted(counters, lambda: ev.evaluate(test, log_fn=lambda *_: None))
    return {"result": res, "launches": launches}


MESH_JOBS = {"step": _rank_step, "serve": _rank_serve, "dist": _rank_dist, "eval": _rank_eval}


def mesh_rank(payload: str) -> int:
    """The entry point of the ranks of phases 44-49 (``parallel.launch``):
    each job of the spec on its own mesh, this rank's results written to
    ``out/rank<r>.pkl``."""
    import pickle

    import torch.distributed as dist

    from gnn_pressure_estimation_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(payload, "rb") as f:
        spec = pickle.load(f)
    wrappers = kernel_wrappers()
    counters = {k: (w, "launches") for k, w in wrappers.items()}
    results = []
    for job in spec["jobs"]:
        mesh = make_mesh(job["dp"], job["gp"], device="cuda")
        t0 = time.perf_counter()
        res = MESH_JOBS[job["kind"]](job, mesh, counters)
        res.update(name=job["name"], backend=mesh.backend, seconds=time.perf_counter() - t0,
                   device=str(mesh.device))
        results.append(res)
        torch.cuda.empty_cache()
    with open(os.path.join(spec["out"], f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(results, f)
    return 0


def launch_mesh(n_ranks: int, jobs: list, out_dir: str, timeout_s: float = 600) -> list:
    """``jobs`` on ``n_ranks`` ranks of this card (``parallel.launch``); every
    rank's results, by rank. A rank that fails fails the run."""
    import pickle

    from gnn_pressure_estimation_tpu_torch.parallel.launch import spawn

    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"jobs": jobs, "out": out_dir}, f)
    code = spawn(n_ranks, MESH_ENTRY, spec, device="cuda", timeout_s=timeout_s)
    if code != 0:
        raise SystemExit(f"FAIL a rank of the {n_ranks}-rank launch exited with {code}")
    out = []
    for r in range(n_ranks):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def launches_as_expected(label: str, got: dict, expected: dict) -> None:
    """A rank's launch counts of one run (the counters it read) must be these."""
    if got != expected:
        raise SystemExit(f"FAIL {label}: launches {got}, expected {expected}")


def grads_gate(label: str, got: dict, ref: dict) -> float:
    """Each gradient within 1e-3·max|g_ref| + 1e-6; the worst share of its bound."""
    worst = 0.0
    for k, r in ref.items():
        g = got[k].to(r.device)
        bound = 1e-3 * float(r.abs().max()) + 1e-6
        err = float((g - r).abs().max())
        if not np.isfinite(err) or err > bound:
            raise SystemExit(f"FAIL {label}: gradient {k} off by {err:.3e} (bound {bound:.3e})")
        worst = max(worst, err / bound)
    return worst


def outputs_gate(label: str, got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """Within 1e-5·max(1, max|ref|); returns the error and whether bit-equal."""
    got = got.to(ref.device)
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {label}: output {tuple(got.shape)} (expected {tuple(ref.shape)}) "
                         "or not finite")
    err = float((got - ref).abs().max())
    bound = 1e-5 * max(1.0, float(ref.abs().max()))
    if err > bound:
        raise SystemExit(f"FAIL {label}: output off by {err:.3e} (bound {bound:.3e})")
    return err, bool(torch.equal(got, ref))


def mesh_kernel_phase(dev, held) -> dict:
    """Phase 43: every band kernel on one rank's chunk of bigtown's 1×2 halo
    layout, halo rows nonzero, against its plain version."""
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
        band_attention_acc_bwd, band_attention_acc_bwd_plain, band_attention_bwd,
        band_attention_bwd_plain, band_attention_flash_bwd, band_attention_flash_bwd_plain,
        band_attention_flash_fwd, band_attention_flash_plain, band_attention_fwd,
        band_attention_plain, band_attention_window_bwd, band_attention_window_bwd_plain,
        band_attention_window_fwd, band_attention_window_plain,
    )
    from gnn_pressure_estimation_tpu_torch.ops.band_spmm import (
        band_spmm_bwd, band_spmm_bwd_plain, band_spmm_fwd, band_spmm_plain,
    )
    from gnn_pressure_estimation_tpu_torch.parallel.halo import build_halo_partition

    tpl = network("bigtown")
    part = build_halo_partition(tpl, 2)
    print(f"[43] band kernels on a rank's chunk of bigtown's 1×2 halo layout: nbL {part.nbL}, BLK "
          f"{part.BLK}, W {part.W}, U {part.U}, R {part.R}, chunk {part.chunk} (the last rank's "
          f"{part.gp * part.nbL - len(tpl.band_layout().win_start)} block(s) empty); x_ext "
          "random on every row, the halo rows included; atol and rtol 1e-4")
    gen = torch.Generator(device=dev).manual_seed(43)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    shapes = {}
    for g in (0, 1):
        a = {k: v[g] for k, v in part.band_arrays.items()}
        msk = torch.as_tensor(a["adj_mask"].view(np.int8), device=dev)
        cnt = torch.as_tensor(a["adj_cnt"], device=dev)
        mix = bops.build_band_index(a["adj_mask"]).to(dev)
        cix = bops.build_band_index(a["adj_cnt"]).to(dev)
        nB, BLK, W = msk.shape
        n_loc, n_ext = nB * BLK, nB * BLK + W - BLK
        shapes[g] = (nB, mix.nnz)
        for B in (8, 32):
            tag = f"rank {g} chunk B {B}"
            for H in (2, 1):
                C = 128
                a_dst, a_src = randn(B, n_loc, H), randn(nB, B, W, H)
                a_dst[:, ::3] = 0.0
                x_ext, d_out = randn(B, n_ext, H, C), randn(B, n_loc, H, C)
                args = (a_dst, a_src, x_ext, msk)
                held("band_attention", f"v2 fwd {tag} H{H}", band_attention_fwd(*args, 0.2, mix),
                     band_attention_plain(*args, 0.2), verbose=False)
                for name, fn, ref in (("band_attention_bwd", band_attention_bwd,
                                       band_attention_bwd_plain),
                                      ("band_attention_acc_bwd", band_attention_acc_bwd,
                                       band_attention_acc_bwd_plain)):
                    for part_, got, r in zip(("d a_dst", "d a_src_win", "d x_ext"),
                                             fn(*args, d_out, 0.2, mix), ref(*args, d_out, 0.2)):
                        held(name, f"{name} {tag} H{H} {part_}", got, r, verbose=False)
                out, m, Z = band_attention_flash_plain(*args, 0.2)
                got = band_attention_flash_fwd(*args, 0.2, mix)
                for part_, g_, r in zip(("out", "m", "Z"), got, (out, m, Z)):
                    held("band_attention_flash", f"v4 fwd {tag} H{H} {part_}", g_, r, verbose=False)
                delta = (d_out * out).sum(dim=-1)
                for part_, g_, r in zip(
                        ("d a_dst", "d a_src_win", "d x_ext"),
                        band_attention_flash_bwd(*args, m, Z, delta, d_out, 0.2, mix),
                        band_attention_flash_bwd_plain(*args, m, Z, delta, d_out, 0.2)):
                    held("band_attention_flash_bwd", f"v4 bwd {tag} H{H} {part_}", g_, r,
                         verbose=False)
                x_win = bops.band_windows_ext(x_ext, nB, BLK, W)
                wargs = (a_dst, a_src, x_win, msk)
                held("band_attention_window", f"v1 fwd {tag} H{H}",
                     band_attention_window_fwd(*wargs, 0.2, mix),
                     band_attention_window_plain(*wargs, 0.2), verbose=False)
                for part_, g_, r in zip(("d a_dst", "d a_src_win", "d x_win"),
                                        band_attention_window_bwd(*wargs, d_out, 0.2, mix),
                                        band_attention_window_bwd_plain(*wargs, d_out, 0.2)):
                    held("band_attention_window_bwd", f"v1 bwd {tag} H{H} {part_}", g_, r,
                         verbose=False)
                del x_ext, d_out, x_win, args, wargs
            x_s, d_s = randn(B, n_ext, 128), randn(B, n_loc, 128)
            held("band_spmm", f"band_spmm {tag}", band_spmm_fwd(cnt, x_s, cix),
                 band_spmm_plain(cnt, x_s), verbose=False)
            held("band_spmm_bwd", f"band_spmm_bwd {tag}", band_spmm_bwd(cnt, d_s, cix),
                 band_spmm_bwd_plain(cnt, d_s), verbose=False)
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"  ranks 0 and 1 (blocks {shapes[0][0]}, mask nonzeros {shapes[0][1]} / "
          f"{shapes[1][1]}), B 8 and 32, H·C 256 and 128: v2, v4, v3 (backward), v1, SpMM, "
          "forward and backward, all within 1e-4 of the plain versions")
    return {"nbL": part.nbL, "U": part.U, "R": part.R, "chunk": part.chunk}


def mesh_phases(dev, card, big) -> dict:
    """Phases 44-50: the parallel strategies on this card: bigtown GATRes-large
    on a 1×1 NCCL mesh and on a 1×2 halo mesh of two gloo ranks, against the
    single-device step; the other band routes on the 1×2 mesh; meganet
    serving on 1×2 through "flash"; synthctown's graphs strategy at 2×1 and
    ``DistributedTrainer`` at 1×2; the mesh evaluation; the command line.
    Returns each kernel's launches on these paths and the phases' numbers."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="mesh_")
    try:
        return _mesh_phases(dev, card, big, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _mesh_phases(dev, card, big, tmp) -> dict:
    from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset
    from gnn_pressure_estimation_tpu_torch.parallel.mesh import choose_backend
    from gnn_pressure_estimation_tpu_torch.evaluation import EvalConfig, Evaluator
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer
    from gnn_pressure_estimation_tpu_torch.utils.masking import batch_node_mask
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    out, phase_s, launched = {}, {}, {}

    def save_state(tag, model):
        path = os.path.join(tmp, f"{tag}.pt")
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
        return path

    def add_launches(counts):
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v

    def mask_of(seed, B, n, rate):
        return batch_node_mask(torch.Generator().manual_seed(seed), B, n, rate).numpy()

    def reference_step(tpl, model, cfg, stats, x, mask):
        """The single-device ``Trainer`` on a copy of ``model``: eval step
        (output, original order) then a train step; loss, gradients,
        parameters after."""
        import copy

        tr = Trainer(copy.deepcopy(model), TrainConfig(**cfg), stats, tpl, device=dev)
        _, _, o, _ = tr.eval_step(tpl, x, mask=mask)
        g = tr._batched_graph(tpl, x.shape[0])
        o = g.unpack_nodes(o, tpl.n_node) if g.banded else o
        loss, _ = tr.train_step(tpl, x, mask=mask)
        torch.cuda.synchronize()
        ref = {"out": o.detach(), "loss": float(loss),
               "grads": {k: p.grad.detach().clone() for k, p in tr.model.named_parameters()},
               "params": {k: v.detach().clone() for k, v in tr.model.state_dict().items()}}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            tr.train_step(tpl, x, mask=mask)
        torch.cuda.synchronize()
        ref["step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        ref["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return ref

    def held_step(label, ranks, ref, fwd_expect, bwd_expect):
        """The gates of a mesh step against the single-device one."""
        lines = []
        for r, res in enumerate(ranks):
            rel = abs(res["loss"] - ref["loss"]) / abs(ref["loss"])
            if rel > 1e-5:
                raise SystemExit(f"FAIL {label} rank {r}: loss {res['loss']!r} against "
                                 f"{ref['loss']!r} (rtol 1e-5)")
            worst = grads_gate(f"{label} rank {r}", res["grads"], ref["grads"])
            err, equal = outputs_gate(f"{label} rank {r}", res["out"], ref["out"])
            launches_as_expected(f"{label} rank {r} forward", res["fwd_launches"], fwd_expect)
            launches_as_expected(f"{label} rank {r} step", res["step_launches"], bwd_expect)
            lines.append(f"{label} rank {r} ({res['backend']}, {res['device']}): loss {res['loss']:.7f} "
                         f"(single {ref['loss']:.7f}), gradients at {worst:.1%} of the gate, "
                         f"outputs within {err:.3e}{' (bit-equal)' if equal else ''}; step "
                         f"{res['step_ms']:.3f} ms, exchange {res['exchange_ms']:.3f} ms in "
                         f"{res['exchange_calls']} exchanges ({res['exchange_bytes'] / 1e6:.3f} MB "
                         f"sent), peak {res['peak_gb']:.3f} GB")
            add_launches(res["fwd_launches"])
            add_launches(res["step_launches"])
        for k in ranks[0]["params"]:
            if any(not torch.equal(res["params"][k], ranks[0]["params"][k]) for res in ranks[1:]):
                raise SystemExit(f"FAIL {label}: the ranks' parameter {k} differ after the step")
        lines.append(f"{label} on one device: step {ref['step_ms']:.3f} ms, peak "
                     f"{ref['peak_gb']:.3f} GB")
        for line in lines:
            print(f"  {line} [{card}]")
        return lines

    # ---- references on one device, and the jobs ------------------------------------
    tfx = big["tfx"]
    tstats = dict(norm_type="znorm", mean=float(tfx["stats_mean"]), std=float(tfx["stats_std"]))
    rng = np.random.default_rng(44)
    big = dict(big, tpl=network("bigtown"))
    n = big["tpl"].n_node
    xb = (np.asarray(big["x"], np.float32)[:, 0][None, :]
          + 0.1 * rng.standard_normal((8, n))).astype(np.float32)
    mask8 = mask_of(44, 8, n, 0.95)
    cfg = dict(batch_size=8, mask_rate=0.95, criterion="mse", model_name="gatres_large")
    large = dict(num_blocks=25, channels=128, attn_impl="factored")
    m_large = GATRes(**large).to(dev)
    m_large.load_state_dict(params_from_parity_npz(big["npz"]))
    large_spec = {"kwargs": large, "state": save_state("large", m_large)}
    t_phase = time.perf_counter()
    ref_big = reference_step(big["tpl"], m_large, cfg, NormStats(**tstats), xb, mask8)
    step_job = dict(kind="step", net="bigtown", model=large_spec, cfg=cfg, stats=tstats, x=xb,
                    mask=mask8)
    nb = len(m_large.blocks)                        # 25: two GATConvs and a mean a block
    expect_fwd = {"band_attention": 2 * nb, "band_spmm": nb}
    expect_step = {**expect_fwd, "band_attention_bwd": 2 * nb, "band_spmm_bwd": nb}

    # ---- 44: 1×1 under NCCL --------------------------------------------------------
    print("[44] bigtown GATRes-large (25 blocks, nc 128) at B 8 on a 1×1 mesh (NCCL): the eval "
          "and train step against the single-device Trainer step on this card")
    r11 = launch_mesh(1, [dict(step_job, name="1x1", dp=1, gp=1)], os.path.join(tmp, "n1"))
    rule = {n_: choose_backend("cuda", n_)[0] for n_ in (1, 2)}    # nccl, gloo on one card
    if r11[0][0]["backend"] != rule[1]:
        raise SystemExit(f"FAIL the 1×1 mesh took {r11[0][0]['backend']}, the rule gives {rule[1]}")
    out["1x1"] = held_step("1×1 NCCL step", [r[0] for r in r11], ref_big, expect_fwd, expect_step)
    phase_s[44] = time.perf_counter() - t_phase

    # ---- 45-49: the two-rank jobs (gloo on one card), one launch --------------------
    t_phase = time.perf_counter()
    jobs = [dict(step_job, name="bigtown 1x2", dp=1, gp=2)]
    routes = ("flash", "acc", "window")
    torch.manual_seed(46)
    m4 = GATRes(num_blocks=4, channels=128).to(dev)
    nb4 = len(m4.blocks)
    spec4 = {"kwargs": dict(num_blocks=4, channels=128), "state": save_state("four", m4)}
    ref_routes = {}
    for route in routes:
        c = dict(cfg, band_attn=route)
        ref_routes[route] = reference_step(big["tpl"], m4, c, NormStats(**tstats), xb, mask8)
        jobs.append(dict(kind="step", name=f"route {route}", net="bigtown", model=spec4, cfg=c,
                         stats=tstats, x=xb, mask=mask8, dp=1, gp=2))
    mega = network("meganet")
    mm_, _ = select_model("gatres_large", device=dev, seed=47)
    mspec = {"kwargs": large, "state": save_state("mega", mm_)}
    xm = np.random.default_rng(47).standard_normal((8, mega.n_node)).astype(np.float32)
    maskm = mask_of(47, 8, mega.n_node, 0.95)
    g_m = mega.batch(8, device=dev)
    with torch.inference_mode():
        xin = torch.where(torch.as_tensor(maskm, device=dev)[:, None], 0.0,
                          torch.as_tensor(xm.reshape(-1, 1), device=dev))
        xin_p = g_m.pack_nodes(xin, mega.n_node)
        ref_mega = g_m.unpack_nodes(mm_.eval()(xin_p, g_m), mega.n_node)
        mega_ms = cuda_ms(lambda: mm_(xin_p, g_m), 1, 3)
    jobs.append(dict(kind="serve", name="meganet 1x2", net="meganet", model=mspec, x=xm,
                     mask=maskm, dp=1, gp=2))
    del mm_, g_m
    syn = network("synthctown")
    small = dict(num_blocks=15, channels=32, attn_impl="factored")
    torch.manual_seed(48)
    ms_ = GATRes(**small).to(dev)
    nbs = len(ms_.blocks)
    sspec = {"kwargs": small, "state": save_state("small", ms_)}
    xs = np.random.default_rng(48).standard_normal((32, syn.n_node)).astype(np.float32)
    masks_ = mask_of(48, 32, syn.n_node, 0.95)
    scfg = dict(batch_size=32, mask_rate=0.95, criterion="mse")
    ref_syn = reference_step(syn, ms_, scfg, NormStats(), xs, masks_)
    jobs.append(dict(kind="step", name="synthctown 2x1", net="synthctown", model=sspec, cfg=scfg,
                     stats={}, x=xs, mask=masks_, dp=2, gp=1))
    dcfg = dict(batch_size=8, mask_rate=0.95, criterion="mse")
    ref_dist = reference_step(syn, ms_, dcfg, NormStats(), xs[:8], masks_[:8 * syn.n_node])
    jobs.append(dict(kind="dist", name="distributed 1x2", net="synthctown", model=sspec, cfg=dcfg,
                     stats={}, x=xs[:8], mask=masks_[:8 * syn.n_node], dp=1, gp=2))
    del ms_
    zip_path = os.path.join(REPO, "artifacts", "eval_bigtown.zip")
    inp = os.path.join(REPO, "inputs", "bigtown.inp")
    train_ds = WDNDataset([zip_path], [inp], from_set="train")
    st = train_ds.stats
    estats = dict(norm_type=st.norm_type, mean=st.mean, std=st.std, min=st.min, max=st.max)
    ecfg = dict(test_type="clean", num_test_trials=1, batch_size=8, mask_rate=0.95,
                gpu_warmup_times=0, seed=49)
    test_ds = WDNDataset([zip_path], [inp], from_set="test", stats=st)
    ref_eval = Evaluator(m_large, EvalConfig(**ecfg), st, device=dev).evaluate(
        test_ds, log_fn=lambda *_: None)
    jobs.append(dict(kind="eval", name="evaluator 1x2", model=large_spec, cfg=ecfg, stats=estats,
                     zip=zip_path, inp=inp, dp=1, gp=2))
    del m_large, m4
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    two = launch_mesh(2, jobs, os.path.join(tmp, "g2"), timeout_s=900)
    t_launch = time.perf_counter() - t0
    by = {res["name"]: [two[r][i] for r in range(2)] for i, res in enumerate(two[0])}
    if any(res["backend"] != rule[2] for rs in by.values() for res in rs):
        raise SystemExit(f"FAIL two ranks on one card must take {rule[2]} by the rule")

    print("[45] the same step on a 1×2 halo mesh: two gloo ranks on this card")
    out["1x2"] = held_step("1×2 halo step", by["bigtown 1x2"], ref_big, expect_fwd, expect_step)
    print('[46] the other routes on the 1×2 mesh: GATRes 4 blocks, nc 128, B 8')
    for route in routes:
        kfwd = {"flash": "band_attention_flash", "acc": "band_attention",
                "window": "band_attention_window"}[route]
        kbwd = {"flash": "band_attention_flash_bwd", "acc": "band_attention_acc_bwd",
                "window": "band_attention_window_bwd"}[route]
        out[route] = held_step(f"route {route}", by[f"route {route}"], ref_routes[route],
                               {kfwd: 2 * nb4, "band_spmm": nb4},
                               {kfwd: 2 * nb4, "band_spmm": nb4, kbwd: 2 * nb4,
                                "band_spmm_bwd": nb4})
    print("[47] meganet GATRes-large serving at B 8 on the 1×2 mesh")
    for r, res in enumerate(by["meganet 1x2"]):
        if res["route"] != "flash":
            raise SystemExit(f"FAIL meganet rank {r}: route {res['route']}, the rule gives flash")
        launches_as_expected(f"meganet rank {r}", res["launches"],
                             {"band_attention_flash": 2 * nb, "band_spmm": nb})
        err, equal = outputs_gate(f"meganet rank {r}", res["out"], ref_mega)
        add_launches(res["launches"])
        print(f"  rank {r}: route flash, launches {res['launches']}, output within {err:.3e} of "
              f"the single-device forward{' (bit-equal)' if equal else ''}; batch "
              f"{res['ms']:.3f} ms (one device {mega_ms:.3f}), peak {res['peak_gb']:.3f} GB "
              f"[{card}]")
    print("[48] synthctown GATRes-small: graphs strategy at 2×1, B 32 (fused factored kernels); "
          "DistributedTrainer at 1×2, B 8 (the edge partition, no kernel)")
    out["2x1"] = held_step("synthctown 2×1", by["synthctown 2x1"], ref_syn,
                           {"fused_factored": 2 * nbs},
                           {"fused_factored": 2 * nbs, "fused_factored_bwd": 2 * nbs})
    for r, res in enumerate(by["distributed 1x2"]):
        launches_as_expected(f"DistributedTrainer rank {r}", res["launches"], {})
        rel = abs(res["loss"] - ref_dist["loss"]) / abs(ref_dist["loss"])
        worst = grads_gate(f"DistributedTrainer rank {r}", res["grads"], ref_dist["grads"])
        if rel > 1e-5:
            raise SystemExit(f"FAIL DistributedTrainer rank {r}: loss off by {rel:.3e} relative")
        print(f"  DistributedTrainer rank {r}: loss {res['loss']:.7f} (single {ref_dist['loss']:.7f}), "
              f"gradients at {worst:.1%} of the gate, no kernel launched; step "
              f"{res['step_ms']:.3f} ms (one device, dense kernels: {ref_dist['step_ms']:.3f}) "
              f"[{card}]")
    print("[49] Evaluator(mesh=) at 1×2 on eval_bigtown.zip's test split (clean, 1 trial, "
          "B 8) against the single-device Evaluator")
    for r, res in enumerate(by["evaluator 1x2"]):
        worst = 0.0
        for got, ref in zip(res["result"], ref_eval):
            for k, v in ref.items():
                if k.startswith(("test_time", "test_throughput")):
                    continue
                e = abs(got[k] - v) / max(abs(v), 1e-6)
                if e > 1e-4:
                    raise SystemExit(f"FAIL mesh evaluation rank {r}: {k} {got[k]!r} against {v!r}")
                worst = max(worst, e)
        add_launches(res["launches"])
        print(f"  rank {r}: every loss and metric within {worst:.2e} relative of the single-device "
              f"evaluation (test_mae {res['result'][1]['test_mae_mean']:.4f}); launches "
              f"{res['launches']}")
    phase_s[45] = t_launch
    print(f"  the two-rank launch took {t_launch:.1f} s ({t_ref:.1f} s of single-device references "
          f"before it)")

    t_phase = time.perf_counter()
    mesh_cli_phase(card, tmp)
    phase_s[50] = time.perf_counter() - t_phase
    out["phase_s"] = phase_s
    out["launches"] = launched
    return out


def mesh_cli_phase(card, tmp, device_flags=()):
    """Phase 50: ``cli train --mesh 1,2`` for one epoch and a resume to two,
    ``cli eval --mesh 1,2``, and a two-process ``--distributed`` train,
    GATRes-large on ``eval_bigtown.zip``. ``device_flags`` (``--device
    cpu``) rehearses it without a card."""
    from gnn_pressure_estimation_tpu_torch import cli as pcli
    from gnn_pressure_estimation_tpu_torch.parallel.launch import free_port
    from gnn_pressure_estimation_tpu_torch.train import load_checkpoint

    zip_path = os.path.join(REPO, "artifacts", "eval_bigtown.zip")
    inp = os.path.join(REPO, "inputs", "bigtown.inp")
    print("[50] cli train --mesh 1,2 (one epoch, then a resume to two), eval --mesh 1,2, and a "
          "two-process --distributed train, GATRes-large on eval_bigtown.zip")
    ck = os.path.join(tmp, "cli")
    train = ["train", "--model", "gatres_large", "--dataset_paths", zip_path, "--input_paths",
             inp, "--batch_size", "8", "--num_trains", "16", "--mask_rate", "0.95",
             "--save_path", ck, "--variant", "mesh", *device_flags]
    t0 = time.perf_counter()
    if pcli.main(train + ["--epochs", "1", "--mesh", "1,2"]) != 0:
        raise SystemExit("FAIL cli train --mesh 1,2")
    t_train = time.perf_counter() - t0
    last = os.path.join(ck, "last_gatres_large_mesh.ckpt")
    t0 = time.perf_counter()
    if pcli.main(train + ["--epochs", "2", "--mesh", "1,2", "--model_path", last]) != 0:
        raise SystemExit("FAIL cli train --mesh 1,2 --model_path")
    t_resume = time.perf_counter() - t0
    if load_checkpoint(last)[2]["epoch"] != 2:
        raise SystemExit("FAIL the resumed mesh run did not write epoch 2")
    t0 = time.perf_counter()
    if pcli.main(["eval", "--model", "gatres_large", "--model_path", last, "--test_data_path",
                  zip_path, "--test_input_path", inp, "--num_test_trials", "1", "--batch_size",
                  "8", "--gpu_warmup_times", "1", "--mesh", "1,2", *device_flags]) != 0:
        raise SystemExit("FAIL cli eval --mesh 1,2")
    t_eval = time.perf_counter() - t0
    port = free_port()
    cmd = [sys.executable, "-m", "gnn_pressure_estimation_tpu_torch.cli"] + train + [
        "--epochs", "1", "--save_path", os.path.join(tmp, "dist"), "--distributed",
        "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2", "--mesh", "1,2"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--process_id", str(i)], cwd=REPO) for i in range(2)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    t_dist = time.perf_counter() - t0
    if codes != [0, 0] or not os.path.exists(os.path.join(tmp, "dist",
                                                          "last_gatres_large_mesh.ckpt")):
        raise SystemExit(f"FAIL the --distributed train: exit codes {codes}")
    print(f"  train --mesh 1,2 {t_train:.1f} s, its resume {t_resume:.1f} s, eval --mesh 1,2 "
          f"{t_eval:.1f} s, the --distributed pair {t_dist:.1f} s (start-up included) [{card}]")


# the instances with the logits rounded (GATConv's dtype=bfloat16, logit_bf16 on the
# wrappers, counted in launches_logit): counter name → (the kernel of ``main``'s
# wrappers; the TPU source and line of the Pallas program of that route: the JAX
# layer runs its XLA band ops on the narrow banded layers and its XLA branch on the
# dense softmax, whose shapes these kernels take, and its v1 kernel on the window
# route at H·C 128 and more)
LOGIT_INSTANCES = {
    "band_attention_logit": ("band_attention", TPU_SRC, 208),
    "band_attention_bwd_logit": ("band_attention_bwd", TPU_SRC, 313),
    "fused_attention_logit": ("fused_attention", TPU_DENSE_SRC, 70),
    "fused_attention_bwd_logit": ("fused_attention_bwd", TPU_DENSE_SRC, 82),
    "band_attention_window_logit": ("band_attention_window", TPU_SRC, 47),
}


def gap_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got − ref| in units of the fixtures' training gate, 1e-3·max|ref| + 1e-6."""
    return float((got - ref).abs().max()) / (1e-3 * float(ref.abs().max()) + 1e-6)


def knob_phases(dev, card, held, max_err, reset_launches, read_launches, counts, big) -> dict:
    """Phases 51-55: the last training knobs on the card. 51 bf16 activations
    (GATConv's ``dtype``: the instances with the logits rounded against their
    plain versions, the synthctown and bigtown fixtures of
    ``tools/parity_precision_export.py``, serving and steps in turns with
    f32, the raise where the JAX package raises); 52 ``band_factored``; 53
    ``matmul_precision``; 54 ``epochs_per_dispatch``; 55 ``cli train`` with
    the three flags and a resume. Returns the launches and times for the
    kernels' line."""
    import contextlib
    import io
    import shutil
    import tempfile

    from gnn_pressure_estimation_tpu_torch import cli
    from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset, _Member
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.layers import bf16_scalar
    from gnn_pressure_estimation_tpu_torch.models.presets import apply_model_knobs, select_model
    from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer, load_checkpoint
    from gnn_pressure_estimation_tpu_torch.train.precision import matmul_precision
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    def art(name):
        return os.path.join(REPO, "artifacts", name)

    bf16 = torch.bfloat16
    sl = bf16_scalar(0.2)
    gen = torch.Generator(device=dev).manual_seed(51)
    rng = np.random.default_rng(51)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rounded(t):
        return t.to(bf16).float()

    btpl, bmask, bix, bnpz = big["tpl"], big["mask"], big["mask_ix"], big["npz"]
    bl = btpl.band_layout()
    nB, BLK, W = bl.adj_mask.shape
    n_pad, n_ext, bn = bl.n_pad, bl.n_pad + W - BLK, btpl.n_node
    stpl = network("synthctown")
    sg = stpl.batch(1, device=dev)
    smask, smix, sn = sg.adj_sl_mask, sg.adj_sl_index, stpl.n_node
    fstats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    out = {"rows": [], "launches": dict.fromkeys(LOGIT_INSTANCES, 0), "new_path": {}}

    def add(launched):
        for k, v in launched.items():
            out["new_path"][k] = out["new_path"].get(k, 0) + v
            if k in out["launches"]:
                out["launches"][k] += v

    def logit_grads(name, label, got, ref):
        """d a_dst / d a_src of a logit instance: each rounds its dz to bf16, and
        the kernel's and the plain version's f32 delta may round it a step apart:
        every value within 2^-7·max|ref| + 1e-4 and at most 1% past 1e-4·max|ref| + 1e-4."""
        err = (got - ref).abs()
        top = float(ref.abs().max())
        fine = TOL * top + TOL
        share = float((err > fine).float().mean())
        if not torch.isfinite(got).all() or float(err.max()) > 2.0 ** -7 * top + TOL or share > 0.01:
            raise SystemExit(f"FAIL {label}: max abs err {float(err.max()):.3e} (max |ref| "
                             f"{top:.3e}), {share:.2%} past {fine:.1e}")
        max_err[name] = max(max_err[name], float(err.max()))
        print(f"  {label}: max abs err {float(err.max()):.3e}, {share:.3%} a bf16 step apart")

    def timed(name, B, hc, fn, plain, nbytes, ops):
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
        r = dict(name=name, B=B, hc=hc, ms=cuda_ms(fn, 3, 20), device_ms=device_ms(fn),
                 plain_ms=cuda_ms(plain, 1, 2), bytes=nbytes, library_ms=None,
                 bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        out["rows"].append(r)
        print(f"  {name} B {B} H·C {hc}: {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), plain "
              f"{r['plain_ms']:.4f} ms, library none, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{nbytes / 1e6:.1f} MB; {r['bound_ms'] / r['ms']:.1%} of it reached)")

    def step_of(tr, tpl, x, mask):
        """One B-sized step's loss, gradients and launches, the block outputs
        captured (original node order)."""
        acts = []
        hooks = [b.register_forward_hook(lambda m_, a_, o_: acts.append(o_.detach()))
                 for b in tr.model.blocks]
        graph, xs, ms, k = tr._prepare(tpl, x, mask, None, None)
        tr.model.train()
        reset_launches()
        loss, _, _ = tr._masked_loss_and_metrics(graph, xs, xs, ms, k, "train")
        names = [n_ for n_, _ in tr.model.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss, list(tr.model.parameters()))))
        torch.cuda.synchronize()
        launched = read_launches()
        for h in hooks:
            h.remove()
        if graph.banded:
            acts = [graph.unpack_nodes(a, tpl.n_node) for a in acts]
        return float(loss), [a.cpu() for a in acts], {k_: v.cpu() for k_, v in grads.items()}, \
            launched

    def against_fixture(label, fx, case, blocks_held, runs):
        """The bf16 step beside the JAX bf16 fixture: the blocks before the first
        rounding flip within 1e-3, the loss nearer the fixture than the f32
        step's (the run fails otherwise); later blocks and the gradients
        reported (a gradient's distance beside twice the f32 step's)."""
        loss16, acts16, g16, _ = runs[bf16]
        loss32, _, g32, _ = runs[None]
        errs = []
        for i, a in enumerate(acts16):
            key = f"{case}act_block_{i}"
            if key in fx.files:
                errs.append(float((a - torch.as_tensor(fx[key])).abs().max()))
        if any(e > 1e-3 for e in errs[:blocks_held]):
            raise SystemExit(f"FAIL {label}: blocks before the first flip off by {errs[:blocks_held]}")
        ref = float(fx[f"{case}loss"])
        if abs(loss16 - ref) >= abs(loss32 - ref):
            raise SystemExit(f"FAIL {label}: bf16 loss {loss16:.7f} no nearer the JAX bf16 fixture "
                             f"{ref:.7f} than the f32 step's {loss32:.7f}")
        top = max(float(np.abs(fx[f"{case}grad_{k}"]).max()) for k in g16)
        worst = 0.0
        for k, g in g16.items():
            r = torch.as_tensor(fx[f"{case}grad_{k}"])
            e16, e32 = float((g - r).abs().max()), float((g32[k] - r).abs().max())
            worst = max(worst, e16 / (max(2 * e32, 2.0 ** -6 * float(r.abs().max())) + 1e-4 * top))
        first = next((i for i, e in enumerate(errs) if e > 1e-3), None)
        print(f"  {label}: loss {loss16:.7f} (JAX bf16 {ref:.7f}, f32 step {loss32:.7f}); blocks "
              f"within {max(errs[:blocks_held]):.2e} up to block {blocks_held - 1}, the first past "
              f"1e-3 {first} (per block {[f'{e:.1e}' for e in errs]}); gradients at {worst:.0%} of "
              f"the model rule (twice the f32 step's distance, or 2^-6·max|g|, + 1e-4·max)")
        return dict(loss=loss16, ref=ref, f32=loss32, blocks=errs, grad_rule=worst)

    def turns(label, run_f32, run_bf16, iters=10):
        """ms and peak memory of two runs in turns f32, bf16, bf16, f32."""
        t, peak = {"f32": [], "bf16": []}, {"f32": [], "bf16": []}
        for which in ("f32", "bf16", "bf16", "f32"):
            fn = run_f32 if which == "f32" else run_bf16
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t[which].append(cuda_ms(fn, 2, iters))
            peak[which].append(torch.cuda.max_memory_allocated() / 1e9)
        print(f"  {label}: f32 {t['f32'][0]:.3f} / {t['f32'][1]:.3f} ms, bf16 {t['bf16'][0]:.3f} / "
              f"{t['bf16'][1]:.3f} ms (turns f32, bf16, bf16, f32); peak memory f32 "
              f"{max(peak['f32']):.3f} GB, bf16 {max(peak['bf16']):.3f} GB")
        return {"ms": t, "peak_gb": {k: max(v) for k, v in peak.items()}}

    res = {}
    # ---- 51: bf16 activations ------------------------------------------------------------
    print(f"[51] bf16 activations (GATConv dtype): the instances with the logits rounded vs their "
          f"plain versions (forwards atol/rtol 1e-4; the backwards' d a a bf16 step of dz apart "
          f"on at most 1%), slope {sl}")
    for B, H, C in ((1, 2, 32), (1, 1, 32), (8, 2, 32), (32, 1, 32), (2, 40, 4)):
        a_d, a_s = rounded(randn(B, n_pad, H)), rounded(randn(nB, B, W, H))
        x = randn(B, n_ext, H, C).to(bf16)
        d_o = randn(B, n_pad, H, C)
        held("band_attention_logit", f"v2 logit fwd bigtown B {B} H {H} C {C}",
             ba.band_attention_fwd(a_d, a_s, x, bmask, sl, bix, True, True),
             ba.band_attention_plain(a_d, a_s, x, bmask, sl, True, True))
        got = ba.band_attention_bwd(a_d, a_s, x, bmask, d_o, sl, bix, True, True)
        ref = ba.band_attention_bwd_plain(a_d, a_s, x, bmask, d_o, sl, True, True)
        held("band_attention_bwd_logit", f"v2 logit bwd d x_ext B {B} H {H} C {C}", got[2], ref[2])
        for i, nm in ((0, "d a_dst"), (1, "d a_src_win")):
            logit_grads("band_attention_bwd_logit", f"v2 logit bwd {nm} B {B} H {H} C {C}", got[i],
                        ref[i])
    for B, H, C in ((1, 2, 32), (1, 1, 32), (32, 2, 32), (32, 1, 128), (2, 2, 128)):
        a_d, a_s = rounded(randn(B, sn, H)), rounded(randn(B, sn, H))
        v, d_o = randn(B, sn, H, C).to(bf16), randn(B, sn, H, C)
        held("fused_attention_logit", f"dense logit fwd synthctown B {B} H {H} C {C}",
             ga.fused_attention_fwd(a_d, a_s, v, smask, sl, smix, True, True),
             ga.fused_attention_plain(a_d, a_s, v, smask, sl, True, True))
        got = ga.fused_attention_bwd(a_d, a_s, v, smask, d_o, sl, smix, True, True)
        ref = ga.fused_attention_bwd_plain(a_d, a_s, v, smask, d_o, sl, True, True)
        held("fused_attention_bwd_logit", f"dense logit bwd d v B {B} H {H} C {C}", got[2], ref[2])
        for i, nm in ((0, "d a_dst"), (1, "d a_src")):
            logit_grads("fused_attention_bwd_logit", f"dense logit bwd {nm} B {B} H {H} C {C}",
                        got[i], ref[i])
    for B, H, C in ((2, 2, 128), (2, 1, 128), (8, 2, 128)):
        a_d, a_s = rounded(randn(B, n_pad, H)), rounded(randn(nB, B, W, H))
        xw = bops.band_windows_ext(rounded(randn(B, n_ext, H, C)), nB, BLK, W).contiguous()
        held("band_attention_window_logit", f"v1 logit fwd bigtown B {B} H {H} C {C}",
             ba.band_attention_window_fwd(a_d, a_s, xw, bmask, sl, bix, True),
             ba.band_attention_window_plain(a_d, a_s, xw, bmask, sl, True))
    del a_d, a_s, x, xw, v, d_o, got, ref
    # their times at the main path's shapes: v2 at bigtown B 32 (serving) and B 8 (the
    # step) at GATRes-small's conv1 width, the dense pair at synthctown B 32, v1 at
    # GATRes-large's conv1 width at B 8 (the window route's serving batch)
    print(f"  times on {card} (CUDA events, 20 launches after 3; bounds at 2-byte x rows for v2 "
          f"and the dense pair, f32 windows for v1)")
    ix_bytes = 4 * (n_pad + 1 + bix.nnz)
    for B, H, C in ((32, 2, 32), (8, 2, 32), (32, 1, 32)):
        a_d, a_s = rounded(randn(B, n_pad, H)), rounded(randn(nB, B, W, H))
        x = randn(B, n_ext, H, C).to(bf16)
        d_o = randn(B, n_pad, H, C)
        timed("band_attention_logit", B, H * C,
              lambda: ba.band_attention_fwd(a_d, a_s, x, bmask, sl, bix, True, True),
              lambda: ba.band_attention_plain(a_d, a_s, x, bmask, sl, True, True),
              4 * (B * n_pad * H + nB * B * W * H + B * n_pad * H * C) + 2 * B * n_ext * H * C
              + ix_bytes + 4 * (nB + 1), B * H * bix.nnz * (2 * C + 6))
        timed("band_attention_bwd_logit", B, H * C,
              lambda: ba.band_attention_bwd(a_d, a_s, x, bmask, d_o, sl, bix, True, True),
              lambda: ba.band_attention_bwd_plain(a_d, a_s, x, bmask, d_o, sl, True, True),
              band_bwd_bytes(B, nB, BLK, W, H, C, bix.nnz, 2), B * H * bix.nnz * (4 * C + 16))
    for B, H, C in ((32, 2, 32), (32, 1, 32), (32, 2, 128)):
        a_d, a_s = rounded(randn(B, sn, H)), rounded(randn(B, sn, H))
        v, d_o = randn(B, sn, H, C).to(bf16), randn(B, sn, H, C)
        timed("fused_attention_logit", B, H * C,
              lambda: ga.fused_attention_fwd(a_d, a_s, v, smask, sl, smix, True, True),
              lambda: ga.fused_attention_plain(a_d, a_s, v, smask, sl, True, True),
              4 * (2 * B * sn * H + B * sn * H * C) + 2 * B * sn * H * C + 4 * (sn + 1 + smix.nnz),
              B * H * smix.nnz * (2 * C + 6))
        timed("fused_attention_bwd_logit", B, H * C,
              lambda: ga.fused_attention_bwd(a_d, a_s, v, smask, d_o, sl, smix, True, True),
              lambda: ga.fused_attention_bwd_plain(a_d, a_s, v, smask, d_o, sl, True, True),
              band_bwd_bytes(B, 1, sn, sn, H, C, smix.nnz, 2), B * H * smix.nnz * (4 * C + 16))
    for B, H, C in ((8, 2, 128), (8, 1, 128)):
        a_d, a_s = rounded(randn(B, n_pad, H)), rounded(randn(nB, B, W, H))
        xw = bops.band_windows_ext(rounded(randn(B, n_ext, H, C)), nB, BLK, W).contiguous()
        timed("band_attention_window_logit", B, H * C,
              lambda: ba.band_attention_window_fwd(a_d, a_s, xw, bmask, sl, bix, True),
              lambda: ba.band_attention_window_plain(a_d, a_s, xw, bmask, sl, True),
              4 * (B * n_pad * H + nB * B * W * H + nB * B * W * H * C + B * n_pad * H * C)
              + ix_bytes + 4 * (nB + 1), B * H * bix.nnz * (2 * C + 6))
    del a_d, a_s, x, xw, v, d_o
    torch.cuda.empty_cache()

    # (a) the synthctown fixture, dense, B 1: GATRes-small and GATRes-large's width
    fxp = art("parity_train_synthctown_act_bf16.npz")
    fx = np.load(fxp)
    print(f"  synthctown fixture {os.path.relpath(fxp, REPO)} (JAX Trainer, B 1, XLA branches): the "
          f"blocks before the first flip (0-1) held to 1e-3, the loss to be nearer than f32's")
    res["synthctown"] = {}
    for size, blocks, nc in (("small", 15, 32), ("large", 2, 128)):
        for impl in ("factored", "softmax"):
            case = f"{size}_{impl}_"
            runs = {}
            for dt in (bf16, None):
                model = GATRes(blocks, nc, attn_impl=impl, dtype=dt)
                model.load_state_dict(params_from_parity_npz(fxp, prefix=f"{size}_"))
                tr = Trainer(model, TrainConfig(batch_size=1), fstats, stpl, device=dev)
                runs[dt] = step_of(tr, stpl, fx["x"].reshape(1, -1), fx["mask"])
            launched = runs[bf16][3]
            kern = ("fused_factored", "fused_factored_bwd") if impl == "factored" else \
                ("fused_attention_logit", "fused_attention_bwd_logit")
            expect = counts(**{kern[0]: 2 * blocks, kern[1]: 2 * blocks})
            if launched != expect:
                raise SystemExit(f"FAIL {case[:-1]} step launches {launched}, expected {expect}")
            add(launched)
            res["synthctown"][case[:-1]] = against_fixture(
                f"synthctown {case[:-1]} B 1 step ({2 * blocks} + {2 * blocks} launches of "
                f"{kern[0]})", fx, case, 2, runs)
            del runs, tr, model

    # (b) serving at B 32 and a B 32 step, dense, in turns with f32
    res["dense_turns"] = {}
    xs = rng.standard_normal((32, sn)).astype(np.float32)
    smsk = np.zeros((32, sn), bool)
    for b in range(32):
        smsk[b, rng.permutation(sn)[:int(sn * 0.95)]] = True
    for preset, blocks in (("gatres_small", 15), ("gatres_large", 25)):
        for impl in ("factored", "softmax"):
            trs = {}
            for dt in (None, bf16):
                model, _ = select_model(preset, device=dev, seed=3, dtype=dt)
                apply_model_knobs(model, attn_impl=impl)
                trs[dt] = Trainer(model, TrainConfig(batch_size=32), fstats, stpl, device=dev)
            graph, xg, _, _ = trs[bf16]._prepare(stpl, xs, smsk.reshape(-1), None, None)
            for tr in trs.values():
                tr.model.eval()
            reset_launches()
            with torch.no_grad():
                trs[bf16].model(xg, graph)
            torch.cuda.synchronize()
            served = read_launches()
            kern = "fused_factored" if impl == "factored" else "fused_attention_logit"
            if served != counts(**{kern: 2 * blocks}):
                raise SystemExit(f"FAIL {preset} {impl} bf16 forward launches {served}")
            reset_launches()
            trs[bf16].train_step(stpl, xs, smsk.reshape(-1))
            torch.cuda.synchronize()
            stepped = read_launches()
            bwd = "fused_factored_bwd" if impl == "factored" else "fused_attention_bwd_logit"
            if stepped != counts(**{kern: 2 * blocks, bwd: 2 * blocks}):
                raise SystemExit(f"FAIL {preset} {impl} bf16 step launches {stepped}")
            add(served)
            add(stepped)

            def serve(dt, tr_=trs):
                with torch.no_grad():
                    tr_[dt].model(xg, graph)

            sv = turns(f"{preset} {impl} serving B 32 ({2 * blocks} launches of {kern})",
                       lambda: serve(None), lambda: serve(bf16))
            st = turns(f"{preset} {impl} train step B 32",
                       lambda: trs[None].train_step(stpl, xs, smsk.reshape(-1)),
                       lambda: trs[bf16].train_step(stpl, xs, smsk.reshape(-1)), iters=5)
            res["dense_turns"][f"{preset}_{impl}"] = {"serve": sv, "step": st}
            del trs
            torch.cuda.empty_cache()

    # (c) bigtown GATRes-small, banded: every GATConv narrower than the Pallas kernels
    fxp = art("parity_train_bigtown_small_act_bf16.npz")
    fx = np.load(fxp)
    runs = {}
    for dt in (bf16, None):
        model = GATRes(15, 32, attn_impl="factored", dtype=dt)
        model.load_state_dict(params_from_parity_npz(fxp))
        tr = Trainer(model, TrainConfig(batch_size=1), fstats, btpl, device=dev)
        runs[dt] = step_of(tr, btpl, fx["x"].reshape(1, -1), fx["mask"])
    expect = counts(band_attention_logit=30, band_attention_bwd_logit=30, band_spmm=15,
                    band_spmm_bwd=15)
    if runs[bf16][3] != expect:
        raise SystemExit(f"FAIL bigtown small bf16 step launches {runs[bf16][3]}, expected {expect}")
    add(runs[bf16][3])
    res["bigtown_small"] = against_fixture(
        f"bigtown GATRes-small banded B 1 step ({os.path.relpath(fxp, REPO)}; 30 + 30 launches of "
        f"v2 with the logits rounded)", fx, "", 2, runs)
    del runs
    xb8 = rng.standard_normal((8, bn)).astype(np.float32)
    bm8 = np.zeros((8, bn), bool)
    for b in range(8):
        bm8[b, rng.permutation(bn)[:int(bn * 0.95)]] = True
    trs = {}
    for dt in (None, bf16):
        model, _ = select_model("gatres_small", device=dev, seed=3, dtype=dt)
        trs[dt] = Trainer(model, TrainConfig(batch_size=8), fstats, btpl, device=dev)
    graph, xg, _, _ = trs[bf16]._prepare(btpl, xb8, bm8.reshape(-1), None, None)

    def bserve(dt):
        with torch.no_grad():
            trs[dt].model(xg, graph)

    res["bigtown_small_turns"] = {
        "serve_b8": turns("bigtown GATRes-small serving B 8", lambda: bserve(None),
                          lambda: bserve(bf16)),
        "step_b8": turns("bigtown GATRes-small train step B 8",
                         lambda: trs[None].train_step(btpl, xb8, bm8.reshape(-1)),
                         lambda: trs[bf16].train_step(btpl, xb8, bm8.reshape(-1)), iters=5)}
    del trs, graph, xg
    torch.cuda.empty_cache()

    # (d) where the JAX package raises: GATRes-large on bigtown's v2 route, before any launch;
    # on the window route (the JAX v1 kernel) the forward runs and the backward raises
    model, _ = select_model("gatres_large", device=dev, seed=3, dtype=bf16)
    model.load_state_dict(params_from_parity_npz(bnpz))
    g1 = btpl.batch(1, mode="banded", device=dev)
    x1 = g1.pack_nodes(torch.as_tensor(big["x"], device=dev), bn)
    reset_launches()
    try:
        model(x1, g1)
        raise SystemExit("FAIL GATRes-large bf16 on bigtown's dma route did not raise")
    except NotImplementedError as e:
        torch.cuda.synchronize()
        if any(read_launches().values()):
            raise SystemExit(f"FAIL the raise came after launches: {read_launches()}")
        print(f"  bigtown GATRes-large bf16 on the dma route raises before any launch: "
              f"{str(e)[:110]}...")
    gw = btpl.batch(8, mode="banded", device=dev, band_attn="window")
    x8 = gw.pack_nodes(torch.as_tensor(np.repeat(big["x"][None, :, 0], 8, 0).reshape(-1, 1),
                                       device=dev), bn)
    model.eval()
    first = []
    hook = model.blocks[0].conv1.register_forward_hook(lambda m_, a_, o_: first.append(o_))
    reset_launches()
    with torch.no_grad():
        yk = model(x8, gw)
    torch.cuda.synchronize()
    wl = read_launches()
    if wl != counts(band_attention_window_logit=50, band_spmm=25):
        raise SystemExit(f"FAIL the window route's bf16 forward launched {wl}")
    add(wl)
    with torch.no_grad(), bops.plain_versions():
        yp = model(x8, gw)
    hook.remove()
    # the first GATConv held (its input, lin0's output, is the same on both sides);
    # past it the two sides' f32 outputs, a last bit apart, round a bf16 step apart
    # now and then in the next projection (rounding flips), so the output is reported
    check_close("window route bf16 block 0 conv1 B 8 vs the plain versions", first[0], first[1],
                TOL, TOL)
    print(f"  window route bf16 output B 8 vs the plain versions: {float((yk - yp).abs().max()):.3e} "
          f"(max |y| {float(yp.abs().max()):.3f}; 25 blocks of rounding flips)")
    model.train()
    try:
        model(x8, gw).sum().backward()
        raise SystemExit("FAIL the window route's bf16 backward did not raise")
    except NotImplementedError:
        print("  window route bf16 (the JAX v1 kernel): the forward serves B 8 with 50 launches of "
              "v1 with the logits rounded, the backward raises as the JAX one does")
    del model, yk, yp, x8, gw
    torch.cuda.empty_cache()

    # ---- 52: band_factored ---------------------------------------------------------------------
    print("[52] attn_impl=band_factored on bigtown: GATRes-small (plain torch, as the JAX XLA op) "
          "against its fixture, f32 and attn_dtype bf16; GATRes-large keeps the band kernels")
    fxp = art("parity_train_bigtown_small_band_factored.npz")
    fx = np.load(fxp)
    res["band_factored"] = {}
    f32_run = None
    for tag, attn_dtype in (("f32", None), ("bf16", "bfloat16")):
        model = apply_model_knobs(GATRes(15, 32, attn_impl="band_factored"), attn_dtype=attn_dtype)
        model.load_state_dict(params_from_parity_npz(fxp))
        tr = Trainer(model, TrainConfig(batch_size=1), fstats, btpl, device=dev)
        loss, _, grads, launched = step_of(tr, btpl, fx["x"].reshape(1, -1), fx["mask"])
        if launched != counts(band_spmm=15, band_spmm_bwd=15):
            raise SystemExit(f"FAIL band_factored step launches {launched}")
        add(launched)
        ref = float(fx[f"{tag}_loss"])
        graph, xs1, ms1, _ = tr._prepare(btpl, fx["x"].reshape(1, -1), fx["mask"], None, None)
        with torch.no_grad():
            yo = graph.unpack_nodes(tr.model(torch.where(ms1[:, None], 0.0, xs1), graph), bn)
        ferr = float((yo.cpu() - torch.as_tensor(fx[f"{tag}_out"])).abs().max())
        if tag == "f32":
            # f32: the training gate and the fixtures' forward gate
            worst = max(gap_share(g, torch.as_tensor(fx[f"f32_grad_{k}"])) for k, g in grads.items())
            if abs(loss - ref) > 1e-4 * abs(ref) or worst > 1.0 or ferr > 1e-3:
                raise SystemExit(f"FAIL band_factored f32: loss {loss:.7f} against {ref:.7f}, "
                                 f"gradients at {worst:.2f}× the gate, forward {ferr:.3e}")
            f32_run = (loss, grads)
            rule = "the 1e-3 gate"
        else:
            # bf16 stores through 15 blocks: rounding flips, as for bf16 activations;
            # the loss nearer the JAX bf16 fixture than the f32-store step's, each
            # gradient by the model rule beside the f32-store step's distance
            if abs(loss - ref) >= abs(f32_run[0] - ref):
                raise SystemExit(f"FAIL band_factored bf16 loss {loss:.7f} no nearer {ref:.7f} "
                                 f"than the f32 stores' {f32_run[0]:.7f}")
            top = max(float(np.abs(fx[f"bf16_grad_{k}"]).max()) for k in grads)
            worst = 0.0
            for k, g in grads.items():
                r = torch.as_tensor(fx[f"bf16_grad_{k}"])
                e16, e32 = float((g - r).abs().max()), float((f32_run[1][k] - r).abs().max())
                worst = max(worst, e16 / (max(2 * e32, 2.0 ** -6 * float(r.abs().max()))
                                          + 1e-4 * top))
            if worst > 1.0:
                raise SystemExit(f"FAIL band_factored bf16 gradients at {worst:.2f}× the model rule")
            rule = "the model rule (twice the f32 stores' distance, or 2^-6·max|g|, + 1e-4·max)"
        res["band_factored"][tag] = dict(loss=loss, ref=ref, grad_share=worst, out_err=ferr)
        print(f"  GATRes-small {tag}: loss {loss:.7f} (JAX {ref:.7f}), gradients at {worst:.1%} of "
              f"{rule}, forward within {ferr:.2e}; launches: band SpMM 15 + 15, no band attention")
        del model, tr
    model, _ = select_model("gatres_large", device=dev, seed=3)
    model.load_state_dict(params_from_parity_npz(bnpz))
    model.eval()
    g8 = btpl.batch(8, mode="banded", device=dev)
    x8 = g8.pack_nodes(torch.as_tensor(rng.standard_normal((8 * bn, 1)).astype(np.float32),
                                       device=dev), bn)
    outs, lts = [], []
    for impl in ("factored", "band_factored"):
        apply_model_knobs(model, attn_impl=impl)
        reset_launches()
        with torch.no_grad():
            outs.append(model(x8, g8))
        torch.cuda.synchronize()
        lts.append(read_launches())
    check_equal("GATRes-large band_factored vs the preset, B 8", outs[1], outs[0])
    if lts[0] != lts[1] or lts[1] != counts(band_attention=50, band_spmm=25):
        raise SystemExit(f"FAIL GATRes-large band_factored launches {lts}")
    add(lts[1])
    print(f"  GATRes-large B 8: band_factored output bit-equal to the preset's, launches {lts[1]}")
    del model, outs, x8, g8
    torch.cuda.empty_cache()

    # ---- 53: matmul precision -------------------------------------------------------------
    print("[53] matmul_precision: a bigtown GATRes-large B 8 step and a synthctown GATRes-small "
          "B 32 step under each name beside the default (f32) step")
    A, Bm = randn(512, 512), randn(512, 512)
    f64 = A.double() @ Bm.double()

    def tf32(t):
        return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    refs = {"bf16": rounded(A).double() @ rounded(Bm).double(),
            "tf32": tf32(A).double() @ tf32(Bm).double()}
    gemm = {}
    for prec in ("highest", "tensorfloat32", "bfloat16"):
        with matmul_precision(prec):
            C_ = (A @ Bm).double()
        gemm[prec] = {k: float((C_ - r).abs().max()) for k, r in
                      (("f64", f64), ("bf16_operands", refs["bf16"]), ("tf32_operands", refs["tf32"]))}
    torch.set_float32_matmul_precision("medium")
    medium = (A @ Bm).double()
    torch.set_float32_matmul_precision("highest")
    gemm["torch_medium"] = {"bf16_operands": float((medium - refs["bf16"]).abs().max()),
                            "tf32_operands": float((medium - refs["tf32"]).abs().max())}
    top = float(f64.abs().max())
    if not (gemm["bfloat16"]["bf16_operands"] <= 1e-5 * top
            and gemm["tensorfloat32"]["tf32_operands"] < gemm["tensorfloat32"]["f64"]
            and gemm["tensorfloat32"]["f64"] > 1e-5 * top and gemm["highest"]["f64"] <= 1e-5 * top):
        raise SystemExit(f"FAIL a precision did not take effect on a 512×512 GEMM: {gemm}")
    print(f"  512×512 GEMM: highest {gemm['highest']['f64']:.2e} from f64; tensorfloat32 "
          f"{gemm['tensorfloat32']['tf32_operands']:.2e} from the TF32-operand product, "
          f"{gemm['tensorfloat32']['f64']:.2e} from f64; bfloat16 "
          f"{gemm['bfloat16']['bf16_operands']:.2e} from the bf16-operand product; torch's "
          f"'medium' alone gives {gemm['torch_medium']['tf32_operands']:.2e} from TF32's, "
          f"{gemm['torch_medium']['bf16_operands']:.2e} from bf16's (so the bf16 rounding is "
          f"explicit)")
    res["gemm"] = gemm
    res["precision"] = {}
    big_x = np.asarray(big["x"][:, 0], np.float32)
    cases = (("bigtown_large_b8", btpl, "gatres_large", 8,
              (big_x[None, :] + 0.1 * rng.standard_normal((8, bn))).astype(np.float32)),
             ("synthctown_small_b32", stpl, "gatres_small", 32, xs))
    for label, tpl, preset, B, xb in cases:
        n_ = tpl.n_node
        msk = np.zeros((B, n_), bool)
        for b in range(B):
            msk[b, rng.permutation(n_)[:int(n_ * 0.95)]] = True
        per = {}
        for prec in (None, "highest", "tensorfloat32", "bfloat16"):
            model, _ = select_model(preset, device=dev, seed=5)
            if preset == "gatres_large":
                model.load_state_dict(params_from_parity_npz(bnpz))
            tr = Trainer(model, TrainConfig(batch_size=B, matmul_precision=prec), fstats, tpl,
                         device=dev)
            reset_launches()
            loss, _ = tr.train_step(tpl, xb, msk.reshape(-1))
            torch.cuda.synchronize()
            launched = read_launches()
            if (torch.get_float32_matmul_precision() != "highest"
                    or torch.backends.cuda.matmul.allow_tf32):
                raise SystemExit(f"FAIL {label} {prec}: the setting was not restored after the step")
            grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
            ms = cuda_ms(lambda: tr.train_step(tpl, xb, msk.reshape(-1)), 1, 3)
            per[prec] = (float(loss), grads, launched, ms)
            del tr, model
        base = per[None]
        row = {}
        for prec, (loss, grads, launched, ms) in per.items():
            if launched != base[2]:
                raise SystemExit(f"FAIL {label} {prec}: launches {launched} against {base[2]}")
            share = max(gap_share(g, base[1][k]) for k, g in grads.items())
            if prec == "highest" and (share != 0.0 or loss != base[0]):
                raise SystemExit(f"FAIL {label}: highest is not the default step bit for bit")
            row[str(prec)] = dict(loss=loss, grad_share_of_gate=share, step_ms=ms)
            print(f"  {label} {prec}: loss {loss:.7f}, gradients at {share:.2%} of the f32 step's "
                  f"gate, step {ms:.3f} ms, launches as the default's")
        add(base[2])
        res["precision"][label] = row
        torch.cuda.empty_cache()

    # ---- 54: epochs_per_dispatch ------------------------------------------------------------
    print("[54] epochs_per_dispatch: synthctown GATRes-small fit, 4 epochs, batch 4 with tails, at "
          "E 1, 2 and 4; E 2 against the JAX _fit_fast with its masks replayed; a resume")
    fxp = art("parity_fit_fast_synthctown.npz")
    fx = np.load(fxp)

    def mk(a, tpl=stpl):
        return WDNDataset.from_members([_Member(tpl, a, [], None)], fstats)

    def fit_run(E, epochs=4, masks=None, save=None, restore=None):
        model = GATRes(15, 32, attn_impl="factored")
        model.load_state_dict(params_from_parity_npz(fxp))
        tr = Trainer(model, TrainConfig(epochs=epochs, batch_size=4, mask_rate=0.95, seed=0,
                                        epochs_per_dispatch=E, save_path=save, model_name="m"),
                     fstats, stpl, device=dev)
        if restore:
            tr.restore(restore, log_fn=lambda *_: None)
        hist = []
        t0 = time.perf_counter()
        tr.fit(mk(fx["train"]), mk(fx["val"]), log_fn=lambda *_: None, masks=masks,
               on_epoch_end=lambda ep, m: hist.append((ep, m)))
        torch.cuda.synchronize()
        return tr, hist, time.perf_counter() - t0

    runs = {E: fit_run(E) for E in (1, 2, 4)}
    h2, h4 = runs[2][1], runs[4][1]
    same = h2 == h4 and all(torch.equal(a, b) for a, b in zip(runs[2][0].model.parameters(),
                                                               runs[4][0].model.parameters()))
    if not same:
        raise SystemExit("FAIL the E 2 and E 4 fits differ")
    io2, io4 = runs[2][0].fast_io, runs[4][0].fast_io
    if io2 != {"blocks": 2, "readbacks": 2, "uploads": 10} or io4["readbacks"] != 1:
        raise SystemExit(f"FAIL read-backs: E 2 {io2}, E 4 {io4}")
    print(f"  E 2 and E 4 bit-identical (losses {[round(m['train_loss'], 6) for _, m in h2]}); "
          f"host transfers E 2 {io2}, E 4 {io4}; wall E 1 {runs[1][2]:.2f} s, E 2 {runs[2][2]:.2f} "
          f"s, E 4 {runs[4][2]:.2f} s")
    tr_j, hj, _ = fit_run(2, masks=lambda ep: (fx["masks_train"][ep - 1], fx["masks_val"][ep - 1]))
    # the first block's losses held to rtol 1e-4; the second block follows 6 Adam
    # steps, whose updates move a component with a noise gradient by up to 2·lr a
    # step whatever its size: its losses to 1e-3, the parameters to the fixtures'
    # Adam gate for such components, 3e-3 (the CPU port reads the same: 1.65e-4,
    # 1.18e-3)
    tl = np.array([m["train_loss"] for _, m in hj])
    vl = np.array([m["val_loss"] for _, m in hj])
    rel = np.maximum(np.abs(tl / fx["train_loss"] - 1), np.abs(vl / fx["val_loss"] - 1))
    perr = max(float((p.detach().cpu() - torch.as_tensor(fx[f"final_{k}"])).abs().max())
               for k, p in tr_j.model.named_parameters())
    lerr = float(rel.max())
    if rel[:2].max() > 1e-4 or lerr > 1e-3 or perr > 3e-3:
        raise SystemExit(f"FAIL E 2 against the JAX _fit_fast: losses rtol {rel}, parameters "
                         f"within {perr:.2e}")
    print(f"  E 2 with the JAX masks: per-epoch losses within rtol {[f'{r:.2e}' for r in rel]} of "
          f"the JAX _fit_fast ({os.path.relpath(fxp, REPO)}), parameters within {perr:.2e} (gate "
          f"3e-3)")
    with tempfile.TemporaryDirectory() as d:
        fit_run(2, epochs=2, save=d)
        tr_r, hr, _ = fit_run(2, save=d, restore=os.path.join(d, "last_m.ckpt"))
        _, _, meta = load_checkpoint(os.path.join(d, "last_m.ckpt"))
    if hr != h2[2:] or not all(torch.equal(a, b) for a, b in zip(tr_r.model.parameters(),
                                                               runs[2][0].model.parameters())):
        raise SystemExit("FAIL the resume across a block boundary is not bit-identical")
    print(f"  resume after epoch 2 (a block boundary): epochs 3-4 and the parameters bit-identical; "
          f"the last checkpoint's params_epoch {meta['extra']['resume'].get('params_epoch')}")
    res["fit_fast"] = dict(loss_rtol=lerr, param_err=perr, io_e2=io2, io_e4=io4,
                           wall_s={E: r[2] for E, r in runs.items()})
    del runs, tr_j, tr_r
    # bigtown GATRes-large, B 8, 2 epochs at E 2: 20 train snapshots (a tail of 4), 8 val
    arr = (big_x[None, :] + 0.1 * rng.standard_normal((28, bn))).astype(np.float32)
    model, _ = select_model("gatres_large", device=dev, seed=3)
    model.load_state_dict(params_from_parity_npz(bnpz))
    tr = Trainer(model, TrainConfig(epochs=2, batch_size=8, epochs_per_dispatch=2), fstats, btpl,
                 device=dev)
    reset_launches()
    t0 = time.perf_counter()
    hist = []
    tr.fit(mk(arr[:20], btpl), mk(arr[20:], btpl), log_fn=lambda *_: None,
           on_epoch_end=lambda ep, m: hist.append(m))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = read_launches()
    expect = counts(band_attention=50 * 4 * 2, band_spmm=25 * 4 * 2, band_attention_bwd=50 * 3 * 2,
                    band_spmm_bwd=25 * 3 * 2)
    if launched != expect or tr.fast_io["readbacks"] != 1 or not all(
            np.isfinite([m["train_loss"], m["val_loss"]]).all() for m in hist):
        raise SystemExit(f"FAIL bigtown E 2 fit: launches {launched} (expected {expect}), "
                         f"{tr.fast_io}, {hist}")
    add(launched)
    print(f"  bigtown GATRes-large B 8, 2 epochs in one block (3 steps with a tail of 4, 1 val "
          f"step): {wall:.2f} s, losses {[round(m['train_loss'], 5) for m in hist]}, launches "
          f"{launched}, {tr.fast_io}")
    res["fit_fast"]["bigtown_wall_s"] = wall
    del tr, model
    torch.cuda.empty_cache()

    # ---- 55: cli train with the three flags, and a resume ---------------------------------------
    print("[55] cli train --model gatres_small on artifacts/eval_bigtown.zip with --activation_dtype "
          "bfloat16 --matmul_precision bfloat16 --epochs_per_dispatch 2, then a resume to epoch 4")
    # the command's train and valid datasets hold two template objects in both
    # packages, so the JAX command's fit takes the per-epoch path whatever
    # --epochs_per_dispatch says (the block needs one template); the port's does too
    tmp = tempfile.mkdtemp(prefix="chip_smoke_knobs_")
    fitted = []
    real_fit = Trainer.fit

    def seen_fit(self, *a, **kw):
        best = real_fit(self, *a, **kw)
        fitted.append((self.cfg, dict(self.fast_io)))
        return best

    Trainer.fit = seen_fit
    try:
        save = os.path.join(tmp, "run")
        argv = ["train", "--model", "gatres_small", "--dataset_paths", art("eval_bigtown.zip"),
                "--input_paths", os.path.join(REPO, "inputs", "bigtown.inp"), "--batch_size", "8",
                "--mask_rate", "0.95", "--save_path", save, "--activation_dtype", "bfloat16",
                "--matmul_precision", "bfloat16", "--epochs_per_dispatch", "2", "--variant", "knobs"]
        last = os.path.join(save, "last_gatres_small_knobs.ckpt")
        for label, extra, want in (("train", ["--epochs", "2"], 2),
                                   ("resume", ["--epochs", "4", "--model_path", last], 4)):
            buf = io.StringIO()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for ln in buf.getvalue().strip().splitlines()[-4:]:
                print("    " + ln.replace(tmp, "<tmp>"))
            launched = read_launches()
            _, _, meta = load_checkpoint(last)
            pe = meta["extra"]["resume"].get("params_epoch")
            cfg, fio = fitted[-1]
            # 40 train snapshots (5 steps), 8 valid (1 step) an epoch; 2 epochs a run
            expect = counts(band_attention_logit=30 * 12, band_attention_bwd_logit=30 * 10,
                            band_spmm=15 * 12, band_spmm_bwd=15 * 10)
            if (rc != 0 or meta["epoch"] != want or pe is not None or launched != expect
                    or cfg.matmul_precision != "bfloat16" or cfg.epochs_per_dispatch != 2
                    or fio["blocks"] != 0):
                raise SystemExit(f"FAIL cli {label}: rc {rc}, last checkpoint epoch {meta['epoch']} "
                                 f"(expected {want}), params_epoch {pe}, launches {launched} "
                                 f"(expected {expect}), {cfg}, {fio}")
            add(launched)
            print(f"  cli {label}: exit 0 in {wall:.1f} s, last checkpoint at epoch {want}; the "
                  f"trainer's matmul_precision {cfg.matmul_precision}, epochs_per_dispatch "
                  f"{cfg.epochs_per_dispatch}, the per-epoch path as in the JAX command (blocks "
                  f"{fio['blocks']}); launches {launched['band_attention_logit']} + "
                  f"{launched['band_attention_bwd_logit']} of v2 with the logits rounded")
    finally:
        Trainer.fit = real_fit
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(res)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
    from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
    from gnn_pressure_estimation_tpu_torch.evaluation.infer import Inferencer
    from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
    from gnn_pressure_estimation_tpu_torch.models.presets import select_model
    from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset, _Member
    from gnn_pressure_estimation_tpu_torch.ops import _build
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops
    from gnn_pressure_estimation_tpu_torch.ops.band_attention import (
        band_attention_bwd, band_attention_bwd_plain, band_attention_flash_bwd,
        band_attention_flash_bwd_plain, band_attention_flash_fwd, band_attention_flash_plain,
        band_attention_fwd, band_attention_plain,
    )
    from gnn_pressure_estimation_tpu_torch.ops.band_spmm import (
        band_spmm_bwd, band_spmm_bwd_plain, band_spmm_fwd, band_spmm_plain,
    )
    from gnn_pressure_estimation_tpu_torch.train import TrainConfig, Trainer, load_checkpoint
    from gnn_pressure_estimation_tpu_torch.utils.scaling import NormStats, descale_with
    from gnn_pressure_estimation_tpu_torch.weights import params_from_parity_npz

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    print(f"[1] card: {card} ({kind}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
    ptxas = {name: ptxas_table(log) for name, log in logs.items()}
    for name, table in ptxas.items():
        for fn, regs, stack, st, ld in table:
            print(f"  {name}: {fn}: {regs} registers, {stack} bytes stack, spill {st} / {ld} bytes")
    bf16_regs = check_band_instances(ptxas)
    print(f"  every band-attention instance at its recorded registers and spills "
          f"({sum(map(len, F32_BAND_INSTANCES.values()))} f32 kernels in "
          f"{len(F32_BAND_INSTANCES)} sources, {len(bf16_regs)} bf16); the bf16-operand instances: "
          + "; ".join(f"{src} {fn} {regs} registers, spill {st} / {ld}"
                      for src, fn, regs, _, st, ld in bf16_regs))

    wn = parse_inp(os.path.join(REPO, "inputs", "bigtown.inp"))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name="bigtown")
    n = tpl.n_node
    bl = tpl.band_layout()
    nB, BLK, W = bl.adj_mask.shape
    n_pad, n_ext = bl.n_pad, bl.n_pad + W - BLK
    mask = torch.as_tensor(bl.adj_mask.view(np.int8), device=dev)
    cnt = torch.as_tensor(bl.adj_cnt, device=dev)
    mask_ix = tpl.band_index("adj_mask").to(dev)      # the template's cached indices, as
    cnt_ix = tpl.band_index("adj_cnt").to(dev)        # the model's path passes them
    wrappers = kernel_wrappers()
    band_wrappers = {k: wrappers[k] for k in ("band_attention", "band_spmm", "band_attention_bwd",
                                              "band_spmm_bwd")}
    # every kernel instance's count: (wrapper, attribute); the bf16-operand instances
    # count in their wrapper's launches_bf16
    counters = {**{k: (w, "launches") for k, w in wrappers.items()},
                **{k: (wrappers[w], "launches_bf16")
                   for k, (w, _) in {**BF16_INSTANCES, **DENSE_BF16_INSTANCES}.items()},
                **{k: (wrappers[w], "launches_logit") for k, (w, _, _) in LOGIT_INSTANCES.items()}}

    def reset_launches():
        for w, attr in counters.values():
            setattr(w, attr, 0)

    def read_launches():
        return {k: getattr(w, attr) for k, (w, attr) in counters.items()}

    def counts(**launched):
        """The expected reading: the named kernels' counts, 0 for the others."""
        return {k: launched.get(k, 0) for k in counters}
    print(f"  bigtown: n {n}, edges {tpl.n_edge}, nB {nB}, BLK {BLK}, W {W}, n_pad {n_pad}, "
          f"n_ext {n_ext}, mask density {bl.adj_mask.mean():.4%}")

    # ---- 3: each kernel against its plain version -------------------------
    print("[3] kernels vs plain versions on the card")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    max_err = dict.fromkeys(counters, 0.0)

    def held(name, label, got, ref, verbose=True):
        max_err[name] = max(max_err[name], check_close(label, got, ref, TOL, TOL, verbose))

    def check_attention(tag, msk, B, H, C, index):
        """Forward, and backward with a random cotangent on every row."""
        nB_, BLK_, W_ = msk.shape
        np_, ne_ = nB_ * BLK_, nB_ * BLK_ + W_ - BLK_
        args = (randn(B, np_, H), randn(nB_, B, W_, H), randn(B, ne_, H, C), msk)
        label = f"{tag} B{B} H{H} C{C}"
        held("band_attention", f"band_attention {label}",
             band_attention_fwd(*args, 0.2, index), band_attention_plain(*args, 0.2))
        d_out = randn(B, np_, H, C)
        got = band_attention_bwd(*args, d_out, 0.2, index)
        ref = band_attention_bwd_plain(*args, d_out, 0.2)
        for part, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref):
            held("band_attention_bwd", f"band_attention_bwd {label} {part}", g, r, verbose=False)
        print(f"  band_attention_bwd {label}: max abs err so far "
              f"{max_err['band_attention_bwd']:.3e}")
        return args, d_out

    def check_spmm(tag, band, B, C, index, d_out=None):
        nB_, BLK_, W_ = band.shape
        x_ext = randn(B, nB_ * BLK_ + W_ - BLK_, C)
        label = f"{tag} {str(band.dtype)[6:]} B{B} C{C}"
        held("band_spmm", f"band_spmm {label}", band_spmm_fwd(band, x_ext, index),
             band_spmm_plain(band, x_ext))
        d_out = randn(B, nB_ * BLK_, C) if d_out is None else d_out
        got = band_spmm_bwd(band, d_out, index)
        held("band_spmm_bwd", f"band_spmm_bwd {label}", got, band_spmm_bwd_plain(band, d_out))
        check_equal(f"band_spmm_bwd {label}, a second call", band_spmm_bwd(band, d_out, index), got)
        return x_ext, d_out

    def check_flash_bwd(tag, msk, B, H, C, index, x_ext=None, d_out=None):
        """The flash backward from the plain forward's m, Z and delta, with a
        random cotangent on every row; a second call bit-equal to the first."""
        nB_, BLK_, W_ = msk.shape
        np_, ne_ = nB_ * BLK_, nB_ * BLK_ + W_ - BLK_
        a_dst, a_src = randn(B, np_, H), randn(nB_, B, W_, H)
        a_dst[:, ::3] = 0.0                  # a_dst + a_src == 0 occurs: the sign test's edge
        a_src[:, :, ::3] = 0.0
        x_ext = randn(B, ne_, H, C) if x_ext is None else x_ext
        d_out = randn(B, np_, H, C) if d_out is None else d_out
        out, m, Z = band_attention_flash_plain(a_dst, a_src, x_ext, msk, 0.2)
        args = (a_dst, a_src, x_ext, msk, m, Z, (d_out * out).sum(dim=-1), d_out, 0.2)
        got = band_attention_flash_bwd(*args, index)
        again = band_attention_flash_bwd(*args, index)
        label = f"{tag} B{B} H{H} C{C}"
        for part, g, g2, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, again,
                                  band_attention_flash_bwd_plain(*args)):
            held("band_attention_flash_bwd", f"band_attention_flash_bwd {label} {part}", g, r,
                 verbose=False)
            check_equal(f"band_attention_flash_bwd {label} {part}, a second call", g2, g)
        print(f"  band_attention_flash_bwd {label}: max abs err so far "
              f"{max_err['band_attention_flash_bwd']:.3e}, a second call bit-equal")

    for B in (1, 4):                            # fixture parity runs B 1
        for H in (2, 1):
            check_attention("bigtown", mask, B, H, 128, mask_ix)
        check_spmm("bigtown", cnt, B, 128, cnt_ix)
    rng = np.random.default_rng(0)
    rmask = rng.random((3, 16, 70)) < 0.3
    rmask[-1, -5:] = False                       # fully masked (padded) rows
    rmask_t = torch.as_tensor(rmask.view(np.int8), device=dev)
    rcnt = torch.as_tensor((rmask * rng.integers(1, 4, rmask.shape)).astype(np.int8), device=dev)
    rw = torch.as_tensor((rmask * rng.random(rmask.shape)).astype(np.float32), device=dev)
    rix, rcnt_ix, rw_ix = (bops.band_index_of(t) for t in (rmask_t, rcnt, rw))
    # wide rows: more than 32 entries, which the row pass takes 32 at a time;
    # dense columns: extended rows that more than 32 entries read, which the
    # backwards' columns passes take 32 at a time
    wide = torch.as_tensor((rng.random((2, 16, 200)) < 0.4).view(np.int8), device=dev)
    wix = bops.band_index_of(wide)
    dense = torch.as_tensor((np.random.default_rng(7).random((4, 16, 48)) < 0.95).view(np.int8),
                            device=dev)
    dix = bops.band_index_of(dense)
    ragged = [("ragged", rmask_t, 3, 2, 32, rix), ("ragged", rmask_t, 2, 1, 300, rix),
              ("ragged", rmask_t, 2, 3, 33, rix),       # C % 4 != 0: the scalar loads
              ("ragged", rmask_t, 2, 40, 4, rix),       # past 32 heads: several head groups
              ("ragged", rmask_t, 2, 1, 256, rix),      # two float4 slots of one head
              ("ragged", rmask_t, 1, 3, 128, rix),      # a last tile half past the heads
              ("wide rows", wide, 2, 2, 32, wix),
              ("wide rows", wide, 1, 1, 160, wix),      # C past one 128-channel tile
              ("wide rows", wide, 1, 33, 3, wix),       # 33 heads, scalar loads
              ("dense columns", dense, 2, 2, 64, dix), ("dense columns", dense, 1, 3, 33, dix),
              ("dense columns", dense, 2, 2, 128, dix)]
    for shape in ragged:
        check_attention(*shape)
        check_flash_bwd(*shape)
    dcnt = torch.as_tensor(
        (dense.cpu().numpy() * np.random.default_rng(8).integers(1, 4, dense.shape)).astype(np.int8),
        device=dev)
    for band, bix in ((rcnt, rcnt_ix), (rw, rw_ix), (dcnt, bops.band_index_of(dcnt))):
        check_spmm("ragged", band, 3, 64, bix)
        check_spmm("ragged", band, 2, 300, bix)
        check_spmm("ragged", band, 2, 33, bix)          # C % 4 != 0: the scalar loads
        check_spmm("ragged", band, 2, 3, bix)
    # an x_ext that starts 4 bytes off 16-byte alignment: both forwards take their scalar loads
    for B, H, C in ((2, 2, 64), (1, 1, 128)):
        a_dst, a_src = randn(B, 48, H), randn(3, B, 70, H)
        x_off = torch.empty(B * 102 * H * C + 1, device=dev)[1:].view(B, 102, H, C)
        x_off.copy_(randn(B, 102, H, C))
        if bops.vector_loads(x_off, C):
            raise SystemExit("FAIL the offset view passes as 16-byte aligned")
        held("band_attention", f"band_attention offset x_ext B{B} H{H} C{C}",
             band_attention_fwd(a_dst, a_src, x_off, rmask_t, 0.2, rix),
             band_attention_plain(a_dst, a_src, x_off, rmask_t, 0.2))
        d_out = randn(B, 48, H, C)
        for part, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"),
                              band_attention_bwd(a_dst, a_src, x_off, rmask_t, d_out, 0.2, rix),
                              band_attention_bwd_plain(a_dst, a_src, x_off, rmask_t, d_out, 0.2)):
            held("band_attention_bwd", f"band_attention_bwd offset x_ext B{B} H{H} C{C} {part}", g, r)
        # the flash backward with that x_ext, and with a d_out as far off alignment
        check_flash_bwd("offset x_ext", rmask_t, B, H, C, rix, x_ext=x_off)
        d_off = torch.empty(B * 48 * H * C + 1, device=dev)[1:].view(B, 48, H, C)
        d_off.copy_(randn(B, 48, H, C))
        check_flash_bwd("offset d_out", rmask_t, B, H, C, rix, d_out=d_off)
        x_off = x_off.view(B, 102, H * C)
        held("band_spmm", f"band_spmm offset x_ext B{B} C{H * C}", band_spmm_fwd(rw, x_off, rw_ix),
             band_spmm_plain(rw, x_off))
        check_spmm("offset d_out", rw, B, H * C, rw_ix, d_out=d_off.view(B, 48, H * C))
    torch.cuda.synchronize()

    # ---- 4: fixture parity ------------------------------------------------
    print("[4] fixture parity against the JAX activations")
    npz = os.path.join(REPO, "artifacts", "parity_r5_trained.npz")
    fx = np.load(npz)
    model = GATRes(int(fx["num_blocks"]), int(fx["nc"]))
    model.load_state_dict(params_from_parity_npz(npz))
    model = model.to(dev).eval()
    graph = tpl.batch(1, device=dev)
    acts = {}
    hooks = [blk.register_forward_hook(lambda m, i, o, k=k: acts.__setitem__(k, o))
             for k, blk in enumerate(model.blocks)]
    band_attention_fwd.launches = band_spmm_fwd.launches = 0
    with torch.inference_mode():
        x = graph.pack_nodes(torch.as_tensor(fx["x"], device=dev), n)
        out = graph.unpack_nodes(model(x, graph), n)
        torch.cuda.synchronize()
    launches = (band_attention_fwd.launches, band_spmm_fwd.launches)
    per_forward = {"band_attention": launches[0], "band_spmm": launches[1]}
    for h in hooks:
        h.remove()
    if launches != (2 * model.num_blocks, model.num_blocks):
        raise SystemExit(f"FAIL launches per forward {launches}, expected (50, 25)")
    print(f"  launches per forward: band_attention {launches[0]}, band_spmm {launches[1]}")
    block_err = max(
        check_close(f"bigtown block {k}", graph.unpack_nodes(a, n).cpu(),
                    torch.as_tensor(fx[f"ours_act_block_{k}"]), 1e-3, 0.0, verbose=False)
        for k, a in sorted(acts.items())
    )
    out_err = check_close("bigtown output", out.cpu(), torch.as_tensor(fx["ours_out"]), 1e-3, 0.0)
    print(f"  bigtown GATRes-large vs JAX: worst block {block_err:.3e}, output {out_err:.3e}")

    dz = np.load(os.path.join(REPO, "artifacts", "parity.npz"))
    und = dz["edge_index_und"].T
    dtpl = GraphTemplate(int(dz["n"]), np.concatenate([und[:, 0], und[:, 1]]),
                         np.concatenate([und[:, 1], und[:, 0]]))
    dmodel = GATRes(int(dz["num_blocks"]), int(dz["nc"]), attn_impl="softmax")
    dmodel.load_state_dict(params_from_parity_npz(os.path.join(REPO, "artifacts", "parity.npz")))
    dmodel = dmodel.to(dev).eval()
    dgraph = dtpl.batch(int(dz["batch"]), device=dev)
    dacts = {}
    hooks = [blk.register_forward_hook(lambda m, i, o, k=k: dacts.__setitem__(k, o))
             for k, blk in enumerate(dmodel.blocks)]
    with torch.inference_mode():
        dout = dmodel(torch.as_tensor(dz["x"], device=dev), dgraph)
    for h in hooks:
        h.remove()
    dblock_err = max(
        check_close(f"dense block {k}", a.cpu(), torch.as_tensor(dz[f"ours_act_block_{k}"]),
                    1e-4, 0.0, verbose=False)
        for k, a in sorted(dacts.items())
    )
    dout_err = check_close("dense output", dout.cpu(), torch.as_tensor(dz["ours_out"]), 1e-4, 0.0,
                           verbose=False)
    print(f"  dense GATRes (15 blocks, nc 32) vs JAX: worst block {dblock_err:.3e}, "
          f"output {dout_err:.3e}")

    # ---- 5: serving -------------------------------------------------------
    print("[5] serving through Inferencer")
    smodel, _ = select_model("gatres_large", device=dev)
    smodel.load_state_dict(params_from_parity_npz(npz))
    stats = NormStats(norm_type="znorm", mean=50.0, std=10.0)
    inf = Inferencer(smodel, stats, device=dev)
    snaps = (fx["x"][:, 0][None, :] + 0.1 * rng.standard_normal((64, n))).astype(np.float32)
    obs = inf.observed_indices(tpl, "random", mask_rate=0.95, seed=0)
    bs = 32
    n_batches = -(-len(snaps) // bs)
    inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs)          # warm-up
    torch.cuda.synchronize()
    band_attention_fwd.launches = band_spmm_fwd.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = inf.infer(tpl, snaps, obs, scaled=True, batch_size=bs, with_truth=True)
    end.record()
    end.synchronize()
    serve_launches = {"band_attention": band_attention_fwd.launches,
                      "band_spmm": band_spmm_fwd.launches}
    expect = {"band_attention": n_batches * 50, "band_spmm": n_batches * 25}
    if serve_launches != expect:
        raise SystemExit(f"FAIL serving launches {serve_launches}, expected {expect}")
    if res.pred.shape != snaps.shape or not np.isfinite(res.pred).all():
        raise SystemExit("FAIL serving output is not a finite [S, n] field")
    served = np.asarray(descale_with(snaps, stats), np.float32)[:, obs]
    if not np.array_equal(res.pred[:, obs], served):
        raise SystemExit("FAIL observed nodes are not served at their readings")
    print(f"  {len(snaps)} snapshots, batch {bs}, {len(obs)} observed of {n}: "
          f"{start.elapsed_time(end) / n_batches:.3f} ms per batch; launches {serve_launches}; "
          f"hidden MAE {res.metrics['hidden_mae']:.4f}")
    profile_batch(lambda: inf.infer(tpl, snaps[:bs], obs, scaled=True, batch_size=bs))

    # ---- 6: kernel times at the serving (B 32) and training (B 8) shapes ---
    print(f"[6] kernel times on {card}")
    nnz_mask, nnz_cnt = mask_ix.nnz, cnt_ix.nnz
    index_bytes = lambda ix: 4 * sum(  # noqa: E731
        int(getattr(ix, f).numel()) for f in ("row_ptr", "col", "t_ptr", "t_entry", "t_row"))

    def csr_of(rows_i, cols_i, vals, shape):
        return torch.sparse_coo_tensor(
            torch.as_tensor(np.stack([rows_i, cols_i]), device=dev),
            torch.as_tensor(vals.astype(np.float32), device=dev), shape).to_sparse_csr()

    blk_i, r_i, j_i = np.nonzero(bl.adj_cnt)
    vals = bl.adj_cnt[blk_i, r_i, j_i]
    csr = csr_of(blk_i * BLK + r_i, blk_i * BLK + j_i, vals, (n_pad, n_ext))
    csr_t = csr_of(blk_i * BLK + j_i, blk_i * BLK + r_i, vals, (n_ext, n_pad))
    rows = []
    for B in (bs, 8):
        for H, C in ((2, 128), (1, 128)):
            args = (randn(B, n_pad, H), randn(nB, B, W, H), randn(B, n_ext, H, C), mask)
            d_out = randn(B, n_pad, H, C)
            label = f"B{B} H{H} C{C}"
            held("band_attention", f"band_attention {label}", band_attention_fwd(*args, 0.2, mask_ix),
                 band_attention_plain(*args, 0.2))
            got = band_attention_bwd(*args, d_out, 0.2, mask_ix)
            ref = band_attention_bwd_plain(*args, d_out, 0.2)
            for part, g, r in zip(("d a_dst", "d a_src_win", "d x_ext"), got, ref):
                held("band_attention_bwd", f"band_attention_bwd {label} {part}", g, r)
            del got, ref
            # forward: a_src counted once per row of x_ext, not as its W-row windowed copy;
            # the mask's row lists (row_ptr, col) and the blocks' padded-row counts
            io = 4 * (B * n_pad * H + B * n_ext * H + B * n_ext * H * C + B * n_pad * H * C)
            rows.append(dict(
                name="band_attention", B=B, hc=H * C,
                ms=cuda_ms(lambda: band_attention_fwd(*args, 0.2, mask_ix), 3, 20),
                device_ms=device_ms(lambda: band_attention_fwd(*args, 0.2, mask_ix)),
                plain_ms=cuda_ms(lambda: band_attention_plain(*args, 0.2), 1, 3),
                # the flash forward on the same inputs: the other row-list walk
                flash_ms=cuda_ms(lambda: band_attention_flash_fwd(*args, 0.2, mask_ix), 3, 20),
                library_ms=None, bytes=io + 4 * (n_pad + 1 + nnz_mask + nB + 1),
                ops=B * H * nnz_mask * (2 * C + 4),  # FMA per channel; add, LeakyReLU, exp, sum
                dense_bound_ms=2 * B * n_pad * W * H * C / PEAK_F32_S * 1e3))
            if B == bs and H == 2:
                print("  band_attention B 32 H·C 256, device ms by pass: " + ", ".join(
                    f"{k} {ms:.4f}" for k, ms in
                    device_split(lambda: band_attention_fwd(*args, 0.2, mask_ix))))
            # backward: reads the forward's inputs and dO, writes the three
            # cotangents (d a_src_win is an output in window layout) and walks the index
            if B == bs and H == 2:
                print("  band_attention_bwd B 32 H·C 256, device ms by pass: " + ", ".join(
                    f"{k} {ms:.4f}" for k, ms in
                    device_split(lambda: band_attention_bwd(*args, d_out, 0.2, mask_ix))))
            rows.append(dict(
                name="band_attention_bwd", B=B, hc=H * C,
                ms=cuda_ms(lambda: band_attention_bwd(*args, d_out, 0.2, mask_ix), 3, 20),
                device_ms=device_ms(lambda: band_attention_bwd(*args, d_out, 0.2, mask_ix)),
                plain_ms=cuda_ms(lambda: band_attention_bwd_plain(*args, d_out, 0.2), 1, 3),
                library_ms=None,
                bytes=io + 4 * (B * n_pad * H + nB * B * W * H + B * n_ext * H * C)
                + index_bytes(mask_ix),
                ops=B * H * nnz_mask * (4 * C + 12),  # dot and weighted sum per channel; softmax, dz
                dense_bound_ms=6 * B * n_pad * W * H * C / PEAK_F32_S * 1e3))
            del args, d_out
        C = 128
        x_ext, d_out = randn(B, n_ext, C), randn(B, n_pad, C)
        held("band_spmm", f"band_spmm int8 B{B} C{C}", band_spmm_fwd(cnt, x_ext, cnt_ix),
             band_spmm_plain(cnt, x_ext))
        held("band_spmm_bwd", f"band_spmm_bwd int8 B{B} C{C}", band_spmm_bwd(cnt, d_out, cnt_ix),
             band_spmm_bwd_plain(cnt, d_out))
        # library yardstick: one CSR sparse-dense product over the same band
        # (forward) and over its transpose (backward); timed, never on the path
        x2d = x_ext.permute(1, 0, 2).reshape(n_ext, B * C).contiguous()
        d2d = d_out.permute(1, 0, 2).reshape(n_pad, B * C).contiguous()
        check_close(f"band_spmm B{B} vs torch.sparse.mm", band_spmm_fwd(cnt, x_ext, cnt_ix),
                    torch.sparse.mm(csr, x2d).reshape(n_pad, B, C).permute(1, 0, 2), TOL, TOL)
        check_close(f"band_spmm_bwd B{B} vs torch.sparse.mm", band_spmm_bwd(cnt, d_out, cnt_ix),
                    torch.sparse.mm(csr_t, d2d).reshape(n_ext, B, C).permute(1, 0, 2), TOL, TOL)
        io = 4 * (B * n_ext * C + B * n_pad * C)
        rows.append(dict(
            name="band_spmm", B=B, hc=C, ms=cuda_ms(lambda: band_spmm_fwd(cnt, x_ext, cnt_ix), 3, 20),
            device_ms=device_ms(lambda: band_spmm_fwd(cnt, x_ext, cnt_ix)),
            plain_ms=cuda_ms(lambda: band_spmm_plain(cnt, x_ext), 1, 3),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr, x2d), 3, 20),
            bytes=io + 4 * (n_pad + 1 + 2 * nnz_cnt), ops=2 * B * C * nnz_cnt,  # + row_ptr, col, val
            dense_bound_ms=2 * B * n_pad * W * C / PEAK_F32_S * 1e3))
        rows.append(dict(
            name="band_spmm_bwd", B=B, hc=C,
            ms=cuda_ms(lambda: band_spmm_bwd(cnt, d_out, cnt_ix), 3, 20),
            device_ms=device_ms(lambda: band_spmm_bwd(cnt, d_out, cnt_ix)),
            plain_ms=cuda_ms(lambda: band_spmm_bwd_plain(cnt, d_out), 1, 3),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr_t, d2d), 3, 20),
            bytes=io + 4 * (n_ext + 1 + 2 * nnz_cnt),       # + t_ptr, t_row, t_val
            ops=2 * B * C * nnz_cnt, dense_bound_ms=2 * B * n_pad * W * C / PEAK_F32_S * 1e3))
        del x_ext, d_out, x2d, d2d
    for r in rows:
        t_bytes, t_ops = r["bytes"] / PEAK_BYTES_S * 1e3, r["ops"] / PEAK_F32_S * 1e3
        r["bound_ms"], r["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        flash = f", flash forward on the same inputs {r['flash_ms']:.4f} ms" if "flash_ms" in r else ""
        dev_t = f" (device {r['device_ms']:.4f} ms)" if r.get("device_ms") else ""
        print(f"  {r['name']} B {r['B']} H·C {r['hc']}: kernel {r['ms']:.4f} ms{dev_t}, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; nonzeros; {r['bound_ms'] / r['ms']:.1%} of it reached), "
              f"dense-window bound {r['dense_bound_ms']:.4f} ms{flash}")
    torch.cuda.empty_cache()

    # ---- 7: training at full width ------------------------------------------
    print("[7] training: GATRes-large on bigtown through Trainer")
    tfx = np.load(os.path.join(REPO, "artifacts", "parity_train_bigtown.npz"))
    tstats = NormStats(norm_type="znorm", mean=float(tfx["stats_mean"]), std=float(tfx["stats_std"]))
    names = [k for k, _ in smodel.named_parameters()]
    per_step = counts(band_attention=50, band_spmm=25, band_attention_bwd=50, band_spmm_bwd=25)

    def fixture_trainer(batch_size, **kw):
        tmodel, preset = select_model("gatres_large", device=dev)
        tmodel.load_state_dict(params_from_parity_npz(npz))
        return Trainer(tmodel, preset.train_config(batch_size=batch_size, **kw), tstats, tpl,
                       device=dev)

    def one_step_grads(tr):
        graph1, x1, m1, k1 = tr._prepare(tpl, fx["x"][:, 0][None, :], tfx["mask"], None, None)
        tr.model.train()
        loss, mets, _ = tr._masked_loss_and_metrics(graph1, x1, x1, m1, k1, "train")
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        torch.cuda.synchronize()
        return float(loss.detach()), mets, grads

    # (a) one step at B 1 against the JAX Trainer's loss, gradients, parameters
    tr1 = fixture_trainer(1)
    reset_launches()
    loss1, mets1, grads1 = one_step_grads(tr1)
    step_launches = read_launches()
    if step_launches != per_step:
        raise SystemExit(f"FAIL launches per train step {step_launches}, expected {per_step}")
    if abs(loss1 - float(tfx["loss"])) > 1e-4 * abs(float(tfx["loss"])):
        raise SystemExit(f"FAIL train loss {loss1!r} against the fixture's {float(tfx['loss'])!r}")
    for k, v in mets1.items():
        ref = float(tfx[f"metric_{k}"])
        if abs(float(v) - ref) > 1e-3 * abs(ref) + 1e-4:
            raise SystemExit(f"FAIL train metric {k}: {float(v)!r} against {ref!r}")
    worst = grads_within("B 1 step vs JAX", names, grads1,
                         [torch.as_tensor(tfx[f"grad_{k}"], device=dev) for k in names])
    print(f"  B 1 step vs the JAX Trainer ({bytes(tfx['path']).decode()} band path): loss {loss1:.7f} "
          f"against {float(tfx['loss']):.7f}; {len(names)} gradients, each within "
          f"1e-3·max|g_ref| + 1e-6, the worst at {worst:.1%} of it; launches per step {step_launches}")
    losses3 = [float(tr1.train_step(tpl, fx["x"][:, 0][None, :], mask=tfx["mask"])[0])
               for _ in range(3)]
    # components whose gradient is rounding noise are held to 3 steps of 2·lr = 3e-3,
    # the others to 3e-4
    perr, pnoise = adam_param_errors(tr1.model.named_parameters(), tfx)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses3, tfx["step_losses"]))
    if perr > 3e-4 or pnoise > 3 * 2 * 5e-4 or lerr > 1e-3:
        raise SystemExit(f"FAIL after 3 Adam steps: parameters off by {perr:.3e} (atol 3e-4; "
                         f"{pnoise:.3e} where the gradient is noise, bound 3e-3), step losses by "
                         f"{lerr:.3e} relative (1e-3)")
    print(f"  3 Adam steps: losses {[round(v, 6) for v in losses3]}; lin0, lin1, blocks 0 and 24 "
          f"within {perr:.3e} of the JAX parameters ({pnoise:.3e} where the first gradient is "
          f"below its tolerance), step losses within {lerr:.3e} relative")

    # (b) the same step through the plain versions on the card
    tr1p = fixture_trainer(1)
    reset_launches()
    with bops.plain_versions():
        loss_p, _, grads_p = one_step_grads(tr1p)
    if any(read_launches().values()):
        raise SystemExit("FAIL the plain step launched a kernel")
    worst_p = grads_within("kernel step vs plain step", names, grads1, grads_p)
    print(f"  kernel step vs plain step on the card: loss {loss1:.7f} / {loss_p:.7f}, gradients "
          f"within the same bound, the worst at {worst_p:.1%} of it")
    del tr1, tr1p, grads1, grads_p
    torch.cuda.empty_cache()

    # (c) Trainer.fit: 2 epochs at batch 8, 32 + 16 snapshots in memory
    import tempfile

    tbs, n_train, n_val = 8, 32, 16
    field = fx["x"][:, 0][None, :]
    arr = (field + 0.1 * rng.standard_normal((n_train + n_val, n))).astype(np.float32)
    mk_ds = lambda a: WDNDataset.from_members([_Member(tpl, a, [], None)], tstats)  # noqa: E731
    epochs_log = []
    with tempfile.TemporaryDirectory() as save_dir:
        trn = fixture_trainer(tbs, epochs=2, save_path=save_dir)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        best = trn.fit(mk_ds(arr[:n_train]), mk_ds(arr[n_train:]), log_fn=lambda m: print("  " + m),
                       on_epoch_end=lambda ep, m: epochs_log.append(m))
        torch.cuda.synchronize()
        fit_launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_tr, n_ev = 2 * (n_train // tbs), 2 * (n_val // tbs)
        expect = counts(band_attention=50 * (n_tr + n_ev), band_spmm=25 * (n_tr + n_ev),
                        band_attention_bwd=50 * n_tr, band_spmm_bwd=25 * n_tr)
        if fit_launches != expect:
            raise SystemExit(f"FAIL fit launches {fit_launches}, expected {expect}")
        tl = [m["train_loss"] for m in epochs_log]
        vl = [m["val_loss"] for m in epochs_log]
        if len(tl) != 2 or not np.isfinite(tl + vl).all() or tl[1] >= 1.5 * tl[0]:
            raise SystemExit(f"FAIL fit diverged or stopped: train {tl}, val {vl}")
        for which in ("best", "last"):
            params, opt_state, meta = load_checkpoint(
                os.path.join(save_dir, f"{which}_gatres_large.ckpt"), trn.model.state_dict(),
                trn.opt_state_dict())
            if meta["stats"] != tstats or opt_state is None or meta["epoch"] not in (1, 2):
                raise SystemExit(f"FAIL the {which} checkpoint did not reload whole: {meta}")
        if meta["epoch"] != 2 or any(
                not torch.equal(params[k], v.cpu()) for k, v in trn.model.state_dict().items()):
            raise SystemExit("FAIL the last checkpoint does not hold the model's parameters")
    print(f"  fit: 2 epochs, batch {tbs}, {n_train} train + {n_val} val snapshots: train loss {tl}, "
          f"val loss {vl}, best epoch {best['epoch']}, {best['train_time_s']:.2f} s; launches "
          f"{fit_launches}; checkpoints written and reloaded")
    batch = arr[:tbs]
    tgen = torch.Generator().manual_seed(0)
    step_ms = cuda_ms(lambda: trn.train_step(tpl, batch, generator=tgen), 2, 8)
    peak_gb = max(peak_gb, torch.cuda.max_memory_allocated() / 1e9)
    print(f"  train step at batch {tbs}: {step_ms:.3f} ms ({tbs * tpl.n_edge / step_ms * 1e3:.0f} "
          f"edges/s), peak device memory {peak_gb:.3f} GB")
    profile_batch(lambda: trn.train_step(tpl, batch, generator=tgen), "one train step", top=14)

    replaces = {"band_attention": f"{TPU_SRC}:208", "band_spmm": f"{TPU_SRC}:1084",
                "band_attention_bwd": f"{TPU_SRC}:313", "band_spmm_bwd": f"{TPU_SRC}:1164"}
    del trn
    torch.cuda.empty_cache()
    dense = dense_phases(dev, card, rng, held, max_err, reset_launches, read_launches, counts)
    big = dict(tpl=tpl, npz=npz, x=fx["x"], tfx=tfx, mask=mask, mask_ix=mask_ix, ptxas=ptxas)
    mega = mega_phases(dev, card, rng, held, reset_launches, read_launches, counts, big)
    s5 = slice5_phases(dev, card, rng, held, reset_launches, read_launches, counts, big)
    s10 = dense_walk_phase(dev, card, held, reset_launches, read_launches, counts, ptxas)
    s11 = bf16_phases(dev, card, rng, held, max_err, reset_launches, read_launches, counts, big,
                      mega["tpl"])
    eval_phases(dev, card, reset_launches, read_launches, counts, npz)
    cli_phases(dev, card, reset_launches, read_launches, counts, npz)
    zoo = zoo_phases(dev, card, held, reset_launches, read_launches, counts)
    _NETS.setdefault("bigtown", tpl)
    mesh_kernel_phase(dev, held)
    mesh = mesh_phases(dev, card, big)
    knobs = knob_phases(dev, card, held, max_err, reset_launches, read_launches, counts, big)

    kernels = []
    for name in band_wrappers:
        # headline row: B 32 (band_attention*: the H·C 256 shape); the forwards
        # count the serving run's launches, the backwards the fit's
        r = next(r for r in rows if r["name"] == name and r["B"] == bs)
        at = lambda B, hc: next(  # noqa: E731
            q["ms"] for q in rows if q["name"] == name and q["B"] == B and q["hc"] == hc)
        launches = serve_launches.get(name, fit_launches[name])
        if not launches or not fit_launches[name]:
            raise SystemExit(f"FAIL {name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gnn_pressure_estimation_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches,
            "serving_launches": serve_launches.get(name, 0), "serving_batches": n_batches,
            "launches_per_forward": per_forward.get(name, 0),
            "fit_launches": fit_launches[name], "launches_per_train_step": step_launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dense_window_bound_ms": r["dense_bound_ms"],
            "shape": f"B {bs}, n_pad {n_pad}, W {W}, H·C {r['hc']}",
            "ms_b8": at(8, r["hc"]),
            **({"ms_hc128": at(bs, 128), "ms_b8_hc128": at(8, 128)} if r["hc"] != 128 else {}),
            **{k: r[k] for k in ("device_ms", "flash_ms") if r.get(k)},
            **({"ms_meganet_b8": mega["spmm_b8"]["ms"],
                "library_ms_meganet_b8": mega["spmm_b8"]["library_ms"],
                "bound_ms_meganet_b8": mega["spmm_b8"]["bound_ms"]} if name == "band_spmm" else {}),
            **({f"meganet_b{b}": mega["spmm_bwd"][b] for b in mega["spmm_bwd"]}
               if name == "band_spmm_bwd" else {}),
        })
    # the dense kernels: headline row H 2 (conv1 of GATRes-small: C 32, D 33); the
    # factored pair counts the synthctown serving and fit runs, the attention pair
    # the attn_impl="softmax" batch and step
    # the softmax pair and its bf16 instances count phase 12's serving batches and
    # train steps of GATRes-small and -large
    dense_replaces = {"fused_attention": ("fused_attention", 70),
                      "fused_attention_bwd": ("fused_attention_bwd", 82),
                      **DENSE_BF16_INSTANCES,
                      "fused_factored": ("fused_factored", 224),
                      "fused_factored_bwd": ("fused_factored_bwd", 240)}
    dense_launches = {"fused_factored": sum(dense["serve_launches"].values()),
                      "fused_factored_bwd": dense["fit_launches"]["fused_factored_bwd"],
                      **dense["soft_launches"]}
    soft_times = {p_: {"serve_ms_f32": dense["soft_serve_ms"][p_][None],
                       "serve_ms_bf16": dense["soft_serve_ms"][p_][torch.bfloat16],
                       "step_ms_f32": dense["soft_step_ms"][p_][None],
                       "step_ms_bf16": dense["soft_step_ms"][p_][torch.bfloat16]}
                  for p_ in dense["soft_serve_ms"]}
    for name, (src, line) in dense_replaces.items():
        shaped = {(r["H"], r["C"]): r for r in dense["rows"] if r["name"] == name}
        r = shaped[(2, 32)]
        if not dense_launches[name]:
            raise SystemExit(f"FAIL {name} was not launched on the dense path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gnn_pressure_estimation_tpu_torch/csrc/{src}.cu",
            "replaces": f"{TPU_DENSE_SRC}:{line}", "launches": dense_launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "device_ms": r["device_ms"], "einsum_ms": r["einsum_ms"],
            **({"bound_f32_v_ms": r["bound_f32_ms"],
                "min_gap_to_f32_in_max_ref": min(dense["dense_gaps"].values())}
               if "bound_f32_ms" in r else {}),
            **({"synthctown_b32_softmax_ms": soft_times} if name == "fused_attention" else {}),
            **({"launch_weighted_device_ms_small_step": dense["soft_dev"][name]}
               if name in dense["soft_dev"] else {}),
            "shape": f"B 32, n {dense['n']}, nonzeros {dense['nnz']}, H 2, C 32",
            "by_shape": {f"H{h} C{c}": {k: q[k] for k in ("ms", "device_ms", "plain_ms", "einsum_ms",
                                                          "bound_ms", "bound_f32_ms", "bytes")
                                        if k in q}
                         for (h, c), q in shaped.items()},
            **({} if not name.startswith("fused_factored") else {
                "walk_by_shape": {f"H{q['H']} C{q['C']}": {
                    k: q[k] for k in ("device_ms", "ms", "einsum_ms", "einsum_device_ms", "bound_ms")}
                    for q in s10["rows"] if q["name"] == name},
                "synthctown_b32_device_ms": {p: {k: w[k] for k in ("serve", "step")}
                                             for p, w in s10["walk"].items()}}),
        })
    # the flash pair: headline row meganet at the serving batch, H·C 256; the forward
    # counts the meganet serving run's launches, the backward the fit's. The window
    # pair: bigtown at B 32; the serving batch's and the B 1 step's launches
    new_kernels = {
        "band_attention_flash": (531, mega["serve_launches"], "meganet", mega["serve_batch"]),
        "band_attention_flash_bwd": (677, mega["fit_launches"], "meganet", mega["serve_batch"]),
        "band_attention_window": (47, mega["window_serve"], "bigtown", 32),
        "band_attention_window_bwd": (99, mega["window_step"], "bigtown", 32)}
    for name, (line, launched, net, B) in new_kernels.items():
        shaped = {(r["B"], r["hc"]): r for r in mega["rows"] if r["name"] == name}
        r = shaped[(B, 256)]
        if not launched[name]:
            raise SystemExit(f"FAIL {name} was not launched on its path")
        flash = net == "meganet"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gnn_pressure_estimation_tpu_torch/csrc/{name}.cu",
            "replaces": f"{TPU_SRC}:{line}", "launches": launched[name],
            "launches_per_forward": (mega["serve_launches"][name] // mega["serve_batches"]
                                     if flash else mega["window_serve"][name]),
            "launches_per_train_step": (mega["step_launches"] if flash else mega["window_step"])[name],
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "shape": f"{net}, B {B}, {mega['shape'] if flash else mega['window_shape']}, H·C 256",
            **({} if name != "band_attention_window" else {"bigtown_route_ms": {
                k: [{"serve_b32": a, "step_b8": b} for a, b in v]
                for k, v in mega["route_ms"].items()}}),
            **({"ms_b32": mega["ms_b32"][name]} if flash else {}),
            **({"device_ms": r["device_ms"], "v2_ms_same_inputs": r["v2_ms"],
                "bit_equal_to_band_attention_fwd_shapes": mega["window_fwd_equal"]}
               if name == "band_attention_window" else {}),
            **({"device_ms_b8": mega["window_b8"],
                "launch_weighted_device_ms_b8_step": step_device_ms(mega["window_b8"]),
                "d_a_bit_equal_to_band_attention_bwd": mega["window_da_equal"]}
               if name == "band_attention_window_bwd" else {}),
            # v2's kernel of the same direction on the same meganet B 8 inputs
            **({"v2_ms_same_inputs": {f"HC{hc}": t[name.endswith("_bwd")]
                                      for hc, t in mega["v2_ms"].items()}} if flash else {}),
            "by_shape": {f"B{b} HC{hc}": {k: q[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                          "bytes", "v2_ms", "v2_device_ms") if k in q}
                         for (b, hc), q in shaped.items()},
        })
    # the slice-5 kernels: the acc backward at the training batch, H·C 256, counting
    # path A's fit; the window gather pair at B 32, C 256, counting the drive on
    # path B's tables (no aggregation mode routes to it)
    s5_kernels = {
        "band_attention_acc_bwd": (f"{TPU_SRC}:1420", s5["acc_fit"], 8, s5["acc_shape"]),
        "window_gather": (f"{TPU_WG_SRC}:157", s5["drive"], 32, s5["gather_shape"][32]),
        "window_gather_bwd": (f"{TPU_WG_SRC}:260", s5["drive"], 32, s5["gather_shape"][32])}
    for name, (replaces, launched, B, shape) in s5_kernels.items():
        shaped = {(r["B"], r["hc"]): r for r in s5["rows"] if r["name"] == name}
        r = shaped[(B, 256)]
        if not launched[name]:
            raise SystemExit(f"FAIL {name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gnn_pressure_estimation_tpu_torch/csrc/"
                      f"{'window_gather' if name.startswith('window') else name}.cu",
            "replaces": replaces, "launches": launched[name],
            **({"launches_per_train_step": s5["acc_step"][name], "acc_route_step_ms": s5["route_step"],
                "device_ms_b8": s5["acc_b8"],
                "launch_weighted_device_ms_b8_step": step_device_ms(s5["acc_b8"])}
               if name == "band_attention_acc_bwd" else {}),
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": r["library"], "shape": f"{shape}, B {B}, C or H·C 256",
            "by_shape": {f"B{b} C{hc}": {k: q[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                                         "bound_ms", "bytes", "v2_ms", "v2_device_ms")
                                         if k in q}
                         for (b, hc), q in shaped.items()},
        })
    # the bf16-operand instances: headline rows as their f32 instances' (v2 bigtown B 32,
    # v3 B 8, v4 meganet at the serving batch), H·C 256; each counts the main path's
    # bf16 runs: the bigtown serving batches, the B 1 steps under "dma" and "acc",
    # the meganet serving batches and train step
    s11_launches = {"band_attention_bf16": s11["big_serve"]["band_attention_bf16"],
                    "band_attention_bwd_bf16": s11["step"]["dma"]["band_attention_bwd_bf16"],
                    "band_attention_acc_bwd_bf16": s11["step"]["acc"]["band_attention_acc_bwd_bf16"],
                    "band_attention_flash_bf16": s11["mega_serve"]["band_attention_flash_bf16"],
                    "band_attention_flash_bwd_bf16": s11["mega_step"]["band_attention_flash_bwd_bf16"]}
    headline = {"band_attention_bf16": 32, "band_attention_bwd_bf16": 32,
                "band_attention_acc_bwd_bf16": 8, "band_attention_flash_bf16": 8,
                "band_attention_flash_bwd_bf16": 8}
    for name, (src, line) in BF16_INSTANCES.items():
        shaped = {(r["B"], r["hc"]): r for r in s11["rows"] if r["name"] == name}
        r = shaped[(headline[name], 256)]
        if not s11_launches[name]:
            raise SystemExit(f"FAIL {name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": f"gnn_pressure_estimation_tpu_torch/csrc/{src}.cu",
            "replaces": f"{TPU_SRC}:{line}", "launches": s11_launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "f32_ms": r["f32_ms"], "device_ms": r["device_ms"],
            "gap_to_f32_in_1e-3_max_ref": s11["gaps"][name],
            "shape": f"{r['net']}, B {r['B']}, H·C 256",
            **({"step_trace_bigtown_b8": s11["traces"]["bigtown_b8"]}
               if name == "band_attention_bwd_bf16" else {}),
            **({"step_trace_meganet_b2": s11["traces"]["meganet_b2"],
                "step_peak_gb_meganet_b2": s11["mega_peak_gb"]}
               if name == "band_attention_flash_bwd_bf16" else {}),
            "by_shape": {f"B{b} HC{hc}": {k: q[k] for k in ("ms", "f32_ms", "device_ms", "plain_ms",
                                                           "bound_ms", "bytes")}
                         for (b, hc), q in shaped.items()},
        })
    # the zoo's main path (phases 38-42) launches the band pair, v2 and the dense softmax
    # forward at new shapes; the band SpMM's times at the zoo's widths (phase 37)
    for k in kernels:
        if k["name"] in zoo["zoo_launches"]:
            if not zoo["zoo_launches"][k["name"]]:
                raise SystemExit(f"FAIL {k['name']} was not launched on the zoo's path")
            k["zoo_launches"] = zoo["zoo_launches"][k["name"]]
        if k["name"] in ("band_spmm", "band_spmm_bwd"):
            pre = "bwd_" if k["name"].endswith("_bwd") else ""
            k["zoo_by_width_b32"] = {
                f"C{C}": {"ms": w[f"{pre}ms"], "device_ms": w[f"{pre}device_ms"],
                          "plain_ms": w[f"{pre}plain_ms"], "library_ms": w[f"{pre}library_ms"],
                          "bound_ms": w[f"{pre}bound_ms"], "packed_loads": w["vector_loads"]}
                for C, w in zoo["widths"].items()}
    # the parallel strategies' paths (phases 44-49) launch every band kernel and the
    # factored pair on the ranks: each rank's counts, summed
    for k in kernels:
        if k["name"] in MESH_KERNELS:
            if not mesh["launches"].get(k["name"]):
                raise SystemExit(f"FAIL {k['name']} was not launched on the mesh's path")
            k["mesh_launches"] = mesh["launches"][k["name"]]
    # the logit-rounding instances: headline rows GATRes-small's conv1 width (v2 at
    # bigtown B 32 forward, B 8 backward; the dense pair at synthctown B 32) and
    # GATRes-large's conv1 on the window route at B 8; each counts phases 51-55
    headline = {"band_attention_logit": (32, 64), "band_attention_bwd_logit": (8, 64),
                "fused_attention_logit": (32, 64), "fused_attention_bwd_logit": (32, 64),
                "band_attention_window_logit": (8, 256)}
    for name, (src, tpu, line) in LOGIT_INSTANCES.items():
        shaped = {(r["B"], r["hc"]): r for r in knobs["rows"] if r["name"] == name}
        r = shaped[headline[name]]
        if not knobs["launches"][name]:
            raise SystemExit(f"FAIL {name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": f"gnn_pressure_estimation_tpu_torch/csrc/{src}.cu",
            "replaces": f"{tpu}:{line}", "launches": knobs["launches"][name],
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "device_ms": r["device_ms"], "shape": f"B {r['B']}, H·C {r['hc']}",
            "by_shape": {f"B{b} HC{hc}": {k: q[k] for k in ("ms", "device_ms", "plain_ms",
                                                           "bound_ms", "bytes")}
                         for (b, hc), q in shaped.items()},
        })
    # the knobs' paths (phases 51-55) launch the band pair, the factored pair and v2
    for k in kernels:
        if knobs["new_path"].get(k["name"]):
            k["knob_launches"] = knobs["new_path"][k["name"]]
    print("  phases 51-55: " + json.dumps({k: knobs[k] for k in (
        "synthctown", "bigtown_small", "band_factored", "gemm", "precision", "fit_fast",
        "dense_turns", "bigtown_small_turns")}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
