"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Runs from the root of a checkout and imports only ``crane_scheduler_tpu_torch``.
Each phase prints one line; a failed phase raises, and the script exits
non-zero without printing a result.

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: the three CUDA kernels from ``crane_scheduler_tpu_torch/csrc``, one
   ``nvcc`` each, started together, and beside them the host library
   (``native/lib.py``: ``crane_native.cpp`` and ``crane_pylist.cpp`` with the
   host C++ compiler, one each); the line names the compiler and the
   build seconds;
3. K1 (fused filter+score) against its plain PyTorch version on the card,
   exact equality: 51,200 nodes with the default policy (fresh, stale,
   missing, negative and NaN entries) at `now` = 0 and 31 s, three
   pathological policies, a policy at the kernel's maximum entry count,
   and ragged node counts (50,001, 257, 1); a policy above the maximum
   must raise. Then the kernel's own device time per launch;
4. K2 (gang level totals) against its plain version, exact equality:
   plain mode (w = 1, no offsets) and combined mode (w = 3, max_offset =
   220, capacities, offsets, prior), each also at ragged node counts and
   with every node on one score; a level count above the kernel's
   shared-memory histogram must raise. Then the kernel's own device time
   per launch in both modes;
4b. K3 (the drip window's step, ``drip_step.drip_window``) at 65,000
   nodes, K = 128, plain and with two zone columns: the kernel's own
   device us per step (``torch.profiler``), its least time per step, the
   host ms to enqueue one eager window of 128 launches, the device ms of
   one window replayed from a captured CUDA graph, and the PyTorch
   window's ms on the card (CUDA events); its equality is phase 11;
5. the main path: a 50,000-node ``ClusterState`` with fresh annotations,
   ``BatchScheduler(dtype=torch.float32)`` (hybrid f64 rescue rows) through
   eleven ``schedule_pod_burst`` calls of 100,000 pods with the clock moving
   between them, then a depth-4 ``schedule_bursts_pipelined`` run. Every
   burst passes ``check_placement_parity`` (exact f64 verdicts, scores and
   water-filling counts); placements equal a float64 twin scheduler's on
   a twin cluster; both kernels' launch counts over the run are > 0. The
   line carries each burst's wall ms and host ms per stage;
6. profile: one more warm burst under ``torch.profiler`` for the device's
   busy time, idle share and each kernel's device time;
7. delta_path: a fresh ``BatchScheduler(dtype=torch.float32)`` on the same
   cluster, over the main path's clock range (so the unpatched rows'
   timestamps stay far from expiry, as on the hit path), takes one cold
   burst, then one warm 100,000-pod burst after each
   of ten ``patch_node_annotations_bulk`` calls over 500 seeded-random
   nodes (1%, new values stamped at that burst's clock). Ten bursts must
   take the delta path and one the full path; every burst passes
   ``check_placement_parity``; scores, verdicts and placements equal a
   second scheduler's full prepare of the same cluster at the same `now`.
   The line carries the prepare ms of the delta bursts beside the full
   prepare and the main path's hit-path median, the rescanned rows and
   kernel launches per burst, and the device time of one delta upload and
   scatter (``torch.profiler``);
8. column_path: a direct-mode store (``BatchScheduler(store=...,
   refresh_from_cluster=False)``) takes, before each of ten bursts, one
   annotator-shaped sweep: one ``bulk_set_by_name`` per metric over all
   50,000 names (the same list object each time, one shared timestamp, hot
   values with the first metric), one sweep leaving two nodes out of one
   metric. Ten bursts must take the column path; the same parity and
   identity checks as the delta path;
9. overlap: the depth-4 pipelined run of 4 x 25,000 pods, once blocking and
   once with ``overlap_refresh`` and ``overlap_bind``, annotations static:
   identical placements, every result settled when the generator is
   consumed; overlap hits, bind-flush windows and wall ms per burst of both
   (no claim goes with them);
10. hybrid_scorer: ``HybridScorer`` over the 50,000-node snapshot equals
   ``BatchedScorer(torch.float64)`` exactly;
11. drip_window: the drip path's window on the card, K3, equals the
   PyTorch window (``_drip_batch``, ``_drip_batch_numa``) on CPU tensors,
   exactly (every int64 output and the folded carries), K = 128, with the
   tie count on and off: at 50,000, 50,001 and 257 nodes over random
   inputs, no schedulable row, all rows at one weight (the first pod's
   winner must be the first maximum) and padded rows and pods; at 65,000
   nodes plain and with two zone columns, 257 nodes with four zones and
   one node with one. One window runs under
   ``torch.cuda.set_sync_debug_mode("error")``, so a host synchronisation
   inside it fails. Then the median host ms of ten
   ``DripBatchKernel.dispatch`` calls with the carry kept, every window
   through K3;
12. drip_queue: 50,000 nodes from seed 0 with the default policy's
   annotations and allocatable {cpu 16, memory 64Gi, ephemeral-storage
   100Gi, pods 110}, ``ResourceFitPlugin`` weight 1 and ``DynamicPlugin``
   weight 3 on a fixed clock. One window of infeasible pods warms it; then
   ``schedule_queue`` (window 128) places 4,096 pods of 100m cpu and 128Mi,
   equal pod for pod to a twin cluster's per-pod columnar ``schedule_one``;
   every pod binds and folds, no fallback, and the best nodes fill to their
   110-pod cap; K3 launched and every window ran it (``kernel_windows``
   == ``dispatches``, replays included). The line carries ms per pod,
   windows, uploads, and the device busy and idle share of one more
   profiled window;
13. drip_serve: the same storm through ``open_queue(window=32)``, one
   ``offer`` per pod after 16 infeasible ones, the half-full tail dispatched
   by ``drain``; placements equal drip_queue's; every window ran K3;
14. drip_scalar: at 2,000 nodes and 64 pods, the scalar plugin loop
   (``columnar=False``) and ``schedule_queue`` on a scheduler from
   ``build_scheduler_from_config`` place alike, unseeded and with a seeded
   tie-break, where windows with ties replay per-pod (``replays > 0``) and
   consume the seeded RNG as the scalar loop does;
15. telemetry: the burst path at full width (50,000 nodes, 100,000-pod
   bursts, ``dtype=torch.float32``) on two schedulers over one cluster and
   one clock, one with ``Telemetry()`` and one without, eleven bursts each
   (one cold, ten warm), interleaved. Every burst passes
   ``check_placement_parity`` and both place alike; the span trace holds the
   burst's stages, the exposition parses in both formats, the registry's
   ``crane_refresh_path_total`` equals ``refresh_stats``, and each burst
   left one decision trace. Three more traced bursts run under
   ``utils.profiling.torch_trace`` and ``chrome_trace`` (written under
   ``crane_scheduler_tpu_torch/_build/telemetry/``), and the device trace
   must hold both kernels (the profiler may drop a session's first device
   records). Then the drip storm of drip_queue with
   ``Telemetry(decision_sample_every=128)`` and without, each on its own
   cluster: both place as drip_queue did, the registry counts 4,096
   scheduled decisions and one window observation per dispatched window;
   the storm again with decision traces sampled out, and the time of one
   drip decision's build; then one window traced at a stride of 1 (every pod's decision, with its
   top-5 over the feasible nodes) runs under
   ``torch.cuda.set_sync_debug_mode("error")``, beside an untraced window.
   The line carries the median warm burst and ms per pod with telemetry on
   and off;
16. drip_dirty: drip_queue's storm (counters on, decision traces sampled
   out) with one ``patch_node_annotation`` every 8 windows on the node the
   last pod went to (a low usage value, so it stays schedulable): equal pod
   for pod to a twin's per-pod ``schedule_one`` with the same patches
   before the same pods; no identity sweep after the warm-up window,
   ``dirty_patches`` and ``dirty_rows`` equal to the patch count,
   ``crane_dirty_rows_total{consumer="drip"}`` above 0, and after each patch
   the window's column cache scatters the two dynamic columns and uploads
   nothing. The line carries ms per pod beside drip_queue's;
17. gang_queue: config 22 at 50,000 nodes (8 annotation variants, the drip
   allocatable, 24 gangs cycling six request shapes, 224 pods, Dynamic
   weight 3, topology weight 2). A sequential ``schedule_gang(bind=True)``
   loop on a ``BatchScheduler(dtype=torch.float32)`` launches K1 and K2 once
   per gang; on a twin cluster, one warm-up window of 8 infeasible gangs,
   then ``schedule_gang_queue(window=8)`` over the same gangs launches K2
   once per gang, with no fallback and every outcome from a window. Every
   pod is placed, node for node the same across the sequential loop, the
   window, ``gang_window_host`` and the window's plain version on CPU
   tensors over the engine's own columns (capacity un-folded by hand), and
   ``gang_assign_oracle`` for the first two gangs. Then one named patch's
   ``ensure()`` (journal, ``dirty_patches`` + 1) against the same patch
   after ``forget_dirty_names()`` (the identity sweep); one more window
   under ``torch.cuda.set_sync_debug_mode("error")`` and one under
   ``torch.profiler`` (device kernels, launches and busy us per window, idle
   share, K2 launches per gang); and one ``schedule_batch_mixed`` burst of
   the 224 pods as pending pods, float32 hybrid equal to float64. The line
   carries ms per gang of each leg, dispatch host ms per window,
   ``kernel_dispatches``, ``free_uploads`` and both ``ensure()`` times.
   (Clusters are built with ``add_node``; config 22's wire leg is in
   ``kube``.)
18. numa_gang: config 22's cluster at 50,000 nodes with one NRT CR per
   node (two zones of 8 cores, 32Gi and 50Gi; CPU policy ``None`` on
   ``i % 50 == 3``, node-aware on ``i % 4 == 0``, no CR on ``i % 100 ==
   7``) and one bound background pod per node holding a seeded topology
   result (0-8 cores, zone 0 overcommitted on ``i % 200 == 11``). 7 gangs
   of guaranteed pods (46 pods: the six request classes, 1000-8000 milli
   with awareness by ``numa_awareness``, then the first again) through
   ``schedule_gang(topology=, bind=True)`` on a
   ``BatchScheduler(dtype=torch.float32)``: K1 and K2 once per gang, K2
   with the NUMA offsets and copy capacity. On the repeated class's gangs
   a second scheduler's incremental NUMA vectors equal a fresh full build
   (both evaluate on the card). The run equals a CPU twin
   (``device="cpu"``, this script's ``--numa-twin`` child mode, run
   meanwhile) in placements, unassigned keys, topology-result annotations
   and assume-cache contents; ``schedule_gang_queue(topology=)`` equals it
   with every outcome a fallback; a ``schedule_batch_mixed`` burst of the
   46 pods as pending pods plus 64 best-effort pods gives f32 == f64 (the
   f64 burst in the same child mode, on the card, run meanwhile);
   ``evaluate_topology_batch`` and ``copies_capacity`` on the card equal
   their CPU runs at 50,000 x 2 and on random nodes at Z 4 and 8 (whole-
   core, off-by-one-milli and overcommitted zones); and a per-pod
   ``Scheduler`` from ``build_scheduler_from_config`` with Dynamic x3 and
   NodeResourceTopologyMatch x2 at 2,000 nodes places 8 pods alike on
   the card and on a CPU twin. The line carries ms per gang with its
   stages (full vector builds, incremental ms and rows, bind, step), K1
   and K2 launches per gang, and the device us of one batched evaluation
   plus copy-capacity call at 50,000 x 2.
19. service: the scoring sidecar (``service.ScoringService``) over the
   drip phases' 50,000-node cluster with the default policy. score: at 5
   explicit `now`s the card's ``/v1/score`` bodies equal a CPU twin's
   (``device="cpu"``) byte for byte, in float32 and float64, and a broken
   scorer on the card raises rather than answer from the oracle. miss: 20
   cache-miss renders per dtype (``now_bucket_s=0``), host ms each, the
   pieces timed from outside (snapshot, scorer call with H2D, K1 and both
   D2H copies, the two dicts, ``json.dumps``), and five renders per dtype
   under ``torch.profiler`` (device us and idle share) in a child process
   of this script (``--profile-renders``): late in this process a short
   session keeps no device record. serve:
   ``ScoringHTTPServer`` (async front end) under 8 closed-loop keep-alive
   clients for 3 s per dtype on a clock moving from ``NOW`` (bench config
   10's shape): req/s, p50/p99 ms, coalesced, cache hits, renders, one K1
   launch per float32 render; then a cold render, a cache hit and a
   6-thread storm give one body. assign: ``POST /v1/assign`` of 100,000
   pods, 5 calls without and 5 with a 50,000-entry capacity map, each
   equal to the CPU twin's ``assign_batch`` (counts, unassigned,
   waterline), one K1 and one K2 launch per call. cli: ``python3 -m
   crane_scheduler_tpu_torch.cli.service_main --f32`` as a subprocess
   answers ``/healthz``, ``/v1/score`` from the card and a strictly
   parsed ``/metrics`` with no fallback and ``crane_build_info{role=
   "scorer"}``, and exits 0 on SIGTERM. Every answer must say
   ``"backend": "cuda"`` and every service ``fallbacks == 0``.
20. replicated: bench config 19's shape, the metrics-sync plane feeding the
   replicated tier: a 50,000-node ``sim.Simulator`` primary (seed 0,
   default policy), float32 scoring, 4 ``ServingReplica``s fed over the
   delta feed, the hash router. annotator: ``sync_all_once`` (300,000
   per-node syncs) and ``sync_all_once_bulk`` ms per sweep, one column's
   render ms, and a direct-mode sweep whose store rows must equal a store
   refreshed from the annotations it emitted. sim: a CPU twin
   (``device="cpu"``) from the same seed; 1 closed-loop step of a bulk
   sweep, one 10,000-pod ``build_batch_scheduler(dtype=torch.float32)``
   burst on the card, its binds, bind events and hot values: placements
   and every node's annotation strings equal the twin's, K1 and K2 once
   per burst (host stage ms per burst); then 256 pods through
   ``build_scheduler()`` equal the twin's. replicas: the primary renders
   in replica mode over the published version; at a quiesced fence 5
   explicit `now`s give one byte string from the primary and each
   replica, stamped with the version, equal to a CPU twin replica's; 8
   windows of a 1% named patch (500 nodes) and one of a full annotator
   sweep (publish ms, frame bytes, catch-up ms to every replica; every lag
   sample within 64 versions, no gap); one replica's feed stopped and
   resumed inside the ring (3 windows replayed, no snapshot) and past it
   (34 windows, one snapshot); identity again after each. storm (report
   only): 8 closed-loop clients, one tenant each, unique `now`s, 3 s
   through a 1-replica and then the 4-replica router: req/s, p50/p99,
   sheds, per-replica counts strict-parsed from the router's /metrics
   (every replica served); K1 launches equal the card renders. assign:
   ``/v1/assign`` of 100,000 pods through the router equals the twin's
   ``assign_batch``, one K1 and one K2 per call. cli: ``crane-scorer
   --demo-nodes 2000 --replicas 2 --f32`` answers a score through its
   router from the card and exits 0 on SIGTERM (its own launch counts from
   its exit line), crane-annotator one pass over a 1,000-node JSON file
   with its score check on the card, crane-sim one 4,000-pod burst on
   the card. native: the annotator's heap is the C++ ``NativeBindingRecords``
   and the simulator serves three columns (hosts, strings, floats); a Python
   ``BindingRecords`` fed the sim legs' binding stream beside it
   (``HeapTee``) has equal sizes and per-node counts in every hot-value
   window; one column's ``bulk_render_f5`` equals ``format_metric_value``
   and its Go parse, with both timed.
21. desched: bench config 11's closed loop widened to 50,000 nodes on the
   in-memory ``ClusterState`` (2 hot nodes with 12 one-CPU workers, a
   DaemonSet and a kube-system decoy each; 49,998 nodes with one one-CPU
   pod; allocatable cpu 16, pods 110). ``LoadAwareDescheduler`` with a
   ``cpu_usage_avg_5m`` watermark (target 0.32, threshold 0.35), 2
   consecutive syncs, at most 2 evictions per node and 4 per cycle, no
   cooldown; 8 cycles of 60 s (config 11 runs 12; the hot nodes are
   drained by cycle 5), each writing the six metrics from pod
   requests (``patch_node_annotations_bulk``), then ``sync_once``, then
   the evictees re-placed with ResourceFit x1 and Dynamic x3. Three legs:
   no descheduler; re-placement through the drip window on the card
   (``schedule_queue``, window 4); and a CPU twin (``schedule_one``,
   ``device="cpu"``). The card leg's cycle reports and re-placement nodes
   equal the twin's; no DaemonSet or kube-system victim, both budgets in
   every cycle, requested cpu conserved, every evictee re-placed, and the
   imbalance (max / mean requested cpu) down by at least 2x against the
   no-descheduler leg. The line carries the annotate, ``sync_once`` and
   re-placement ms per cycle and one profiled window's device kernels and
   launch calls; neither K1 nor K2 may launch on the card leg;
22. front_doors: crane-scheduler (``cli/scheduler_main.py``) in sim mode at
   50,000 demo nodes, in-process on the card: batch (20,000 pods in
   bursts of 10,000), plugin (128 pods) and the NUMA profile in plugin
   mode (32 pods); each result line equals the same flags with
   ``--device cpu`` run as a subprocess meanwhile (this script's
   ``--scheduler-twin`` child mode), apart from ``wall_seconds``, and so
   does the digest of every sorted (pod, node) placement of the run's
   simulation; float64 batch scoring launches no K1 and one K2 per
   burst, plugin modes neither. crane-descheduler
   (``cli/descheduler_main.py``) runs as a subprocess at 50,000 demo nodes
   in dry-run for 8 s, its ``/metrics`` scraped once mid-run and the
   ``crane_desched_*`` families strictly parsed; it exits 0 with its stats
   line;
23. storm: bench config 17's shape at 50,000 nodes: a ``Simulator`` (seed
   17) after one annotator pass, a float32 ``ScoringService``
   (``now_bucket_s=0``) on the card behind the async front end with a
   gradient limiter (min 2, max 4), tenant queues of depth 2, brownout and
   a 5 s idle reaper. 6 warm requests, 40 sequential ones (the unloaded
   p99), a 0.8 s closed-loop peak with 4 workers, then a seeded open-loop
   ``StormSchedule`` at 3x peak (at most 1.5 s and 600 requests, 10 s
   deadlines) through ``run_open_loop`` with a ``/healthz`` prober every
   50 ms, the deadline leg (budgets -1 and 0.001 ms) and two
   ``replay_admission`` runs. No transport error; accepted plus shed
   equals sent; every probe 200; no expired request at dispatch; budget
   -1 answers 504; equal replays; every accepted body from the card, no
   fallback; K1 launches equal the service's renders. Goodput as a share
   of peak and the accepted p99 against twice the unloaded p99 plus 50 ms
   are reported beside config 17's gates, not held to them.
24. kube: the kube mirror (``cluster.kube.KubeClusterClient``) over
   ``tests/kube_stub.py``, each stub in its own process
   (``KubeStubSubprocess``). read (bench config 9's shape): 50,000 nodes
   with the 12 metrics of ``deploy/dynamic/policy-12metrics.yaml`` and
   allocatable {cpu 16, memory 64Gi, ephemeral-storage 100Gi, pods 110},
   pages of 2,000: the bootstrap (its node pages and decode ms), the mirror
   equal to the stub node for node; the first ``BatchScheduler.refresh()``
   through the columnar branch equal (store rows) to a ``list_nodes`` sweep
   into a second store; a forced relist; a 20,000-event node MODIFIED storm
   (events/s, mirror transactions; the mirror equal to the stub after it);
   a relist; a 1% ``patch_node_annotations_bulk`` over the wire (500 nodes)
   and the refresh through ``dirty_ingest``, again equal to a sweep.
   Its native step: every bootstrap page decoded by the host library's
   object decoder (``pylist``); the node pages fetched again and decoded by
   the object decoder, the columnar scanner and the Python twin, equal
   model for model, each timed; resourceVersion reuse over those pages
   without their allocatable maps (every row a marker, equal to a fresh
   decode); every node batch of the watch storm decoded by
   ``decode_watch_lines`` and equal to the per-line route; the codec over
   the mirror's 600,000 metric strings equal to the numpy twin; every bulk
   flush of 128 or more on the flush engine. burst: on that stub, two float32 ``schedule_pod_burst`` of 10,000 pods
   (creation POSTs, K1 and K2, binding POSTs) equal to a ``device="cpu"``
   ``BatchScheduler`` over an in-memory cluster with the mirror's nodes, the
   same `now` and pod names; ``bind_posts`` equal to the pods placed, no
   duplicate bind, every pod tracked to its lifecycle ``watch_confirm``, K1
   and K2 once per burst; every creation and binding batch on the flush
   engine, none of 128 or more on the Python pipeline, and the 20,000 pods'
   LIST pages decoded three ways, equal. drip (config 15 over the wire): a fresh
   50,000-node stub, 4,096 pods created with ``add_pod``,
   ``schedule_queue(window=128)`` on ``Scheduler(client, columnar=True)``
   (ResourceFit x1, Dynamic x3) equal to the same queue on an in-memory
   cluster on the card; 4,096 binding POSTs, no duplicate, K1 and K2 0. gang
   (config 22's wire leg): 5,000 nodes, 24 gangs (224 pods),
   ``schedule_gang_queue(window=8)`` equal to the in-memory queue; 224
   binding POSTs, K2 once per gang. cli: a 5,000-node stub with fresh
   annotations and 1,024 pending pods: crane-scorer ``--master --f32`` on
   the card and on ``--device cpu`` (subprocesses) answer one ``/v1/score``
   with equal bytes (``stalenessSeconds`` aside), one K1 launch;
   crane-scheduler ``--master --batch-size 256`` in-process on the card
   equals its ``--device cpu`` twin (this script's ``--kube-scheduler-twin``
   child mode, on its own identically seeded stub) in result line and the
   sha256 of the stub's sorted (pod, node) bindings; K2 once per batch, no
   K1.
25. control: the control plane on the kube mirror. oneshot: crane-scheduler
   ``--master --journal-dir --batch-size 256`` in-process on the card over
   a 5,000-node stub with fresh annotations and 1,024 pending pods, after a
   hand-written orphan bind intent for one of them: the recovery report is
   ``{"unbound_reschedulable": 1}``, every pod is bound once, K2 once per
   batch, result line and bindings digest equal to a ``--device cpu`` twin
   (this script's ``--kube-scheduler-twin`` child mode with the same flags
   and its own orphan). serve: a 50,000-node stub (config 15's
   allocatable, fresh annotations) with 2,048 pending 100m pods seeded
   before ``crane_scheduler_tpu_torch.cli.scheduler_main --master --serve
   --window 32 --journal-dir`` starts on the card as a subprocess (this
   script's ``--cli-child`` mode: the CLI's ``main`` in a process of its
   own, which prints its kernel launches and its drip windows by device at
   exit); SIGTERM once all are bound; one POST per pod, every intent acked
   or tombstoned, drip windows on the card only, result line and digest
   equal to a ``--device cpu`` twin on its own identically seeded stub
   (``--serve-twin``, started with the phase); pods/s and ms per pod from
   the first to the last bind. sigterm: on that stub, 2,048 more pods created while the
   serve runs, SIGTERM after 512 binds, a restart on the same journal:
   ``drained_at_exit`` and the restart's ``recovery`` reported, no
   duplicate or lost bind. kill: config 16's kill sites against an
   in-process 50,000-node stub (8 seeded mid-pipeline-fill kills with
   ``KillSwitch`` and ``SimulatedCrash``, a half-filled drip window
   abandoned on the card, an eviction whose response is lost; the re-armed
   cooldown), run twice with one seed: no duplicate or lost bind, no
   duplicate eviction, one timeline. standby: two ``--serve --lock-file``
   processes over 2,048 more pods, the leader SIGKILLed after half bind,
   the standby reconciles and binds the rest: its ``failover_seconds``
   beside config 16's 5 s gate (report only), no duplicate or lost bind.
   descheduler: ``crane_scheduler_tpu_torch.cli.descheduler_main --master
   --journal-dir --leader-elect`` as a subprocess over config 11's world at
   50,000 nodes on an in-process stub (one consecutive sync, 2 evictions per
   node, 4 per cycle, a 300 s cooldown): 4 evictions, no DaemonSet or
   kube-system victim, no duplicate, the Lease held, the journal closed
   (the descheduler has no device, so no twin); meanwhile the two-life indeterminate eviction
   (life 1: no eviction counted, ``unresolved``; life 2: ``evict_unapplied``,
   the cooldown re-armed, no eviction POST). chaos: config 12's scripted
   outage (6 nodes, 24 steps, outage 4 -> heal 16) and one generated plan
   (seed 12) through the port's breaker, degraded controller, descheduler
   and a scheduler on the card: no duplicate POST, no eviction while
   degraded, the mirror converged and health green after the heal.
26. shards: the shard plane. columns: config 18's 250,000-node mirror (cut
   from config 21's 1,000,000) under ``HashRing(4, vnodes=64)``, one drip
   scheduler per shard on the card: each shard's first probe builds its
   columns; one named patch on a shard-0 node; on the re-probe only shard
   0 patches, one row, and its columns equal a from-scratch build; then a
   one-token and an eight-token ring move (ms per moved name), every
   shard's columns equal a fresh build and its view its ring ownership.
   scaling: 1, 2 and 4 schedulers over disjoint crc shards, 3 storms of
   512 pods, window 128, threaded on the card: the median storm's pods/s
   beside config 18's 1.8x / 3x
   gates (report only: one card, one interpreter), every pod inside its
   shard, placements equal to the same plane on CPU tensors with
   ``threaded=False``. conflict: 2 schedulers, overlap 0.25, over a
   4,000-node stub, 800 pods: the conflict rate beside config 18's 5%, one
   POST per pod. wire: two ``--serve --shards 2 --shard-index {0,1}
   --shard-ring`` processes over the control phase's 50,000-node stub and
   4,096 new pods, a ring move written after 1,024 binds: both adopt it,
   every pod bound once, drip windows on the card only.
27. mesh: the node mesh on one card (tiles repeat cuda:0, the counterpart
   of XLA's virtual devices). step: ``ShardedScheduleStep`` on 4 tiles and
   on a 1-tile mesh at 51,200 rows, 100,000 pods, f64 and f32 hybrid,
   plain and combined (``tests/distributed_worker.py``'s capacities and
   offsets): packed words equal ``ScheduleStep`` on the card and a 4-tile
   CPU twin, K1 (f32) and K2 once per tile, CUDA-event ms per step tiled
   against single. burst: ``BatchScheduler(mesh=4 tiles)``: a cold, 3 hit
   and a delta burst (1% re-annotated), then a direct-mode column burst,
   placements and ``refresh_stats`` equal a mesh-free twin's. drip:
   ``DripBatchKernel(mesh=4 tiles)`` over 1,024 pods in windows of 128 at
   50,000 nodes, with and without the tie count, the carry kept, the mesh
   repartitioned 4 -> 2 -> 1 mid-stream: every window equal to the
   single-device window and the host's scalar loop; then
   ``Scheduler(mesh=).schedule_queue`` == a mesh-free ``Scheduler``.
   config18: ``tests/test_sharded_drip.py``'s kernel fuzz and seeded tie
   replay on an 8-tile mesh, and ``ShardedPlacementPlane(mesh=,
   threaded=False)`` == the plane without. distributed: an NCCL world of
   one (4 tiles, the combines as NCCL all-reduces) == the step; two
   processes on cuda:0 over gloo (this script's ``--mesh-rank`` mode),
   each owning half of 51,200 nodes: both ranks' packed words == the
   single-process step's, f64 and f32 hybrid. cli: crane-sim ``--mode
   sharded --devices 1`` == ``--device cpu``; crane-scheduler ``--master
   --placement-mesh 1`` one shot over the 5,000-node stub == its
   ``--device cpu`` twin, ``--placement-mesh 2`` fails with ``requested 2
   devices, only 1 available``; crane-scorer with the three distributed
   flags serves the plain run's ``/v1/score`` body. Paths ``mesh_*``.

Before each path (main path, delta, column, overlap, hybrid scorer, the
drip queue, serve, scalar and dirty phases, telemetry, the gang
sequential, window and mixed legs, the NUMA gang, queue, mixed and
per-pod legs, the service's score, HTTP and assign legs, the
replicated phase's sim, replicas and router-assign legs, the descheduler's
card leg, each crane-scheduler run, the storm, and the kube phase's
burst, drip, gang and crane-scheduler legs, and each leg of the control
and shards phases) the kernels' launch counters are set to 0, and after
it each kernel the path runs must have launched; the ``kernels`` line
lists the counts per path (the drip paths, the per-pod NUMA leg, the
descheduler's re-placement windows, crane-scheduler's plugin modes, the
kube drip storm and every control and shards leg but the journaled
one-shot run neither K1 nor K2; the drip queue, serve, kube drip,
descheduler and shards legs run K3, and the paths that run neither K3
nor a drip window must count 0 of it). K3's count is its entry point's
calls: an eager or captured window adds one, a replayed window none, so
the drip queue, serve and kube drip legs also hold ``kernel_windows``
equal to ``dispatches``. crane-scorer's counts come from its exit
line (K1 and K2 alone); the serve, SIGTERM, standby, descheduler and wire legs' counts come
from their processes' own exit lines (``--cli-child``), the SIGTERM and
wire legs' summed over their two processes, the standby leg's from the
standby (its SIGKILLed leader prints none).

A kernel's device time is the mean duration of its launches under
``torch.profiler`` over 200 back-to-back wrapper calls at the main path's
shape, over the launches the profiler recorded (``device_launches_seen``);
"host launch ms" is CUDA-event time over 50 back-to-back wrapper calls,
which at this size is the host's launch cost, not the kernel's.
Then one JSON line of per-kernel numbers, the ``nvidia-smi`` name/power
line, and the final ``{"ok": true, ...}`` line. Exit codes: 0 on success,
2 without a CUDA device, 1 on any failure.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import statistics
import time

import numpy as np
import torch

from crane_scheduler_tpu_torch.cluster import (
    ClusterState,
    Container,
    Node,
    OwnerReference,
    Pod,
    ResourceRequirements,
)
from crane_scheduler_tpu_torch.config import (
    PluginWeight,
    SchedulerConfiguration,
    SchedulerProfile,
    build_scheduler_from_config,
)
from crane_scheduler_tpu_torch.descheduler import (
    DeschedulerConfig,
    LoadAwareDescheduler,
    WatermarkPolicy,
)
from crane_scheduler_tpu_torch.fit import FitTracker, ResourceFitPlugin, pod_fit_request
from crane_scheduler_tpu_torch.framework.scheduler import (
    BURST_STAGES,
    BatchScheduler,
    Scheduler,
)
from crane_scheduler_tpu_torch.kernels import build_all
from crane_scheduler_tpu_torch.loadstore import NodeLoadStore
from crane_scheduler_tpu_torch.plugins import DynamicPlugin
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY, compile_policy
from crane_scheduler_tpu_torch.policy.types import (
    DynamicSchedulerPolicy,
    PolicySpec,
    PredicatePolicy,
    PriorityPolicy,
    SyncPolicy,
)
from crane_scheduler_tpu_torch.scorer import drip_batch, drip_step, gang_kernel, score_kernel
from crane_scheduler_tpu_torch.scorer.batched import BatchedScorer, PolicyConstants, score_plain
from crane_scheduler_tpu_torch.scorer.hybrid import HybridScorer
from crane_scheduler_tpu_torch.scorer.parity import check_placement_parity
from crane_scheduler_tpu_torch.scorer.topk import hot_penalty_steps
from crane_scheduler_tpu_torch.service import ScoringHTTPServer, ScoringService
from crane_scheduler_tpu_torch.telemetry import DecisionTraceBuffer, Telemetry, expfmt
from crane_scheduler_tpu_torch.utils import format_local_time
from crane_scheduler_tpu_torch.utils.profiling import chrome_trace, torch_trace

SEED = 0
N_NODES = 50_000
N_PADDED = 51_200  # the scheduler's 2048-node snapshot bucket
BURST_PODS = 100_000
SINGLE_BURSTS = 11  # one cold, ten warm
NOW = 1753776000.0
K1_LATER = 31.0  # a rebased `now` the main path also scores at
RAGGED = (50_001, 257, 1)  # node counts that leave a partial 256-thread block
DEVICE_LAUNCHES = 200  # launches profiled per device-time measurement
UPDATE_BURSTS = 10  # warm bursts of the delta and column paths
DELTA_NODES = N_NODES // 100  # nodes each delta-path patch rewrites (1%)
DRIP_WINDOW = 128  # schedule_queue's window (the batched drip benchmark's)
DRIP_SERVE_WINDOW = 32  # open_queue's window (the scheduler CLI's)
DRIP_PODS = 4096  # the drip storm
DRIP_WINDOW_NODES = (N_NODES, 50_001, 257)
DRIP_TIMED_DISPATCHES = 10
DRIP_SCALAR_NODES = 2_000  # the scalar loop is O(plugins x nodes) per pod
DRIP_SCALAR_PODS = 64
TELEMETRY_BURSTS = 10  # warm bursts with telemetry on, and as many off
TELEMETRY_TRACED_BURSTS = 3  # the profiler may drop a session's first device records
TELEMETRY_DRIP_STRIDE = 128  # decision sampling stride of the traced drip storm
TELEMETRY_OUT = "crane_scheduler_tpu_torch/_build/telemetry"  # span trace and torch trace
BURST_SPANS = ("ingest", "prepare", "dispatch", "d2h_wait", "bind_flush", "h2d_prepare",
               "risk_rescan")
DRIP_DIRTY_EVERY = 8  # windows between the drip_dirty phase's annotation patches
GANG_SHAPES = ((500, 12), (1000, 8), (250, 16), (1500, 6), (750, 10), (2000, 4)) * 4
GANG_WINDOW = 8
GANG_DYN_W, GANG_TOPO_W = 3, 2  # Dynamic x3, topology x2: the deploy-config weights
GANG_ORACLE_GANGS = 2  # the sequential oracle is O(pods x nodes) Python per gang
DRIP_ALLOCATABLE = {"cpu": "16", "memory": "64Gi", "ephemeral-storage": "100Gi", "pods": "110"}
# the NUMA gangs: guaranteed pods, (cpu milli, copies), 46 pods in all (7
# gangs: each of the six request classes once, then the first again, whose
# second gang takes the incremental vector path; the phase's depth, cut
# from 24 to 8 and then to 7 to keep the script's wall time)
_NUMA_CLASSES = ((1000, 12), (2000, 8), (3000, 6), (4000, 4), (6000, 2), (8000, 2))
NUMA_SHAPES = _NUMA_CLASSES + _NUMA_CLASSES[:1]
NUMA_TWIN_ARG = "--numa-twin"  # the child mode of the NUMA CPU twin and f64 mixed burst
NUMA_BEST_EFFORT = 64  # best-effort pods beside the gang pods in the mixed burst
NUMA_RANDOM_NODES = 4_096  # nodes of each random Z = 4, 8 batched-evaluation case
NUMA_PER_POD_NODES = 2_000  # the per-pod scalar loop is O(plugins x nodes) per pod
NUMA_PER_POD_PODS = 8  # cut from 16 to keep the script's wall time
SERVICE_NOWS = 5  # explicit `now`s of the card == CPU-twin body check
SERVICE_MISS_RENDERS = 20  # timed cache-miss renders per dtype
SERVICE_PROFILED_RENDERS = 5  # cache-miss renders per profiler session
SERVICE_CLIENTS = 8  # closed-loop keep-alive clients (bench config 10's shape)
SERVICE_SECONDS = 3.0
SERVICE_STORM = 6  # threads of the cold / hit / storm byte-identity check
SERVICE_ASSIGN_PODS = 100_000
SERVICE_ASSIGN_CALLS = 5  # /v1/assign calls per capacity mode
NUMA_AWARE = "topology.crane.io/topology-awareness"
NUMA_RESULT = "topology.crane.io/topology-result"

# H100 SXM published rates (NVIDIA data sheet; dense, non-tensor paths)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz, a multiply-add counted as two
INT32_OPS_PER_S = 33.5e12

PATHOLOGICAL = {
    "empty": PolicySpec(),
    "predicates-only": PolicySpec(
        sync_period=(SyncPolicy("a", 60.0),),
        predicate=(PredicatePolicy("a", 0.5), PredicatePolicy("a", 0.0)),
    ),
    "zero-weight-sum": PolicySpec(
        sync_period=(SyncPolicy("a", 60.0),),
        priority=(PriorityPolicy("a", 0.0),),
    ),
}


def max_entry_policy(n_entries: int) -> PolicySpec:
    """``n_entries`` predicates and as many priorities over 8 metrics,
    thresholds on both sides of the inputs' values, one disabled."""
    metrics = [f"m{k}" for k in range(8)]
    return PolicySpec(
        sync_period=tuple(SyncPolicy(m, 60.0 * (k + 1)) for k, m in enumerate(metrics)),
        predicate=tuple(PredicatePolicy(metrics[k % 8], (0.65, 0.5, 0.0, 0.9)[k % 4])
                        for k in range(n_entries)),
        priority=tuple(PriorityPolicy(metrics[(3 * k) % 8], 0.1 * (k + 1))
                       for k in range(n_entries)),
    )


_T0 = time.perf_counter()  # the script's start: each line's `at_s`


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - _T0, **fields}),
          flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls. For a call that launches one
    small kernel this is the host's launch cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, kernel: str, launches: int = DEVICE_LAUNCHES,
              attempts: int = 3) -> tuple[float, int]:
    """Mean device time in us of ``kernel`` per launch, and the number of
    launches it is the mean of: ``torch.profiler`` over ``launches``
    back-to-back calls of ``fn``, after one warm call.

    The profiler can lose a share of a run's device records (161 of 200
    seen in one H100 run); the mean over the records it kept is still the
    mean duration. A session that kept fewer than half is run again, up
    to ``attempts`` in all; the session that kept the most is used, and
    none kept, or more records than launches, fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = (0, 0.0)
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        count = sum(e.count for e in hits)
        if count > launches:
            raise AssertionError(f"profiler saw {count} launches of {kernel}, "
                                 f"more than the {launches} made")
        if count > best[0]:
            best = (count, sum(e.self_device_time_total for e in hits))
        if 2 * count >= launches:
            break
    count, total_us = best
    if count == 0:
        raise AssertionError(f"profiler saw no launch of {kernel} in {attempts} sessions")
    return total_us / count, count


def bound_fields(device: float, bound_ms: float) -> dict:
    return {"device_us": device, "bound_us": bound_ms * 1e3,
            "pct_of_bound": 100.0 * bound_ms * 1e3 / device}


# -- K1 ----------------------------------------------------------------------

def score_inputs(tensors, n: int, n_valid: int, rng, dev):
    """Rebased f32 step inputs (now = 0) with stale, missing, negative and
    NaN entries and hot values of every freshness."""
    m = tensors.num_metrics
    values = rng.uniform(0.0, 1.0, (n, m)).round(5)
    ts = -rng.choice([0.0, 30.0, 170.0, 479.0, 481.0, 2000.0], (n, m))
    roll = rng.random((n, m))
    ts[roll < 0.05] = -np.inf  # missing annotation
    values[roll < 0.05] = np.nan
    values[(roll >= 0.05) & (roll < 0.07)] = -0.3  # negative reading
    values[(roll >= 0.07) & (roll < 0.08)] = np.nan  # "NaN,<fresh ts>"
    near = (roll >= 0.08) & (roll < 0.2)
    values[near] = rng.choice([0.64999, 0.65, 0.65001, 0.75, 0.75001], near.sum())
    hot = rng.choice([0.0, 1.0, 2.0, 0.1, 0.35, 3.0], n)
    hot_ts = -rng.choice([0.0, 60.0, 299.0, 301.0], n)
    valid = np.zeros(n, dtype=bool)
    valid[:n_valid] = True
    values[n_valid:], ts[n_valid:], hot_ts[n_valid:] = np.nan, -np.inf, -np.inf
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)  # noqa: E731
    return (f32(values), f32(ts), f32(hot), f32(hot_ts), torch.from_numpy(valid).to(dev))


def k1_bound_ms(n: int, m: int, n_pred: int, n_prio: int) -> tuple[float, str]:
    # each input read once, each output written once
    nbytes = n * (2 * m * 4 + 4 + 4 + 1) + n * (1 + 4)
    # per node: ~4 float ops per predicate, ~6 per priority entry, ~12 for
    # the quotient, truncations, hot penalty and clip
    ops = n * (4 * n_pred + 6 * n_prio + 12)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k1_check(name: str, consts, case_args, now: float) -> int:
    sched_k, score_k = score_kernel.fused_score(*case_args, now, consts)
    sched_p, score_p = score_plain(*case_args, now, consts)
    torch.cuda.synchronize()
    err = max(
        int((score_k.long() - score_p.long()).abs().max()),
        int((sched_k.long() - sched_p.long()).abs().max()),
    )
    if err != 0 or not torch.equal(score_k, score_p) or not torch.equal(sched_k, sched_p):
        raise AssertionError(f"K1 != plain version for {name} at now={now} (max err {err})")
    return err


def phase_k1(dev, rng) -> dict:
    worst = 0
    shapes = []
    timing = None
    max_entries = score_kernel.MAX_ENTRIES
    policies = [("default", DEFAULT_POLICY.spec), *PATHOLOGICAL.items(),
                (f"{max_entries}-entries", max_entry_policy(max_entries))]
    for name, spec in policies:
        tensors = compile_policy(DynamicSchedulerPolicy(spec=spec))
        consts = PolicyConstants(tensors, torch.float32, dev)
        args = score_inputs(tensors, N_PADDED, N_NODES, rng, dev)
        cases = [(args, 0.0)]
        if name == "default":
            # the step re-scores a resident snapshot at a later rebased
            # `now`: the same data, timestamps shifted with the clock
            values, ts, hot, hot_ts, valid = args
            cases.append(((values, ts + K1_LATER, hot, hot_ts + K1_LATER, valid), K1_LATER))
        for n in RAGGED if name in ("default", f"{max_entries}-entries") else ():
            cases.append((score_inputs(tensors, n, n - n // 50, rng, dev), 0.0))
        for case_args, now in cases:
            worst = max(worst, k1_check(f"policy {name}, {case_args[0].shape[0]} nodes",
                                        consts, case_args, now))
        shapes.append(name)
        if name == "default":
            bound, by = k1_bound_ms(N_PADDED, tensors.num_metrics,
                                    len(tensors.pred_idx), len(tensors.prio_idx))
            kernel_us, seen = device_us(lambda: score_kernel.fused_score(*args, 0.0, consts),
                                        "score_nodes_kernel")
            timing = {
                "ms": kernel_us / 1e3, "device_launches_seen": seen,
                "host_launch_ms": cuda_ms(lambda: score_kernel.fused_score(*args, 0.0, consts)),
                "plain_ms": cuda_ms(lambda: score_plain(*args, 0.0, consts)),
                "bound_ms": bound, "bound_by": by, **bound_fields(kernel_us, bound),
            }
    over = compile_policy(DynamicSchedulerPolicy(spec=max_entry_policy(max_entries + 1)))
    over_consts = PolicyConstants(over, torch.float32, dev)
    try:
        score_kernel.fused_score(*score_inputs(over, 257, 257, rng, dev), 0.0, over_consts)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"K1 took a policy with {max_entries + 1} entries per list")
    log("k1_vs_plain", equal=True, policies=shapes, nows=[0.0, K1_LATER],
        nodes=N_PADDED, ragged_nodes=list(RAGGED), refused_over_max=refused, **timing)
    return {"max_abs_err": worst, **timing}


# -- K2 ----------------------------------------------------------------------

def gang_inputs(n: int, rng, dev, w: int, max_offset: int, combined: bool):
    s = rng.integers(0, 101, n)
    sched = rng.random(n) > 0.25
    num_pods = BURST_PODS
    cap = rng.integers(0, 111, n) if combined else np.full(n, 1 << 30)
    k_cap = np.minimum(np.where(sched, cap, 0), num_pods)
    k_cap = np.minimum(k_cap, (2**31 - 1) // n)
    offs = rng.integers(0, max_offset + 1, n) if combined else np.zeros(n, np.int64)
    pri = rng.integers(0, 5, n) if combined else np.zeros(n, np.int64)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)  # noqa: E731
    g = i32(hot_penalty_steps(compile_policy(DEFAULT_POLICY).hv_count))
    n_levels = 100 * w + max_offset + 2
    return (i32(s), i32(offs), i32(k_cap), i32(pri), g, w, n_levels)


def k2_steps(s: np.ndarray) -> int:
    """Steps K2 takes over these scores: per node the level-0 term, one per
    run of equal staircase index, and the tail."""
    s = s.astype(np.int64)
    qmax = np.clip(s, 0, 100)
    runs = np.minimum((s - 1) // 10, 10) - np.minimum((s - qmax) // 10, 10) + 1
    return int((np.where(s > 0, runs, 0) + 2).sum())


def k2_bound_ms(n: int, n_levels: int, steps: int) -> tuple[float, str]:
    nbytes = 4 * 4 * n + 4 * n_levels  # s, offs, cap, pri in; totals out
    ops = 10 * steps  # ~10 int32 ops per step of the walk
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k2_check(label: str, args) -> int:
    got = gang_kernel.gang_totals(*args)
    want = gang_kernel.gang_totals_plain(*args)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"K2 != plain version, {label} (max err {err})")
    return err


def phase_k2(dev, rng) -> dict:
    out = {}
    worst = 0
    for mode, w, max_offset in (("plain", 1, 0), ("combined", 3, 220)):
        combined = mode == "combined"
        args = gang_inputs(N_PADDED, rng, dev, w, max_offset, combined)
        worst = max(worst, k2_check(f"{mode} mode", args))
        for n in RAGGED:
            worst = max(worst, k2_check(f"{mode} mode, {n} nodes",
                                        gang_inputs(n, rng, dev, w, max_offset, combined)))
        for score in (57, 100):  # every node on one score: every bin contended
            one = (torch.full_like(args[0], score), *args[1:])
            worst = max(worst, k2_check(f"{mode} mode, every score {score}", one))
        kernel_us, seen = device_us(lambda: gang_kernel.gang_totals(*args),
                                    "gang_totals_kernel")
        bound, by = k2_bound_ms(N_PADDED, args[-1], k2_steps(args[0].cpu().numpy()))
        out[mode] = dict(
            ms=kernel_us / 1e3, device_launches_seen=seen,
            host_launch_ms=cuda_ms(lambda: gang_kernel.gang_totals(*args)),
            plain_ms=cuda_ms(lambda: gang_kernel.gang_totals_plain(*args), iters=20),
            bound_ms=bound, bound_by=by, n_levels=args[-1], **bound_fields(kernel_us, bound),
        )
    limit = gang_kernel.max_levels(args[0].device)
    try:
        gang_kernel.gang_totals(*args[:-1], limit + 1)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"K2 took {limit + 1} levels, above its limit of {limit}")
    log("k2_vs_plain", equal=True, nodes=N_PADDED, ragged_nodes=list(RAGGED),
        one_score=[57, 100], max_levels=limit, refused_over_max=refused, **out)
    return {"max_abs_err": worst, **out["plain"]}


# -- K3 ----------------------------------------------------------------------

K3_NODES = 65_000  # the drip cells' cluster
K3_PROFILED_WINDOWS = 4


def k3_inputs(n: int, k: int, z: int, rng) -> tuple:
    """One drip window's host inputs, as ``window_case`` draws the plain
    columns, and with ``z`` > 0 zone columns: allocatable milli-CPU of 1
    to ``z`` zones a node (``-2^62`` past them), whole-core caps, zone
    usage with overcommitted zones, CR, Static and single-NUMA flags, and
    pod rows with 0 to 16 cores, a quarter aware."""
    cols = window_case(n, k, "random", rng)
    cols[5][k - 4:] = False  # padded pods
    if z == 0:
        return cols, None
    zkey = rng.integers(2, 49, (n, z)).astype(np.int64) * 1000
    zkey[np.arange(z)[None, :] >= rng.integers(1, z + 1, n)[:, None]] = -(1 << 62)
    zcap = np.where(zkey >= 0, zkey // 1000 * 1000, 0)
    used = np.where(zkey >= 0, rng.choice([0, 2000, 8000, 60000], (n, z)), 0).astype(np.int64)
    has, static = rng.random(n) < 0.95, rng.random(n) < 0.9
    naw = static & (rng.random(n) < 0.25)
    pods = drip_batch.numa_pod_rows(rng.choice([0, 2000, 4000, 8000, 16000], k),
                                    rng.choice([-1, -1, 0, 1], k), 2, z)
    return cols, ((zkey, zcap, has, static, naw), used, pods)


def k3_tensors(cols, zones, dev) -> tuple:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    c = [t(a) for a in cols]
    return c, None if zones is None else (tuple(t(a) for a in zones[0]), t(zones[1]),
                                          t(zones[2]))


def k3_plain(c, zs, want_ties: bool):
    if zs is None:
        return drip_batch._drip_batch(*c, want_ties=want_ties)
    return drip_batch._drip_batch_numa(*c, *zs, want_ties=want_ties)


def k3_bound_us(n: int, k: int, z: int) -> float:
    """Least time of one step: the benchmark's least time of the window
    (each byte read or written once, the operations these inputs need;
    operations bound it at the drip cells' shapes) over its ``k`` steps."""
    from portbench.bounds import drip_window_least_s
    from portbench.bounds_numa import numa_window_least_s

    least = drip_window_least_s(n, k) if z == 0 else numa_window_least_s(n, k, z)
    return least * 1e6 / k


def k3_step_us(fn, windows: int) -> tuple[float, int]:
    """Mean device us of one ``drip_step`` launch over ``windows`` calls of
    ``fn`` under ``torch.profiler`` (after one warm call), and the launches
    the profiler kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(windows):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "drip_step" in e.key]
    count = sum(e.count for e in hits)
    if count == 0:
        raise AssertionError("the profiler saw no drip_step launch")
    return sum(e.self_device_time_total for e in hits) / count, count


def k3_against_plain(cols, zones, want_ties: bool, scratch, dev, what: str):
    """K3's window on ``dev`` against the PyTorch window on CPU tensors,
    every output row and folded carry exactly; returns K3's ``outs``."""
    want = k3_plain(*k3_tensors(cols, zones, "cpu"), want_ties)
    c, zs = k3_tensors(cols, zones, dev)
    outs = drip_step.drip_window(*c, scratch, want_ties, zones=zs)
    got = (outs, c[3]) if zs is None else (outs, c[3], zs[1])
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError(f"K3 != the PyTorch window: {what}, want_ties={want_ties}")
    return outs.cpu()


def phase_k3(dev, rng) -> dict:
    """K3's times at the drip cells' shape (its equality: ``phase_drip_window``)."""
    scratch = drip_step.StepScratch(dev)
    out = {}
    for z in (0, 2):
        cols, zones = k3_inputs(K3_NODES, DRIP_WINDOW, z, rng)
        c, zs = k3_tensors(cols, zones, dev)
        free0 = c[3].clone()
        used0 = None if zs is None else zs[1].clone()

        def window():
            return drip_step.drip_window(*c, scratch, False, zones=zs)

        step_us, seen = k3_step_us(window, K3_PROFILED_WINDOWS)
        host_ms = []
        for _ in range(DRIP_TIMED_DISPATCHES + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        # one window replayed from a captured graph, its carries reset first
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            window()
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)

        def replay():
            c[3].copy_(free0)
            if zs is not None:
                zs[1].copy_(used0)
            graph.replay()

        graph_ms = cuda_ms(replay, iters=20)
        plain_ms = cuda_ms(lambda: k3_plain(c, zs, False), iters=5, warmup=1)
        bound = k3_bound_us(K3_NODES, DRIP_WINDOW, z)
        out["plain" if z == 0 else f"zones_{z}"] = dict(
            ms=step_us / 1e3, device_launches_seen=seen,
            host_launch_ms=statistics.median(host_ms[1:]), graph_window_ms=graph_ms,
            plain_ms=plain_ms, bound_ms=bound / 1e3, bound_by="operations",
            **bound_fields(step_us, bound / 1e3))
    log("k3", nodes=K3_NODES, k=DRIP_WINDOW, **out)
    return {**out["plain"], "zones_2": out["zones_2"]}


# -- the main path -------------------------------------------------------------

class Clock:
    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


def build_cluster(annotations) -> ClusterState:
    cluster = ClusterState()
    for name, anno in annotations:
        cluster.add_node(Node(name=name, annotations=dict(anno)))
    return cluster


def cluster_annotations(tensors, rng):
    """50,000 nodes, fresh annotations for the 6 default metrics and the
    hot value, values drawn from the seed (as the benchmark builds them)."""
    fresh = format_local_time(NOW - 30.0)
    values = rng.uniform(0.0, 1.0, (N_NODES, tensors.num_metrics))
    hot = rng.integers(0, 3, N_NODES)
    names = tensors.metric_names
    return [
        (f"node-{i:05d}", {
            **{m: f"{values[i, k]:.5f},{fresh}" for k, m in enumerate(names)},
            "node_hot_value": f"{int(hot[i])},{fresh}",
        })
        for i in range(N_NODES)
    ]


def parity_check(sched: BatchScheduler, result, num_pods: int) -> None:
    snap = sched.store.snapshot(bucket=2048)
    n = snap.n_nodes
    idx = np.asarray(result.node_idx)
    check_placement_parity(
        values=snap.values[:n], ts=snap.ts[:n], hot_value=snap.hot_value[:n],
        hot_ts=snap.hot_ts[:n], node_valid=snap.node_valid[:n], now=result.now,
        tensors=sched.tensors, schedulable=result.schedulable_row,
        scores=result.scores_row, counts=np.bincount(idx[idx >= 0], minlength=n),
        num_pods=num_pods, unassigned=int((idx < 0).sum()),
    )


def run_bursts(sched: BatchScheduler, clock: Clock, nows, check: bool):
    """A single burst at each of ``nows`` but the last, then one depth-4
    pipelined run of four at the last; returns (node_idx per burst, wall
    ms per single burst, host stage ms per single burst, pipelined ms)."""
    placements, burst_ms, stage_ms = [], [], []
    for k, now in enumerate(nows[:-1]):
        clock.t = now
        names = [f"burst{k}-{i}" for i in range(BURST_PODS)]
        sched.burst_stage_ms = dict.fromkeys(BURST_STAGES, 0.0)
        t0 = time.perf_counter()
        result = sched.schedule_pod_burst("bench", names)
        burst_ms.append((time.perf_counter() - t0) * 1e3)
        stage_ms.append(dict(sched.burst_stage_ms))  # the live dict goes on counting
        if check:
            parity_check(sched, result, BURST_PODS)
            if result.n_assigned != BURST_PODS:
                raise AssertionError(f"burst {k}: {result.n_assigned}/{BURST_PODS} placed")
        placements.append(result.node_idx)
    clock.t = nows[-1]
    bursts = [("bench", [f"pipe{k}-{i}" for i in range(BURST_PODS // 4)]) for k in range(4)]
    t0 = time.perf_counter()
    results = list(sched.schedule_bursts_pipelined(bursts, depth=4))
    pipe_ms = (time.perf_counter() - t0) * 1e3
    for result in results:
        if check:
            parity_check(sched, result, BURST_PODS // 4)
        placements.append(result.node_idx)
    return placements, burst_ms, stage_ms, pipe_ms


# K3's count is its entry point's calls: an eager or a captured window adds
# one (the call enqueues the window's K step launches), a replayed window
# none; the drip phases hold ``kernel_windows`` against ``dispatches`` for
# the replays
KERNELS = {"score": score_kernel.KERNEL, "gang": gang_kernel.KERNEL, "drip": drip_step.KERNEL}


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def read_launches(path: str, need=("score", "gang")) -> dict:
    """The launch counts since ``reset_launches``; raises unless every
    kernel in ``need`` launched on ``path``."""
    got = {name: kernel.launches for name, kernel in KERNELS.items()}
    missing = [name for name in need if got[name] <= 0]
    if missing:
        raise AssertionError(f"{path} did not launch {missing}: {got}")
    return got


def all_kernel_windows(stats: dict, pre, path: str) -> int:
    """The drip windows dispatched since ``pre`` (``drip_stats()`` before
    the run; None for a fresh scheduler); raises unless there are some and
    every one ran K3, eager, captured or replayed."""
    before = pre["batch"] if pre else {"dispatches": 0, "kernel_windows": 0}
    windows = stats["batch"]["dispatches"] - before["dispatches"]
    kernel = stats["batch"]["kernel_windows"] - before["kernel_windows"]
    if windows < 1 or kernel != windows:
        raise AssertionError(f"{path}: {kernel} of {windows} drip windows ran K3")
    return kernel


def phase_main_path(rng) -> dict:
    tensors = compile_policy(DEFAULT_POLICY)
    t0 = time.perf_counter()
    annos = cluster_annotations(tensors, rng)
    cluster = build_cluster(annos)
    build_s = time.perf_counter() - t0
    nows = [NOW + 12.0 * k for k in range(SINGLE_BURSTS + 1)]

    clock = Clock(NOW)
    sched = BatchScheduler(cluster, DEFAULT_POLICY, dtype=torch.float32, clock=clock)
    reset_launches()
    t_run = time.perf_counter()
    placements, burst_ms, stage_ms, pipe_ms = run_bursts(sched, clock, nows, check=True)
    run_s = time.perf_counter() - t_run
    launches = read_launches("main path")

    twin_clock = Clock(NOW)
    twin = BatchScheduler(build_cluster(annos), DEFAULT_POLICY, dtype=torch.float64,
                          clock=twin_clock)
    twin_placements, twin_ms, _, twin_pipe_ms = run_bursts(twin, twin_clock, nows, check=False)
    for k, (a, b) in enumerate(zip(placements, twin_placements)):
        if not np.array_equal(a, b):
            raise AssertionError(f"burst {k}: f32-hybrid placements != float64 placements")
    warm = burst_ms[1:]
    hit_prepare_ms = statistics.median(d["prepare"] for d in stage_ms[1:])
    log(
        "main_path", nodes=N_NODES, pods_per_burst=BURST_PODS, bursts=len(burst_ms),
        pipelined_bursts=4, parity="ok", f64_twin_equal=True,
        ms_per_burst=burst_ms, warm_median_ms=statistics.median(warm),
        pods_per_s_warm_median=BURST_PODS / (statistics.median(warm) / 1e3),
        warm_stage_median_ms={
            st: statistics.median(d[st] for d in stage_ms[1:]) for st in BURST_STAGES
        },
        stage_ms_per_burst=stage_ms, pipelined_ms_total=pipe_ms,
        f64_twin_ms_per_burst=twin_ms, f64_twin_warm_median_ms=statistics.median(twin_ms[1:]),
        f64_twin_pipelined_ms_total=twin_pipe_ms,
        refresh_stats=sched.refresh_stats, launches=launches,
        cluster_build_s=build_s, run_s=run_s,
    )
    return launches, sched, clock, nows[-1], hit_prepare_ms


def phase_profile(sched: BatchScheduler, clock: Clock, now: float) -> None:
    """One more warm 100,000-pod burst under ``torch.profiler``: the
    device's busy time and idle share, and each kernel's device time."""
    from torch.profiler import ProfilerActivity, profile

    clock.t = now + 12.0
    names = [f"prof-{i}" for i in range(BURST_PODS)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.schedule_pod_burst("bench", names)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies, fills); the aten ops that
    # launched them carry the same time again
    device = {
        e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    }
    busy_us = sum(us for _, us in device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    ours = {
        name: [[c, us / c] for k, (c, us) in device.items() if name in k]
        for name in ("score_nodes_kernel", "gang_totals_kernel")
    }
    log(
        "profile", pods=BURST_PODS, profiled_wall_ms=wall_us / 1e3,
        device_busy_ms=busy_us / 1e3 if device else None,
        device_idle_share=(1 - busy_us / wall_us) if device else None,
        device_events=sum(c for c, _ in device.values()),
        kernel_launches_and_device_us=ours,
        top_device_us=[[k[:60], c, us] for k, (c, us) in top],
    )


# -- keeping the resident snapshot current ------------------------------------

def timed_burst(sched: BatchScheduler, tag: str) -> tuple:
    """One checked 100,000-pod burst: (wall ms, host stage ms, launches)."""
    names = [f"{tag}-{i}" for i in range(BURST_PODS)]
    sched.burst_stage_ms = dict.fromkeys(BURST_STAGES, 0.0)
    before = {name: kernel.launches for name, kernel in KERNELS.items()}
    t0 = time.perf_counter()
    result = sched.schedule_pod_burst("update", names)
    wall = (time.perf_counter() - t0) * 1e3
    launched = {name: kernel.launches - before[name] for name, kernel in KERNELS.items()}
    parity_check(sched, result, BURST_PODS)
    if result.n_assigned != BURST_PODS:
        raise AssertionError(f"{tag}: {result.n_assigned}/{BURST_PODS} placed")
    return wall, dict(sched.burst_stage_ms), launched


def run_update_bursts(sched: BatchScheduler, clock: Clock, update, path: str) -> dict:
    """A cold burst, then ``UPDATE_BURSTS`` warm ones, each after
    ``update(k, now)``; returns the per-burst numbers for the log line."""
    cold_ms, cold_stages, _ = timed_burst(sched, f"{path}-cold")
    out = {"burst_ms": [], "prepare_ms": [], "rescan_rows": [], "launches_per_burst": []}
    stage_ms = []
    for k in range(UPDATE_BURSTS):
        clock.t += 12.0
        update(k, clock.t)
        rescan = sched.refresh_stats["risk_rescan_rows"]
        wall, stages, launched = timed_burst(sched, f"{path}-{k}")
        out["burst_ms"].append(wall)
        stage_ms.append(stages)
        out["prepare_ms"].append(stages["prepare"])
        out["rescan_rows"].append(sched.refresh_stats["risk_rescan_rows"] - rescan)
        out["launches_per_burst"].append(launched)
    out["cold_ms"], out["full_prepare_ms"] = cold_ms, cold_stages["prepare"]
    out["prepare_median_ms"] = statistics.median(out["prepare_ms"])
    out["burst_median_ms"] = statistics.median(out["burst_ms"])
    out["stage_median_ms"] = {st: statistics.median(d[st] for d in stage_ms) for st in BURST_STAGES}
    return out


def same_as_full_prepare(sched: BatchScheduler, fresh: BatchScheduler, path: str) -> None:
    """``sched``'s kept-current snapshot and ``fresh``'s full prepare score
    and place one unbound burst identically at the same `now`."""
    names = [f"{path}-cmp-{i}" for i in range(BURST_PODS)]
    kept = sched.schedule_pod_burst("update", names, bind=False)
    full = fresh.schedule_pod_burst("update", names, bind=False)
    if fresh.refresh_stats["full"] != 1 or kept.node_table != full.node_table:
        raise AssertionError(f"{path}: the comparison did not take a full prepare")
    for field in ("scores_row", "schedulable_row", "node_idx"):
        if not np.array_equal(getattr(kept, field), getattr(full, field)):
            raise AssertionError(f"{path}: {field} differs from a full prepare")


def device_events(prof) -> dict:
    return {
        e.key: [e.count, e.self_device_time_total] for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    }


def patch_nodes(cluster: ClusterState, names: list, metric_names, rng, now: float) -> None:
    """One annotator-sized patch: ``DELTA_NODES`` seeded-random nodes get
    new values and hot values stamped at ``now``."""
    rows = rng.choice(len(names), DELTA_NODES, replace=False)
    values = rng.uniform(0.0, 1.0, (DELTA_NODES, len(metric_names)))
    hot = rng.integers(0, 3, DELTA_NODES)
    stamp = format_local_time(now)
    per = {
        names[r]: {
            **{m: f"{values[j, k]:.5f},{stamp}" for k, m in enumerate(metric_names)},
            "node_hot_value": f"{int(hot[j])},{stamp}",
        }
        for j, r in enumerate(rows)
    }
    if cluster.patch_node_annotations_bulk(per) != DELTA_NODES:
        raise AssertionError("patch missed nodes")


def phase_delta_path(cluster: ClusterState, rng, now: float, hit_prepare_ms: float):
    tensors = compile_policy(DEFAULT_POLICY)
    names = [n.name for n in cluster.list_nodes()]
    clock = Clock(now)
    sched = BatchScheduler(cluster, DEFAULT_POLICY, dtype=torch.float32, clock=clock)
    reset_launches()
    out = run_update_bursts(
        sched, clock, lambda k, t: patch_nodes(cluster, names, tensors.metric_names, rng, t),
        "delta",
    )
    stats = dict(sched.refresh_stats)
    if stats["delta"] != UPDATE_BURSTS or stats["full"] != 1:
        raise AssertionError(f"delta path: refresh_stats {stats}")
    same_as_full_prepare(
        sched, BatchScheduler(cluster, DEFAULT_POLICY, dtype=torch.float32, clock=clock), "delta")
    launches = read_launches("delta path")

    # the device time of one more delta upload and scatter, alone
    from torch.profiler import ProfilerActivity, profile

    clock.t += 12.0
    patch_nodes(cluster, names, tensors.metric_names, rng, clock.t)
    sched.refresh()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched._prepare(clock.t)
        torch.cuda.synchronize()
        prepare_wall_ms = (time.perf_counter() - t0) * 1e3
    if sched.refresh_stats["delta"] != UPDATE_BURSTS + 1:
        raise AssertionError("the profiled prepare did not take the delta path")
    events = device_events(prof)
    log("delta_path", nodes=N_NODES, patched_nodes_per_burst=DELTA_NODES,
        pods_per_burst=BURST_PODS, parity="ok", equal_to_full_prepare=True,
        refresh_stats=stats, main_path_hit_prepare_median_ms=hit_prepare_ms,
        profiled_prepare_wall_ms=prepare_wall_ms,
        profiled_prepare_device_us=sum(us for _, us in events.values()),
        profiled_prepare_device_events=events, launches=launches, **out)
    return launches


def annotator_sweep(store: NodeLoadStore, names: list, metric_names, rng, now: float,
                    partial_metric=None) -> None:
    """The annotator's direct-mode sweep: one ``bulk_set_by_name`` per
    metric over ``names``, one shared timestamp, hot values with the first
    metric; ``partial_metric`` leaves the last two nodes out."""
    hot = rng.integers(0, 3, len(names)).astype(np.float64)
    for k, metric in enumerate(metric_names):
        cols = names[:-2] if metric == partial_metric else names
        values = rng.uniform(0.0, 1.0, len(cols)).round(5)
        if k == 0:
            store.bulk_set_by_name(metric, cols, values, now, hot[: len(cols)], now)
        else:
            store.bulk_set_by_name(metric, cols, values, now)


def phase_column_path(rng, now: float):
    tensors = compile_policy(DEFAULT_POLICY)
    store = NodeLoadStore(tensors)
    names = [f"node-{i:05d}" for i in range(N_NODES)]
    annotator_sweep(store, names, tensors.metric_names, rng, now - 30.0)
    clock = Clock(now)
    direct = dict(store=store, refresh_from_cluster=False)
    sched = BatchScheduler(ClusterState(), DEFAULT_POLICY, dtype=torch.float32, clock=clock,
                           **direct)
    partial = tensors.metric_names[1]
    reset_launches()
    out = run_update_bursts(
        sched, clock,
        lambda k, t: annotator_sweep(store, names, tensors.metric_names, rng, t,
                                     partial_metric=partial if k == 4 else None),
        "column",
    )
    stats = dict(sched.refresh_stats)
    if stats["columns"] != UPDATE_BURSTS or stats["full"] != 1:
        raise AssertionError(f"column path: refresh_stats {stats}")
    same_as_full_prepare(sched, BatchScheduler(
        ClusterState(), DEFAULT_POLICY, dtype=torch.float32, clock=clock, **direct), "column")
    launches = read_launches("column path")
    log("column_path", nodes=N_NODES, sweeps=UPDATE_BURSTS, partial_sweep=4,
        pods_per_burst=BURST_PODS, parity="ok", equal_to_full_prepare=True,
        refresh_stats=stats, launches=launches, **out)
    return launches, store, clock.t


def phase_overlap(sched: BatchScheduler, clock: Clock, now: float) -> dict:
    clock.t = now
    sched.schedule_pod_burst("overlap", ["overlap-warm"], bind=False)  # absorb earlier patches
    reset_launches()
    runs, placements = {}, {}
    for mode, kw in (("blocking", {}),
                     ("overlapped", {"overlap_refresh": True, "overlap_bind": True})):
        bursts = [("overlap", [f"{mode}{k}-{i}" for i in range(BURST_PODS // 4)])
                  for k in range(4)]
        hits = sched.refresh_stats["overlap_hits"]
        results, marks = [], []
        t0 = time.perf_counter()
        for result in sched.schedule_bursts_pipelined(bursts, depth=4, **kw):
            results.append(result)
            marks.append(time.perf_counter())
        t_end = time.perf_counter()  # after the loop's teardown flushed the binds
        for result in results:  # consumed: every bind has settled
            placed = int((np.asarray(result.node_idx) >= 0).sum())
            if (result.bound_rows is None or len(result.bound_rows) != placed
                    or placed != BURST_PODS // 4):
                raise AssertionError(f"overlap ({mode}): a result did not settle")
        placements[mode] = [np.asarray(r.node_idx) for r in results]
        runs[mode] = {
            "wall_ms_total": (t_end - t0) * 1e3,
            "ms_between_results": [(b - a) * 1e3 for a, b in zip([t0, *marks], marks)],
            "overlap_hits": sched.refresh_stats["overlap_hits"] - hits,
            "bind_flush": sched.bind_flush_stats,
        }
    for a, b in zip(placements["blocking"], placements["overlapped"]):
        if not np.array_equal(a, b):
            raise AssertionError("overlapped placements != blocking placements")
    launches = read_launches("overlap")
    log("overlap", nodes=N_NODES, pipelined_bursts=4, pods_per_burst=BURST_PODS // 4,
        depth=4, identical=True, settled=True, launches=launches, **runs)
    return launches


def phase_hybrid_scorer(store: NodeLoadStore, now: float) -> dict:
    tensors = store.tensors
    snap = store.snapshot(bucket=2048)
    args = (snap.values, snap.ts, snap.hot_value, snap.hot_ts, snap.node_valid, now)
    hybrid = HybridScorer(tensors)
    hybrid(*args)  # warm
    reset_launches()
    t0 = time.perf_counter()
    got = hybrid(*args)
    hybrid_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("hybrid scorer", need=("score",))
    want = BatchedScorer(tensors, dtype=torch.float64)(*args)
    if not (np.array_equal(got.schedulable, want.schedulable.cpu().numpy())
            and np.array_equal(got.scores, want.scores.cpu().numpy())):
        raise AssertionError("HybridScorer != BatchedScorer(float64)")
    log("hybrid_scorer", nodes=snap.n_nodes, padded=snap.values.shape[0], equal_to_f64=True,
        rescored=got.rescored, host_ms=hybrid_ms, launches=launches)
    return launches


# -- the drip path ---------------------------------------------------------------

I64_MIN = int(np.iinfo(np.int64).min)


def window_case(n: int, k: int, case: str, rng):
    """One ``_drip_batch`` input set at the drip path's types: weighted
    scores on the Dynamic plugin's scale (many ties), free rows in bytes
    past int32, requests of three shapes. ``case``: "random", "infeasible"
    (no row schedulable), "equal" (every row schedulable at one weight),
    "padded" (the last 100 rows padding, the last 28 pods inactive, as the
    reference's buckets pad)."""
    schedulable = rng.random(n) < 0.8
    weighted = rng.integers(0, 101, n).astype(np.int64) * 3
    bounded = rng.random(n) < 0.9
    free = np.stack([rng.integers(0, 16_001, n), rng.integers(0, 64 << 30, n),
                     rng.integers(0, 100 << 30, n), rng.integers(0, 111, n)], axis=1)
    vecs = np.stack([rng.choice([100, 500, 4000], k), rng.choice([128 << 20, 1 << 30, 40 << 30], k),
                     np.zeros(k, np.int64), np.ones(k, np.int64)], axis=1)
    active = np.ones(k, dtype=bool)
    if case == "infeasible":
        schedulable[:] = False
    elif case == "equal":
        schedulable[:] = True
        weighted[:] = 150
    elif case == "padded":
        pad = min(100, n - 1)
        schedulable[n - pad:] = False
        weighted[n - pad:] = I64_MIN
        bounded[n - pad:] = False
        free[n - pad:] = 0
        active[k - 28:] = False
    return [schedulable, weighted, bounded, free.astype(np.int64), vecs.astype(np.int64), active]


def first_choice(args) -> int:
    """The first pod's winner by numpy: the first maximum, or -1."""
    schedulable, weighted, bounded, free, vecs, _ = args
    vec = vecs[0]
    mask = schedulable & ~(bounded & ((vec > 0) & (free < vec)).any(axis=1))
    return int(np.argmax(np.where(mask, weighted, I64_MIN))) if mask.any() else -1


def profile_windows(fn, count: int) -> dict:
    """``torch.profiler`` over ``count`` calls of ``fn`` (after one warm
    call): device us, device kernel events and host kernel-launch calls per
    call, and the records seen."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in device)
    kernels = sum(e.count for e in device if not e.key.startswith("Memcpy")
                  and not e.key.startswith("Memset"))
    launches = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    if not device:
        raise AssertionError("the profiler saw no device time")
    return {
        "device_us": busy_us / count, "wall_us": wall_us / count,
        "device_idle_share": 1 - busy_us / wall_us,
        "device_events_seen": sum(e.count for e in device),
        "device_kernels": kernels / count, "cuda_launch_kernel_calls": launches / count,
        "top_device_us": [[e.key[:60], e.count, e.self_device_time_total]
                          for e in sorted(device, key=lambda e: -e.self_device_time_total)[:5]],
    }


def phase_drip_window(dev) -> dict:
    """K3 (``drip_step.drip_window``) on the card against the PyTorch window
    on CPU tensors, exactly: every int64 output and the folded carries."""
    rng = np.random.default_rng(SEED)
    scratch = drip_step.StepScratch(dev)
    checked = []
    t_phase = time.perf_counter()
    for n in DRIP_WINDOW_NODES:
        for case in ("random", "infeasible", "equal", "padded"):
            args = window_case(n, DRIP_WINDOW, case, rng)
            for want_ties in (True, False):
                outs = k3_against_plain(args, None, want_ties, scratch, dev, f"{n} nodes, {case}")
                if int(outs[0, 0]) != first_choice(args):
                    raise AssertionError(f"first pod's winner is not the first maximum: {case}")
                if case == "infeasible" and not (outs[:, 0] == -1).all():
                    raise AssertionError("a pod was placed with no schedulable row")
                if case == "equal" and want_ties and int(outs[0, 2]) < 2:
                    raise AssertionError("the all-equal case reported no tie")
                checked.append([n, 0, case, want_ties])
    for n, z in ((K3_NODES, 0), (K3_NODES, 2), (257, 4), (1, 1)):
        cols, zones = k3_inputs(n, DRIP_WINDOW, z, rng)
        for want_ties in (True, False):
            outs = k3_against_plain(cols, zones, want_ties, scratch, dev, f"{n} nodes, {z} zones")
            checked.append([n, z, "random", want_ties, int((outs[:, 0] >= 0).sum())])
    check_s = time.perf_counter() - t_phase
    # the window never waits on the device: a synchronising call raises
    args = window_case(N_NODES, DRIP_WINDOW, "random", rng)
    dev_args = [torch.from_numpy(a).to(dev) for a in args]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        drip_step.drip_window(*dev_args, scratch, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    kern = drip_batch.DripBatchKernel(device=dev)
    schedulable, weighted, bounded, free, vecs, _ = args
    host_ms = []
    for _ in range(DRIP_TIMED_DISPATCHES + 1):
        t0 = time.perf_counter()
        chosen, _f, _t = kern.dispatch(schedulable, weighted, bounded, free, vecs, want_ties=False)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        for i, c in enumerate(chosen):  # the scheduler's host fold replay
            if c >= 0:
                free[c] -= vecs[i]
        kern.mark_synced(free)
    if kern.free_uploads != 1 or kern.kernel_windows != kern.dispatches:
        raise AssertionError(f"the carry was uploaded {kern.free_uploads} times; "
                             f"{kern.kernel_windows} of {kern.dispatches} windows ran K3")
    out = {
        "nodes": list(DRIP_WINDOW_NODES), "k": DRIP_WINDOW, "cases": len(checked),
        "checked": checked, "equal_to_cpu": True, "first_max": True,
        "no_host_sync_in_window": True,
        "host_ms_per_dispatch": statistics.median(host_ms[1:]),
        "host_ms_per_dispatch_all": host_ms, "free_uploads": kern.free_uploads,
        "graph_replays": kern.graph_replays, "kernel_windows": kern.kernel_windows,
        "check_s": check_s, "timing_s": time.perf_counter() - t_phase - check_s,
    }
    log("drip_window", **out)
    return {"max_abs_err": 0, **out}


def drip_cluster(annos) -> ClusterState:
    cluster = ClusterState()
    for name, anno in annos:
        cluster.add_node(Node(name=name, annotations=dict(anno), allocatable=DRIP_ALLOCATABLE))
    return cluster


def drip_scheduler(cluster: ClusterState, dev, **kw) -> Scheduler:
    """ResourceFit weight 1 and Dynamic weight 3 on a fixed clock."""
    clock = lambda: NOW  # noqa: E731
    sched = Scheduler(cluster, clock=clock, device=dev, **kw)
    tracker = FitTracker(cluster, telemetry=kw.get("telemetry"))
    sched.register(ResourceFitPlugin(tracker), weight=1)
    sched.register(DynamicPlugin(DEFAULT_POLICY, clock=clock), weight=3)
    return sched


def storm(cluster: ClusterState, prefix: str, count: int, cpu: str = "100m") -> list:
    pods = [Pod(name=f"{prefix}-{i:05d}", containers=(Container("c", ResourceRequirements(
        requests={"cpu": cpu, "memory": "128Mi"})),)) for i in range(count)]
    cluster.add_pods(pods)
    return pods


def placements(results) -> list:
    return [(r.node, r.feasible) for r in results]


def phase_drip_queue(dev, annos) -> tuple:
    """``schedule_queue`` (window 128) over the storm against the per-pod
    columnar ``schedule_one`` on a twin cluster, pod for pod."""
    cluster = drip_cluster(annos)
    sched = drip_scheduler(cluster, dev)
    warm = sched.schedule_queue(storm(cluster, "warm", DRIP_WINDOW, cpu="100000"),
                                window=DRIP_WINDOW)
    if any(r.node for r in warm):
        raise AssertionError("a warm-up pod was placed")
    pre = sched.drip_stats()
    pods = storm(cluster, "drip", DRIP_PODS)
    reset_launches()
    t0 = time.perf_counter()
    results = sched.schedule_queue(pods, window=DRIP_WINDOW)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("drip queue", need=("drip",))
    stats = sched.drip_stats()
    kernel_windows = all_kernel_windows(stats, pre, "drip queue")
    binds = sum(r.node is not None for r in results)
    folds = stats["folds"] - pre["folds"]
    if binds != DRIP_PODS or folds != binds or stats["fallbacks"]:
        raise AssertionError(f"drip queue: {binds} binds, {folds} folds, "
                             f"fallbacks {stats['fallbacks']}")
    per_node = np.unique([r.node for r in results], return_counts=True)[1]
    if per_node.max() != int(DRIP_ALLOCATABLE["pods"]):
        raise AssertionError(f"no node filled to its pod cap: {per_node.max()}")

    twin = drip_cluster(annos)
    twin_sched = drip_scheduler(twin, dev)
    t0 = time.perf_counter()
    want = [twin_sched.schedule_one(p) for p in storm(twin, "drip", DRIP_PODS)]
    perpod_ms = (time.perf_counter() - t0) * 1e3
    if placements(results) != placements(want):
        raise AssertionError("schedule_queue placements != per-pod columnar placements")

    kern = sched._batch_kernel
    windows = stats["batch"]["dispatches"] - pre["batch"]["dispatches"]
    extra = iter(range(2))
    prof = profile_windows(lambda: sched.schedule_queue(
        storm(cluster, f"prof{next(extra)}", DRIP_WINDOW), window=DRIP_WINDOW), 1)
    out = {
        "nodes": len(annos), "pods": DRIP_PODS, "window": DRIP_WINDOW,
        "equal_to_perpod": True, "binds": binds, "folds": folds, "fallbacks": 0,
        "nodes_at_pod_cap": int((per_node == int(DRIP_ALLOCATABLE["pods"])).sum()),
        "ms_per_pod": wall_ms / DRIP_PODS, "wall_ms": wall_ms, "windows": windows,
        "stage_ms_per_window": {
            name: (s - pre["batch"]["stage_seconds"][name]) * 1e3 / windows
            for name, s in stats["batch"]["stage_seconds"].items()},
        "free_uploads": kern.free_uploads, "column_uploads": kern._cols.uploads,
        "perpod_ms_per_pod": perpod_ms / DRIP_PODS,
        "profiled_window": {k: prof[k] for k in ("device_us", "wall_us", "device_idle_share",
                                                 "device_kernels", "device_events_seen",
                                                 "top_device_us")},
        "launches": launches, "kernel_windows": kernel_windows,
    }
    log("drip_queue", **out)
    return out, placements(results), launches


def phase_drip_serve(dev, annos, queue_placements) -> tuple:
    """The storm through ``open_queue(window=32)``, one ``offer`` per pod,
    after 16 infeasible warm-up pods, so the last window is half full and
    only ``drain`` dispatches it."""
    cluster = drip_cluster(annos)
    sched = drip_scheduler(cluster, dev)
    queue = sched.open_queue(window=DRIP_SERVE_WINDOW)
    for pod in storm(cluster, "warm", DRIP_SERVE_WINDOW // 2, cpu="100000"):
        queue.offer(pod)
    pods = storm(cluster, "drip", DRIP_PODS)
    reset_launches()
    t0 = time.perf_counter()
    for pod in pods:
        queue.offer(pod)
    drained = queue.drain()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("drip serve", need=("drip",))
    results = queue.take_results()
    if drained != DRIP_SERVE_WINDOW // 2 or any(r.node for r in results[:drained]):
        raise AssertionError(f"drip serve: drained {drained}")
    if placements(results[drained:]) != queue_placements:
        raise AssertionError("open_queue placements != schedule_queue placements")
    stats = sched.drip_stats()
    kernel_windows = all_kernel_windows(stats, None, "drip serve")
    out = {"nodes": len(annos), "pods": DRIP_PODS, "window": DRIP_SERVE_WINDOW,
           "equal_to_queue": True, "drained_tail": drained,
           "ms_per_pod": wall_ms / DRIP_PODS, "wall_ms": wall_ms,
           "windows": stats["batch"]["dispatches"], "folds": stats["folds"],
           "fallbacks": stats["fallbacks"], "free_uploads": sched._batch_kernel.free_uploads,
           "launches": launches, "kernel_windows": kernel_windows}
    log("drip_serve", **out)
    return out, launches


def phase_drip_scalar(dev) -> dict:
    """The scalar plugin loop against ``schedule_queue`` at 2,000 nodes,
    unseeded and with a seeded tie-break (quantized annotations make real
    ties, so seeded windows replay per-pod). The queue legs' schedulers come
    from ``build_scheduler_from_config`` over a configuration built here."""
    rng = np.random.default_rng(SEED + 1)
    fresh = format_local_time(NOW - 30.0)
    metrics = compile_policy(DEFAULT_POLICY).metric_names
    # two levels per metric: about 31 nodes share the top score, so the
    # windows hold real ties
    values = rng.choice([0.1, 0.2], (DRIP_SCALAR_NODES, len(metrics)))
    annos = [(f"node-{i:05d}", {m: f"{values[i, k]:.5f},{fresh}" for k, m in enumerate(metrics)})
             for i in range(DRIP_SCALAR_NODES)]
    config = SchedulerConfiguration(profiles=(SchedulerProfile(
        filter_enabled=("Dynamic",), score_enabled=(PluginWeight("Dynamic", 3),)),))
    legs = {}
    reset_launches()
    for seed in (None, 7):
        cluster = drip_cluster(annos)
        scalar = drip_scheduler(cluster, dev, columnar=False, tie_break_seed=seed)
        t0 = time.perf_counter()
        want = [scalar.schedule_one(p) for p in storm(cluster, "p", DRIP_SCALAR_PODS)]
        scalar_ms = (time.perf_counter() - t0) * 1e3
        cluster = drip_cluster(annos)
        queued = build_scheduler_from_config(cluster, config, clock=lambda: NOW,
                                             policy=DEFAULT_POLICY, tie_break_seed=seed,
                                             device=dev)
        if [(type(wp.plugin), wp.weight) for wp in queued._plugins] != [
                (ResourceFitPlugin, 1), (DynamicPlugin, 3)]:
            raise AssertionError("build_scheduler_from_config registered other plugins")
        got = queued.schedule_queue(storm(cluster, "p", DRIP_SCALAR_PODS), window=16)
        if placements(got) != placements(want):
            raise AssertionError(f"scalar loop != schedule_queue (tie_break_seed={seed})")
        stats = queued.drip_stats()["batch"]
        if seed is not None and (stats["replays"] == 0
                                 or queued._tie_rng.getstate() != scalar._tie_rng.getstate()):
            raise AssertionError("the seeded leg did not replay, or consumed other RNG")
        legs[f"seed_{seed}"] = {"scalar_ms_per_pod": scalar_ms / DRIP_SCALAR_PODS,
                                "windows": stats["dispatches"], "replays": stats["replays"],
                                "distinct_nodes": len({r.node for r in got})}
    launches = read_launches("drip scalar", need=())
    out = {"nodes": DRIP_SCALAR_NODES, "pods": DRIP_SCALAR_PODS, "scalar_equal_to_queue": True,
           "from_config": True, **legs, "launches": launches}
    log("drip_scalar", **out)
    return launches


# -- telemetry on both paths ------------------------------------------------------

def span_counts(tel: Telemetry) -> dict:
    counts: dict = {}
    for e in tel.export_chrome_trace()["traceEvents"]:
        if e["ph"] == "X":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def check_exposition(tel: Telemetry) -> int:
    """Both renders pass the strict parser; returns the family count."""
    families = expfmt.parse_exposition(tel.render_prometheus())
    expfmt.parse_exposition(tel.render_prometheus(openmetrics=True))
    return len(families)


def phase_telemetry_burst(annos) -> tuple:
    """Interleaved warm bursts with telemetry on and off, on one cluster
    and one clock; then one traced burst under ``torch_trace``."""
    import pathlib

    tel = Telemetry()
    clock = Clock(NOW)
    cluster = build_cluster(annos)
    scheds = {
        "on": BatchScheduler(cluster, DEFAULT_POLICY, dtype=torch.float32, clock=clock,
                             telemetry=tel),
        "off": BatchScheduler(cluster, DEFAULT_POLICY, dtype=torch.float32, clock=clock),
    }
    if scheds["off"]._telemetry is not None:
        raise AssertionError("the scheduler without telemetry picked one up")
    reset_launches()
    ms = {"on": [], "off": []}
    for k in range(TELEMETRY_BURSTS + 1):  # burst 0 is cold on both
        clock.t = NOW + 12.0 * k
        placed = {}
        for mode in (("on", "off") if k % 2 == 0 else ("off", "on")):
            sched = scheds[mode]
            names = [f"tel-{mode}{k}-{i}" for i in range(BURST_PODS)]
            t0 = time.perf_counter()
            result = sched.schedule_pod_burst("telemetry", names)
            ms[mode].append((time.perf_counter() - t0) * 1e3)
            parity_check(sched, result, BURST_PODS)
            if result.n_assigned != BURST_PODS:
                raise AssertionError(f"telemetry {mode} burst {k}: {result.n_assigned} placed")
            placed[mode] = np.asarray(result.node_idx)
        if not np.array_equal(placed["on"], placed["off"]):
            raise AssertionError(f"telemetry burst {k}: placements differ with telemetry on")
    spans = span_counts(tel)
    missing = [name for name in BURST_SPANS if not spans.get(name)]
    if missing:
        raise AssertionError(f"the span trace lacks {missing}: {spans}")
    families = check_exposition(tel)
    snap = tel.registry.snapshot()
    stats = scheds["on"].refresh_stats
    paths = sum(v for key, v in snap.items() if key.startswith("crane_refresh_path_total"))
    if paths != sum(stats[p] for p in ("hit", "columns", "delta", "full")):
        raise AssertionError(f"crane_refresh_path_total {paths} != refresh_stats {stats}")
    decisions = tel.decisions.snapshot()
    if len(decisions) != TELEMETRY_BURSTS + 1 or any(
            d["source"] != "burst" or len(d["top_scores"]) != 5 for d in decisions):
        raise AssertionError(f"{len(decisions)} decision traces for {TELEMETRY_BURSTS + 1} bursts")

    # more traced bursts under torch.profiler, with the span trace beside them
    out_dir = pathlib.Path(TELEMETRY_OUT)
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.json"):
        old.unlink()
    traced_ms = []
    before = {name: kernel.launches for name, kernel in KERNELS.items()}
    with chrome_trace(tel.spans, str(out_dir / "spans.json")):
        with torch_trace(str(out_dir)) as prof:
            for k in range(TELEMETRY_TRACED_BURSTS):
                clock.t += 12.0
                names = [f"tel-traced{k}-{i}" for i in range(BURST_PODS)]
                t0 = time.perf_counter()
                scheds["on"].schedule_pod_burst("telemetry", names)
                traced_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    (trace_file,) = out_dir.glob("*.pt.trace.json")
    device_trace = json.loads(trace_file.read_text())["traceEvents"]
    kernels_seen = {
        name: sum(1 for e in device_trace if e.get("cat") == "kernel" and name in e.get("name", ""))
        for name in ("score_nodes_kernel", "gang_totals_kernel")
    }
    traced_launches = {name: kernel.launches - before[name] for name, kernel in KERNELS.items()}
    if not all(kernels_seen.values()):
        raise AssertionError(f"the torch trace lacks a kernel: {kernels_seen}, "
                             f"launched {traced_launches}")
    launches = read_launches("telemetry")
    warm = {mode: ms[mode][1:] for mode in ms}
    med = {mode: statistics.median(warm[mode]) for mode in warm}
    out = {
        "nodes": N_NODES, "pods_per_burst": BURST_PODS, "bursts_each": TELEMETRY_BURSTS + 1,
        "parity": "ok", "placements_equal_on_off": True,
        "warm_median_ms_on": med["on"], "warm_median_ms_off": med["off"],
        "overhead_ms": med["on"] - med["off"],
        "pairwise_overhead_median_ms": statistics.median(
            a - b for a, b in zip(warm["on"], warm["off"])),
        "ms_per_burst_on": ms["on"], "ms_per_burst_off": ms["off"],
        "spans": spans, "families": families, "decisions": len(decisions),
        "refresh_stats": dict(stats), "traced_burst_ms": traced_ms,
        "trace_files": sorted(p.name for p in out_dir.glob("*.json")),
        "device_trace_kernels": kernels_seen, "traced_launches": traced_launches,
        "device_trace_events": len(device_trace),
        "profiled_device_us": {
            e.key[:40]: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and ("score_nodes" in e.key or "gang_totals" in e.key)
        },
        "launches": launches,
    }
    log("telemetry_burst", **out)
    return out, launches


def drip_storm_ms(dev, annos, tel) -> tuple:
    """config 15's storm after its warm-up window, on a fresh cluster:
    (scheduler, cluster, results, wall ms of the storm)."""
    cluster = drip_cluster(annos)
    sched = drip_scheduler(cluster, dev, telemetry=tel)
    sched.schedule_queue(storm(cluster, "warm", DRIP_WINDOW, cpu="100000"), window=DRIP_WINDOW)
    pods = storm(cluster, "drip", DRIP_PODS)
    t0 = time.perf_counter()
    results = sched.schedule_queue(pods, window=DRIP_WINDOW)
    return sched, cluster, results, (time.perf_counter() - t0) * 1e3


def window_ms(sched: Scheduler, cluster: ClusterState, tag: str) -> float:
    pods = storm(cluster, tag, DRIP_WINDOW)
    t0 = time.perf_counter()
    results = sched.schedule_queue(pods, window=DRIP_WINDOW)
    wall = (time.perf_counter() - t0) * 1e3
    if sum(r.node is not None for r in results) != DRIP_WINDOW:
        raise AssertionError(f"{tag}: a pod of the window was not placed")
    return wall


def phase_telemetry_drip(dev, annos, queue_placements) -> dict:
    """The drip storm with telemetry at a stride of 128 and without, then
    one window traced at a stride of 1 under the sync debug mode."""
    off, off_cluster, off_results, off_ms = drip_storm_ms(dev, annos, None)
    tel = Telemetry(decision_sample_every=TELEMETRY_DRIP_STRIDE)
    on, on_cluster, on_results, on_ms = drip_storm_ms(dev, annos, tel)
    # the same with decision traces sampled out (only the first offer, a
    # warm-up pod's, is built): the lifecycle, spans and counters alone
    _, _, bare_results, bare_ms = drip_storm_ms(
        dev, annos, Telemetry(decision_sample_every=1 << 30))
    for mode, results in (("off", off_results), ("on", on_results), ("bare", bare_results)):
        if placements(results) != queue_placements:
            raise AssertionError(f"telemetry drip ({mode}): placements != drip_queue's")
    # one decision entry of the storm's last pod, built five times
    build = Scheduler._decision_builder(on_results[-1])
    build_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        entry = build()
        build_ms.append((time.perf_counter() - t0) * 1e3)
    if len(entry["top_scores"]) != 5:
        raise AssertionError(f"a drip decision holds {entry['top_scores']}")
    snap = tel.registry.snapshot()
    scheduled = snap.get('crane_drip_decisions_total{outcome="scheduled"}')
    windows = on.drip_stats()["batch"]["dispatches"]
    observed = snap.get("crane_drip_batch_pods_count")
    if scheduled != DRIP_PODS or observed != windows or windows != DRIP_PODS // DRIP_WINDOW + 1:
        raise AssertionError(f"drip telemetry: {scheduled} scheduled, {observed} window "
                             f"observations for {windows} windows")
    storm_decisions = tel.decisions.stats()
    families = check_exposition(tel)
    # every pod's decision traced: the stride the reference defaults to
    stride128 = tel.decisions
    tel.decisions = DecisionTraceBuffer(capacity=DRIP_WINDOW, sample_every=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stride1_ms = window_ms(on, on_cluster, "stride1")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    traced = tel.decisions.stats()["recorded"]
    if traced != DRIP_WINDOW:
        raise AssertionError(f"the stride-1 window traced {traced} decisions")
    tel.decisions = stride128
    out = {
        "nodes": len(annos), "pods": DRIP_PODS, "window": DRIP_WINDOW,
        "stride": TELEMETRY_DRIP_STRIDE, "placements_equal_to_drip_queue": True,
        "ms_per_pod_on": on_ms / DRIP_PODS, "ms_per_pod_off": off_ms / DRIP_PODS,
        "ms_per_pod_on_no_decisions": bare_ms / DRIP_PODS,
        "wall_ms_on": on_ms, "wall_ms_off": off_ms, "windows": windows,
        "decision_build_ms": build_ms,
        "scheduled_decisions": scheduled, "storm_decisions": storm_decisions,
        "families": families, "spans": span_counts(tel),
        "stride1_window_ms": stride1_ms, "stride1_no_host_sync": True,
        "stride128_window_ms": window_ms(on, on_cluster, "stride128"),
        "off_window_ms": window_ms(off, off_cluster, "offwin"),
    }
    log("telemetry_drip", **out)
    return out


# -- the dirty-name journal and the gang queue ----------------------------------

def phase_drip_dirty(dev, annos, queue_placements, queue_ms_per_pod: float) -> tuple:
    """drip_queue's storm with one named annotation patch every 8 windows,
    on a node among those filling up, against a twin's per-pod columnar
    ``schedule_one`` with the same patches before the same pods. Each patch
    must ride the dirty-name journal: no identity sweep after the first
    window, one dirty row per patch, and the dynamic columns reach the
    device as row scatters, not uploads."""
    tel = Telemetry(decision_sample_every=1 << 30)  # counters only, no decision traces
    cluster = drip_cluster(annos)
    sched = drip_scheduler(cluster, dev, telemetry=tel)
    sched.schedule_queue(storm(cluster, "warm", DRIP_WINDOW, cpu="100000"), window=DRIP_WINDOW)
    pre = sched.drip_stats()
    kern = sched._batch_kernel
    pods = storm(cluster, "drip", DRIP_PODS)
    chunk = DRIP_DIRTY_EVERY * DRIP_WINDOW
    metric = compile_policy(DEFAULT_POLICY).metric_names[0]
    value = f"0.10000,{format_local_time(NOW - 30.0)}"  # low usage: stays schedulable
    patches, results, cache = [], [], []
    reset_launches()
    t0 = time.perf_counter()
    for start in range(0, DRIP_PODS, chunk):
        if start:
            node = results[-1].node  # the node the last pod went to: filling up
            cluster.patch_node_annotation(node, metric, value)
            patches.append((start, node))
            before = (kern._cols.uploads, kern._cols.scatters)
        results.extend(sched.schedule_queue(pods[start:start + chunk], window=DRIP_WINDOW))
        if start:
            cache.append({"uploads": kern._cols.uploads - before[0],
                          "scatters": kern._cols.scatters - before[1]})
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("drip dirty", need=())
    stats = sched.drip_stats()

    twin = drip_cluster(annos)
    twin_sched = drip_scheduler(twin, dev)
    twin_pods = storm(twin, "drip", DRIP_PODS)
    todo = dict(patches)
    want = []
    for i, pod in enumerate(twin_pods):
        if i in todo:
            twin.patch_node_annotation(todo[i], metric, value)
        want.append(twin_sched.schedule_one(pod))
    if placements(results) != placements(want):
        raise AssertionError("drip dirty: schedule_queue placements != per-pod placements")
    n_patch = len(patches)
    dirty_metric = tel.registry.snapshot().get('crane_dirty_rows_total{consumer="drip"}', 0)
    if stats["full_sweeps"] != pre["full_sweeps"]:
        raise AssertionError(f"drip dirty: {stats['full_sweeps'] - pre['full_sweeps']} "
                             "identity sweeps during the storm")
    if stats["dirty_patches"] != n_patch or stats["dirty_rows"] != n_patch or dirty_metric <= 0:
        raise AssertionError(f"drip dirty: {n_patch} patches, dirty_patches "
                             f"{stats['dirty_patches']}, dirty_rows {stats['dirty_rows']}, "
                             f"crane_dirty_rows_total {dirty_metric}")
    if any(c["uploads"] != 0 or c["scatters"] != 2 for c in cache):
        raise AssertionError(f"drip dirty: the dynamic columns did not scatter: {cache}")
    if sum(r.node is not None for r in results) != DRIP_PODS:
        raise AssertionError("drip dirty: a pod of the storm was not placed")
    out = {"nodes": len(annos), "pods": DRIP_PODS, "window": DRIP_WINDOW,
           "patches": n_patch, "patched_nodes": [p[1] for p in patches],
           "equal_to_perpod": True, "differs_from_drip_queue": placements(results) != queue_placements,
           "full_sweeps_during_storm": 0, "dirty_patches": stats["dirty_patches"],
           "dirty_rows": stats["dirty_rows"], "crane_dirty_rows_total_drip": dirty_metric,
           "column_cache_per_patch": cache, "free_uploads": kern.free_uploads,
           "ms_per_pod": wall_ms / DRIP_PODS, "drip_queue_ms_per_pod": queue_ms_per_pod,
           "wall_ms": wall_ms, "windows": stats["batch"]["dispatches"] - pre["batch"]["dispatches"],
           "telemetry": "counters and spans on, decision traces sampled out",
           "launches": launches}
    log("drip_dirty", **out)
    return out, launches


def time_methods(obj, names) -> dict:
    """Wrap each named method of ``obj`` (on the instance) to sum its host
    ms into the returned dict."""
    spent = dict.fromkeys(names, 0.0)

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += (time.perf_counter() - t0) * 1e3
        return timed

    for name in names:
        setattr(obj, name, wrap(name, getattr(obj, name)))
    return spent


def gang_cluster(n: int) -> ClusterState:
    """config 22's cluster: 8 annotation variants, one allocatable."""
    ts = format_local_time(NOW - 20.0)
    metrics = compile_policy(DEFAULT_POLICY).metric_names
    variants = [{m: f"{0.20 + 0.01 * ((j + k) % 11):.5f},{ts}" for k, m in enumerate(metrics)}
                for j in range(8)]
    cluster = ClusterState()
    for i in range(n):
        cluster.add_node(Node(name=f"node-{i:05d}", annotations=variants[i % 8],
                              allocatable=DRIP_ALLOCATABLE))
    return cluster


def gang_template(name: str, cpu_milli: int) -> Pod:
    return Pod(name=name, containers=(Container("c", ResourceRequirements(
        requests={"cpu": f"{cpu_milli}m", "memory": "256Mi"})),))


def gang_requests(tag: str) -> list:
    return [(gang_template(f"g22-{tag}-{j:03d}", cpu), count)
            for j, (cpu, count) in enumerate(GANG_SHAPES)]


def gang_scheduler(cluster: ClusterState, dev, dtype=torch.float32) -> BatchScheduler:
    return BatchScheduler(cluster, DEFAULT_POLICY, dtype=dtype, clock=lambda: NOW, device=dev)


def counts_of(assignments: dict, pos: dict, n: int) -> np.ndarray:
    got = np.zeros(n, np.int64)
    for node in assignments.values():
        got[pos[node]] += 1
    return got


def phase_gang_queue(dev) -> tuple:
    """config 22 at 50,000 nodes: 24 heterogeneous gangs through a
    sequential ``schedule_gang`` loop (K1 and K2 per gang), the same gangs
    through ``schedule_gang_queue(window=8)`` on a twin (K2 per gang of a
    device window), each window gang through ``gang_window_host`` and the
    window's own plain version on CPU tensors, the first two through
    ``gang_assign_oracle``; one named patch's ``ensure()`` against the
    identity sweep; one profiled window; a ``schedule_batch_mixed`` burst of
    the same pods as pending pods, float32 hybrid against float64."""
    from crane_scheduler_tpu_torch.fit.tracker import (
        copy_counts_rows, pod_fit_request, request_vec)
    from crane_scheduler_tpu_torch.scorer import gang_batch
    from crane_scheduler_tpu_torch.scorer.topk import gang_assign_oracle

    total = sum(c for _, c in GANG_SHAPES)
    max_offset = 100 * GANG_TOPO_W
    by_path = {}
    # -- sequential: one schedule_gang per gang, its stages timed
    t0 = time.perf_counter()
    seq = gang_scheduler(gang_cluster(N_NODES), dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    seq_stage_ms = time_methods(seq, ("refresh", "_prepare", "_fit_capacity", "_build_result",
                                      "_bind_gang_with_recovery"))
    reset_launches()
    t0 = time.perf_counter()
    seq_out = []
    for t, c in gang_requests("g"):
        r = seq.schedule_gang(t, c, bind=True, dynamic_weight=GANG_DYN_W,
                              topology_weight=GANG_TOPO_W)
        if r.unassigned:
            raise AssertionError(f"sequential gang {t.name}: {len(r.unassigned)} unplaced")
        seq_out.append(dict(r.assignments))
    seq_ms = (time.perf_counter() - t0) * 1e3
    seq_stage_ms["rest"] = seq_ms - sum(seq_stage_ms.values())
    by_path["gang_seq"] = read_launches("gang sequential")
    if by_path["gang_seq"] != {"score": len(GANG_SHAPES), "gang": len(GANG_SHAPES), "drip": 0}:
        raise AssertionError(f"gang sequential: {by_path['gang_seq']} launches for "
                             f"{len(GANG_SHAPES)} gangs")

    # -- window: a warm-up window of infeasible gangs, then the storm
    cluster = gang_cluster(N_NODES)
    win = gang_scheduler(cluster, dev)
    warm = [(gang_template(f"g22-warm-{i}", 100_000 + 1000 * i), 1) for i in range(GANG_WINDOW)]
    t0 = time.perf_counter()
    warm_out = win.schedule_gang_queue(warm, window=GANG_WINDOW, dynamic_weight=GANG_DYN_W,
                                       topology_weight=GANG_TOPO_W)
    warm_ms = (time.perf_counter() - t0) * 1e3
    if any(o.assignments for o in warm_out):
        raise AssertionError("a warm-up gang was placed")
    pre = win.gang_stats()
    reqs = gang_requests("g")
    reset_launches()
    t0 = time.perf_counter()
    win_out = win.schedule_gang_queue(reqs, window=GANG_WINDOW, dynamic_weight=GANG_DYN_W,
                                      topology_weight=GANG_TOPO_W)
    win_ms = (time.perf_counter() - t0) * 1e3
    by_path["gang_window"] = read_launches("gang window", need=("gang",))
    stats = win.gang_stats()
    if stats["fallbacks"] or any(o.source != "window" for o in win_out):
        raise AssertionError(f"gang window fell back: {stats['fallbacks']}")
    placed = sum(len(o.assignments) for o in win_out)
    if placed != total or [dict(o.assignments) for o in win_out] != seq_out:
        raise AssertionError(f"gang window: {placed}/{total} placed, or placements != "
                             "the sequential loop's")
    if by_path["gang_window"]["gang"] != len(GANG_SHAPES):
        raise AssertionError(f"gang window: {by_path['gang_window']} launches")

    # -- oracle: the engine's own columns, capacity un-folded by hand
    eng = win._gang_engine
    cols = eng["cols"]
    cols.ensure(NOW)
    names = cols.names
    pos = {name: i for i, name in enumerate(names)}
    free0 = cols.free.copy()
    vecs = [request_vec(pod_fit_request(t)) for t, _ in reqs]
    for o, vec in zip(win_out, vecs):
        for node in o.assignments.values():
            free0[pos[node]] += vec
    gangs = [(c, vec, None) for (_, c), vec in zip(reqs, vecs)]
    hv = win.tensors.hv_count
    t0 = time.perf_counter()
    host, _ = gang_batch.gang_window_host(cols.score, cols.schedulable, cols.bounded, free0,
                                          gangs, hv, dynamic_weight=GANG_DYN_W,
                                          max_offset=max_offset)
    host_ms = (time.perf_counter() - t0) * 1e3
    # the window's plain version: the same loop on CPU tensors (the gang
    # totals kernel's plain version), three windows with the carry kept
    plain = gang_batch.GangBatchKernel(hv, GANG_DYN_W, max_offset, device="cpu")
    free_p = free0.copy()
    plain_counts = []
    t0 = time.perf_counter()
    for w0 in range(0, len(gangs), GANG_WINDOW):
        part = gangs[w0:w0 + GANG_WINDOW]
        classes = {}
        cid = [classes.setdefault(v.tobytes(), len(classes)) for _, v, _ in part]
        cvecs = np.stack([np.frombuffer(k, np.int64) for k in classes])
        counts_m, _u, _w = plain.dispatch(cols.score, cols.schedulable, cols.bounded, free_p,
                                          cvecs, None, np.asarray(cid, np.int32),
                                          np.asarray([c for c, _, _ in part], np.int64))
        for j, (_, vec, _) in enumerate(part):
            free_p = free_p - counts_m[j].astype(np.int64)[:, None] * vec[None, :]
        plain.mark_synced(free_p)
        plain_counts.extend(counts_m)
    plain_ms = (time.perf_counter() - t0) * 1e3
    free_c = free0.copy()
    oracle_ms = []
    for j, (o, (c, vec, _)) in enumerate(zip(win_out, gangs)):
        got = counts_of(o.assignments, pos, len(names))
        if not (np.array_equal(got, host[j].counts) and np.array_equal(got, plain_counts[j])):
            raise AssertionError(f"gang {j}: the window != gang_window_host / its plain version")
        if j < GANG_ORACLE_GANGS:
            t0 = time.perf_counter()
            orc = gang_assign_oracle(cols.score, cols.schedulable, c, hv,
                                     capacity=copy_counts_rows(free_c, cols.bounded, vec),
                                     dynamic_weight=GANG_DYN_W, max_offset=max_offset)
            oracle_ms.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(got, orc.counts):
                raise AssertionError(f"gang {j}: the window != gang_assign_oracle")
        free_c -= got[:, None] * vec[None, :]

    # -- dirty: one named patch's ensure() against the identity sweep
    def patch(name):
        node = cluster.get_node(name)
        key = next(iter(node.annotations))
        cluster.patch_node_annotation(name, key, node.annotations[key].replace("0.2", "0.3", 1))

    pre_cols = dict(cols.stats)
    dirty_ms = []
    for name in ("node-00017", "node-00019"):  # the first also recounts the last binds
        patch(name)
        t0 = time.perf_counter()
        cols.ensure(NOW)
        dirty_ms.append((time.perf_counter() - t0) * 1e3)
    if cols.stats["dirty_patches"] != pre_cols["dirty_patches"] + 2:
        raise AssertionError("a named patch did not take the journal path")
    patch("node-00018")
    cluster.forget_dirty_names()
    t0 = time.perf_counter()
    cols.ensure(NOW)
    sweep_ms = (time.perf_counter() - t0) * 1e3
    if cols.stats["full_sweeps"] != pre_cols["full_sweeps"] + 1:
        raise AssertionError("forget_dirty_names did not force the identity sweep")

    # -- one profiled window, no host synchronisation inside it
    extra = iter(range(4))

    def one_window():
        outs = win.schedule_gang_queue(gang_requests(f"p{next(extra)}")[:GANG_WINDOW],
                                       window=GANG_WINDOW, dynamic_weight=GANG_DYN_W,
                                       topology_weight=GANG_TOPO_W)
        if sum(len(o.assignments) for o in outs) != sum(c for _, c in GANG_SHAPES[:GANG_WINDOW]):
            raise AssertionError("a profiled window left pods unplaced")

    one_window()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one_window()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reset_launches()
    prof = profile_windows(one_window, 1)
    k2_per_gang = gang_kernel.KERNEL.launches / (2 * GANG_WINDOW)  # warm call + profiled call

    # -- mixed: the same pods as pending pods, one burst, f32 hybrid vs f64
    mixed = {}
    for label, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        mcluster = gang_cluster(N_NODES)
        msched = gang_scheduler(mcluster, dev, dtype=dtype)
        pending = [Pod(name=f"{t.name}-{i}", containers=t.containers)
                   for t, c in gang_requests("m") for i in range(c)]
        mcluster.add_pods(pending)
        if label == "f32":
            reset_launches()
        t0 = time.perf_counter()
        r = msched.schedule_batch_mixed(pending, dynamic_weight=GANG_DYN_W,
                                        topology_weight=GANG_TOPO_W)
        mixed[label] = ((time.perf_counter() - t0) * 1e3, r)
        if label == "f32":
            by_path["gang_mixed"] = read_launches("gang mixed")
    if mixed["f32"][1].assignments != mixed["f64"][1].assignments or \
            len(mixed["f32"][1].assignments) != total:
        raise AssertionError("schedule_batch_mixed: f32 hybrid != float64, or pods unplaced")

    windows = stats["windows"] - pre["windows"]
    dispatch_s = stats["kernel_seconds"][-windows:]
    out = {
        "nodes": N_NODES, "gangs": len(GANG_SHAPES), "pods": total, "window": GANG_WINDOW,
        "dynamic_weight": GANG_DYN_W, "topology_weight": GANG_TOPO_W,
        "placements_equal": ["sequential", "window", "gang_window_host", "plain_window",
                             f"oracle (first {GANG_ORACLE_GANGS})"],
        "seq_ms_per_gang": seq_ms / len(GANG_SHAPES),
        "seq_stage_ms_per_gang": {k: v / len(GANG_SHAPES) for k, v in seq_stage_ms.items()},
        "window_ms_per_gang": win_ms / len(GANG_SHAPES),
        "host_twin_ms_per_gang": host_ms / len(GANG_SHAPES),
        "plain_window_cpu_ms_per_gang": plain_ms / len(GANG_SHAPES),
        "oracle_ms_per_gang": oracle_ms, "warmup_window_ms": warm_ms,
        "speedup_window_vs_seq": seq_ms / win_ms,
        "dispatch_host_ms_per_window": [s * 1e3 for s in dispatch_s],
        "windows": windows, "kernel_dispatches": stats["kernel_dispatches"],
        "free_uploads": stats["free_uploads"], "columns": stats["columns"],
        "dirty_ensure_ms": dirty_ms, "swept_ensure_ms": sweep_ms,
        "profiled_window": {k: prof[k] for k in (
            "device_us", "wall_us", "device_idle_share", "device_kernels",
            "cuda_launch_kernel_calls", "device_events_seen", "top_device_us")},
        "k2_launches_per_gang_in_window": k2_per_gang, "no_host_sync_in_window": True,
        "mixed_ms": {k: v[0] for k, v in mixed.items()}, "mixed_f32_equal_to_f64": True,
        "cluster_build_ms": build_ms, "launches": by_path,
    }
    log("gang_queue", **out)
    return out, by_path


# -- NUMA on the gang paths -----------------------------------------------------

def numa_awareness(j: int) -> str | None:
    """Every third template (1-based) asks for NUMA awareness, every sixth
    refuses it, the rest leave it to the node's policy."""
    k = j + 1
    return "false" if k % 6 == 0 else "true" if k % 3 == 0 else None


def numa_template(name: str, cpu_milli: int, aware: str | None) -> Pod:
    """A guaranteed pod (requests equal to limits, whole cores)."""
    req = {"cpu": f"{cpu_milli}m", "memory": "1Gi"}
    return Pod(name=name, annotations={} if aware is None else {NUMA_AWARE: aware},
               containers=(Container("c", ResourceRequirements(requests=req,
                                                               limits=dict(req))),))


def numa_requests(tag: str) -> list:
    return [(numa_template(f"numa-{tag}-{j:03d}", cpu, numa_awareness(j)), count)
            for j, (cpu, count) in enumerate(NUMA_SHAPES)]


def numa_world(n: int) -> tuple:
    """One NRT CR per node (two 8-core zones; ``None`` CPU policy on
    ``i % 50 == 3``, node-aware on ``i % 4 == 0``, no CR on ``i % 100 ==
    7``) as plain mappings, and one bound background pod per node whose
    topology result uses 0, 2, 4, 6 or 8 cores of one zone or splits them
    across both, from the seed (zone 0 overcommitted at 9 cores on ``i %
    200 == 11``)."""
    rng = np.random.default_rng(SEED + 7)
    used = rng.choice([0, 2000, 4000, 6000, 8000], n)
    split = rng.random(n) < 0.25
    zone = rng.integers(0, 2, n)
    zones = [{"name": f"numa-{j}", "type": "Node", "resources": {"allocatable": {
        "cpu": "8000m", "memory": "32Gi", "ephemeral-storage": "50Gi"}}} for j in range(2)]
    crs, background = [], []
    for i in range(n):
        name = f"node-{i:05d}"
        if i % 100 != 7:
            crs.append({"name": name,
                        "cpu_manager_policy": "None" if i % 50 == 3 else "Static",
                        "topology_manager_policy":
                            "SingleNUMANodePodLevel" if i % 4 == 0 else "None",
                        "zones": zones})
        u = 9000 if i % 200 == 11 else int(used[i])
        if u == 9000:
            parts = [("numa-0", u)]
        elif split[i]:
            parts = [("numa-0", u // 2), ("numa-1", u - u // 2)]
        else:
            parts = [(f"numa-{int(zone[i])}", u)]
        raw = json.dumps([{"name": z, "type": "Node", "resources": {"capacity": {
            "cpu": f"{c}m"}}} for z, c in parts if c], separators=(",", ":"))
        background.append((name, u, raw))
    return crs, background


def numa_cluster(n: int, world) -> ClusterState:
    """config 22's cluster with the world's background pods bound."""
    cluster = gang_cluster(n)
    pods = []
    for name, u, raw in world[1]:
        req = {"cpu": f"{u}m", "memory": "1Gi"}
        pods.append(Pod(name=f"bg-{name}", node_name=name,
                        annotations={NUMA_RESULT: raw} if u else {},
                        containers=(Container("c", ResourceRequirements(
                            requests=req, limits=dict(req))),)))
    cluster.add_pods(pods)
    return cluster


def numa_scheduler(cluster: ClusterState, world, dev, dtype=torch.float32):
    from crane_scheduler_tpu_torch.convert import nrt_lister_from_crs
    from crane_scheduler_tpu_torch.topology import TopologyMatch

    sched = gang_scheduler(cluster, dev, dtype=dtype)
    return sched, TopologyMatch(nrt_lister_from_crs(world[0]), cluster=cluster)


def gang_pods(cluster: ClusterState, prefix: str = "numa-") -> dict:
    """Every pod of the gangs: node and topology-result annotation."""
    return {p.key(): (p.node_name, p.annotations.get(NUMA_RESULT))
            for p in cluster.list_pods() if p.name.startswith(prefix)}


def assumed(topo) -> dict:
    return {k: json.dumps([z.to_wire() for z in v]) for k, v in topo.cache._topology.items()}


NUMA_STAGES = ("refresh", "_prepare", "_fit_capacity", "_numa_vectors",
               "_numa_vectors_uncached", "_numa_rows_update", "_build_result",
               "_bind_gang_with_recovery")


def numa_gang_loop(sched, topo, reqs, check=None) -> tuple:
    """The sequential ``schedule_gang(topology=, bind=True)`` loop with
    host ms per stage of each gang; ``check(template)`` runs after each
    gang, outside the timers."""
    spent = time_methods(sched, NUMA_STAGES)
    results, per_gang = [], []
    for t, c in reqs:
        before = dict(spent)
        rows0 = sched.numa_incremental_rows
        launches0 = (score_kernel.KERNEL.launches, gang_kernel.KERNEL.launches)
        t0 = time.perf_counter()
        r = sched.schedule_gang(t, c, topology=topo, bind=True, dynamic_weight=GANG_DYN_W,
                                topology_weight=GANG_TOPO_W)
        ms = (time.perf_counter() - t0) * 1e3
        d = {k: spent[k] - before[k] for k in NUMA_STAGES}
        outer = ("refresh", "_prepare", "_fit_capacity", "_numa_vectors", "_build_result",
                 "_bind_gang_with_recovery")
        per_gang.append({
            "ms": ms, "full_build_ms": d["_numa_vectors_uncached"],
            "incremental_ms": d["_numa_rows_update"],
            "incremental_rows": sched.numa_incremental_rows - rows0,
            "numa_vectors_ms": d["_numa_vectors"], "bind_ms": d["_bind_gang_with_recovery"],
            "refresh_ms": d["refresh"], "fit_ms": d["_fit_capacity"],
            "build_result_ms": d["_build_result"],
            "step_ms": ms - sum(d[k] for k in outer),
            "k1": score_kernel.KERNEL.launches - launches0[0],
            "k2": gang_kernel.KERNEL.launches - launches0[1],
            "placed": len(r.assignments), "unassigned": len(r.unassigned),
        })
        results.append(r)
        if check is not None:
            check(t)
    return results, per_gang


def numa_wrappers(world, topo, n: int) -> tuple:
    """The enforced rows of a full build at 50,000 x 2: one wrapper per
    node with a Static CR, its background pod accounted."""
    from crane_scheduler_tpu_torch.framework.types import CycleState, NodeInfo

    state = CycleState()
    topo.pre_filter(state, numa_template("probe", 2000, None))
    s = topo._get_state(state)
    bg = {name: Pod(name=f"bg-{name}", node_name=name,
                    annotations={NUMA_RESULT: raw} if u else {})
          for name, u, raw in world[1]}
    wrappers = []
    for i in range(n):
        name = f"node-{i:05d}"
        try:
            nrt = topo.lister.get(name)
        except KeyError:
            continue
        if nrt.crane_manager_policy.cpu_manager_policy != "Static":
            continue
        wrappers.append(topo._initialize_node_wrapper(
            s, NodeInfo(node=Node(name=name), pods=[bg[name]]), nrt))
    return wrappers, s.target_container_resource


def numa_random_wrappers(z: int, n: int, rng) -> list:
    """Random zones at ``z`` per node: allocatable CPU at whole cores, one
    milli-core either side of them or anywhere, used CPU up to
    overcommitted, memory and ephemeral storage in bytes."""
    from crane_scheduler_tpu_torch.topology.helper import new_node_wrapper
    from crane_scheduler_tpu_torch.topology.types import Zone, ZoneResourceInfo

    out = []
    for i in range(n):
        zones = []
        for j in range(int(rng.integers(1, z + 1))):
            cores = int(rng.integers(1, 17)) * 1000
            cpu = cores + int(rng.choice([0, 0, -1, 1, int(rng.integers(-999, 1000))]))
            zones.append(Zone(f"numa-{j}", resources=ZoneResourceInfo(allocatable={
                "cpu": f"{max(cpu, 0)}m", "memory": str(int(rng.integers(1, 65)) << 30),
                "ephemeral-storage": str(int(rng.integers(0, 101)) << 30)})))
        nw = new_node_wrapper(f"r{i}", frozenset({"cpu"}), zones, lambda p: [])
        for nn in nw.numa_nodes:
            over = rng.random() < 0.1
            nn.requested.milli_cpu = nn.allocatable.milli_cpu + int(rng.integers(1, 3000)) \
                if over else int(rng.integers(0, nn.allocatable.milli_cpu + 1))
            nn.requested.memory = int(rng.integers(0, nn.allocatable.memory + 1))
            nn.requested.ephemeral_storage = int(
                rng.integers(0, nn.allocatable.ephemeral_storage + 1))
        nw.aware = bool(rng.random() < 0.5)
        out.append(nw)
    return out


def numa_batched_check(wrappers, requests, dev) -> int:
    """``evaluate_topology_batch`` and ``copies_capacity`` (scalar and
    per-node awareness) on the card against the same calls on the CPU,
    exactly; returns the number of comparisons."""
    from crane_scheduler_tpu_torch.topology import batched

    aware = np.array([w.aware for w in wrappers], dtype=bool)
    checks = 0
    for req in requests:
        got = batched.evaluate_topology_batch(wrappers, req, device=dev)
        want = batched.evaluate_topology_batch(wrappers, req, device="cpu")
        for name in ("aware_fits", "zones_used", "finished", "scores"):
            if not np.array_equal(getattr(got, name), getattr(want, name)):
                raise AssertionError(f"evaluate_topology_batch {name}: card != CPU for {req}")
            checks += 1
        for a in (False, True, aware):
            if not np.array_equal(batched.copies_capacity(wrappers, req, a, device=dev),
                                  batched.copies_capacity(wrappers, req, a, device="cpu")):
                raise AssertionError(f"copies_capacity: card != CPU for {req}")
            checks += 1
    return checks


def numa_twin_run() -> dict:
    """The NUMA gangs' sequential loop on the CPU (plain versions of K1
    and K2, the evaluation on the CPU) from the same seeded world, as
    JSON: per-gang (assignments, unassigned), the gang pods, the assume
    cache, ms."""
    world = numa_world(N_NODES)
    twin, topo = numa_scheduler(numa_cluster(N_NODES, world), world, "cpu")
    t0 = time.perf_counter()
    results, _ = numa_gang_loop(twin, topo, numa_requests("g"))
    ms = (time.perf_counter() - t0) * 1e3
    return {"seq": [(r.assignments, r.unassigned) for r in results],
            "pods": gang_pods(twin.cluster), "assumed": assumed(topo), "ms": ms}


def numa_mixed_run(world, dev, dtype) -> dict:
    """The gang pods as pending pods plus best-effort ones in one
    ``schedule_batch_mixed`` burst at ``dtype``, as JSON: assignments, the
    gang pods, the assume cache, ms."""
    msched, mtopo = numa_scheduler(numa_cluster(N_NODES, world), world, dev, dtype=dtype)
    pending = [Pod(name=f"{t.name}-{i}", annotations=dict(t.annotations),
                   containers=t.containers) for t, c in numa_requests("m") for i in range(c)]
    pending += [Pod(name=f"numa-be-{i}", containers=(Container("c"),))
                for i in range(NUMA_BEST_EFFORT)]
    msched.cluster.add_pods(pending)
    t0 = time.perf_counter()
    r = msched.schedule_batch_mixed(pending, topology=mtopo, dynamic_weight=GANG_DYN_W,
                                    topology_weight=GANG_TOPO_W)
    ms = (time.perf_counter() - t0) * 1e3
    return json.loads(json.dumps({"assignments": r.assignments, "pods": gang_pods(msched.cluster),
                                  "assumed": assumed(mtopo), "ms": ms}))


def numa_twin_child(leg: str, device: str) -> int:
    """The child mode ``NUMA_TWIN_ARG``: the sequential loop on the CPU
    (``seq``) or the float64 mixed burst on ``device`` (``mixed``) as one
    JSON line; each runs beside the parent's legs."""
    if leg == "seq":
        out = numa_twin_run()
    else:
        out = numa_mixed_run(numa_world(N_NODES), torch.device(device), torch.float64)
    print(json.dumps(out), flush=True)
    return 0


def phase_numa_gang(dev) -> tuple:
    """config 22's cluster with one NRT CR and one background pod per node,
    7 gangs of guaranteed pods (all six request classes) through
    ``schedule_gang(topology=)`` on the card (K1 and K2 per gang, NUMA
    offsets and capacity) against a CPU twin; the repeated class's vectors
    against a fresh full build; the queue's fallbacks; a mixed burst f32 against f64; the
    batched zone evaluation on the card against the CPU; the per-pod
    scheduler from the NRT profile. The CPU twin and the float64 mixed
    burst run in child processes of this script beside the other legs."""
    runs = [start_cli([NUMA_TWIN_ARG, "seq", "cpu"], script=True),
            start_cli([NUMA_TWIN_ARG, "mixed", dev.type], script=True)]
    try:
        return numa_gang_legs(dev, *runs)
    finally:
        for proc, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def numa_gang_legs(dev, twin_run, mixed_run) -> tuple:
    from crane_scheduler_tpu_torch.framework.types import Resource
    from crane_scheduler_tpu_torch.topology import batched

    n = N_NODES
    total = sum(c for _, c in NUMA_SHAPES)
    world = numa_world(n)
    by_path = {}

    # -- sequential on the card, the vectors held against full builds
    t0 = time.perf_counter()
    cluster = numa_cluster(n, world)
    sched, topo = numa_scheduler(cluster, world, dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    chk = gang_scheduler(cluster, dev)  # a second cache over the same cluster
    chk.refresh()
    chk._prepare(NOW)
    checks = {"compared": 0, "incremental_rows": 0}
    reqs = numa_requests("g")
    keys = [(cpu, numa_awareness(j)) for j, (cpu, _) in enumerate(NUMA_SHAPES)]
    # only a class that comes back takes the incremental path: the second
    # cache tracks those classes alone
    tracked = {t.name for (t, _), key in zip(reqs, keys) if keys.count(key) > 1}

    def check(t):
        if t.name not in tracked:
            return
        rows0 = chk.numa_incremental_rows
        hit = chk._numa_vectors(t, topo, GANG_TOPO_W, chk._prepared_names, chk._prepared_n)
        if chk.numa_incremental_rows == rows0:
            return  # the class's first gang: a full build, nothing to compare
        want = chk._numa_vectors_uncached(t, topo, GANG_TOPO_W, chk._prepared_names,
                                          chk._prepared_n)
        if not (np.array_equal(hit[0], want[0]) and np.array_equal(hit[1], want[1])):
            raise AssertionError(f"{t.name}: incremental NUMA vectors != a full build")
        checks["compared"] += 1
        checks["incremental_rows"] = chk.numa_incremental_rows

    reset_launches()
    t0 = time.perf_counter()
    results, per_gang = numa_gang_loop(sched, topo, reqs, check)
    check_ms = (time.perf_counter() - t0) * 1e3 - sum(g["ms"] for g in per_gang)
    by_path["numa_gang"] = read_launches("numa gang")
    if by_path["numa_gang"] != {"score": len(reqs), "gang": len(reqs), "drip": 0}:
        raise AssertionError(f"numa gang: {by_path['numa_gang']} launches for {len(reqs)} "
                             "gangs")
    if checks["compared"] == 0 or sched.numa_incremental_rows == 0:
        raise AssertionError("no gang took the incremental NUMA-vector path")
    seq = [(r.assignments, r.unassigned) for r in results]
    pods_seq, assumed_seq = gang_pods(cluster), assumed(topo)
    # the offsets K2 saw on the last gang (after weighting: 0, 100, 200)
    offs, caps = sched._numa_vectors(reqs[-1][0], topo, GANG_TOPO_W, sched._prepared_names,
                                     sched._prepared_n)
    offsets_seen = {int(v): int(c) for v, c in zip(*np.unique(offs, return_counts=True))}
    capacity_zero = int((caps == 0).sum())
    placed = sum(len(a) for a, _ in seq)
    if placed == 0 or not all(v[1] for v in pods_seq.values()):
        raise AssertionError("numa gang: nothing placed, or a gang pod without its zone "
                             "result")
    del chk

    # -- the CPU twin (this script's child mode, started with the phase)
    twin, _ = finish_cli(twin_run, timeout=600)
    card = json.loads(json.dumps({"seq": seq, "pods": pods_seq, "assumed": assumed_seq}))
    if any(twin[k] != card[k] for k in card):
        raise AssertionError("numa gang: the card != its CPU twin")
    twin_ms = twin["ms"]

    # -- the queue: every gang falls back to schedule_gang, in order
    qsched, qtopo = numa_scheduler(numa_cluster(n, world), world, dev)
    reset_launches()
    t0 = time.perf_counter()
    outs = qsched.schedule_gang_queue(numa_requests("g"), topology=qtopo, window=GANG_WINDOW,
                                      dynamic_weight=GANG_DYN_W, topology_weight=GANG_TOPO_W)
    queue_ms = (time.perf_counter() - t0) * 1e3
    by_path["numa_queue"] = read_launches("numa queue")
    stats = qsched.gang_stats()
    if [o.source for o in outs] != ["fallback"] * len(reqs) or stats["fallbacks"] != len(reqs) \
            or [(o.assignments, o.unassigned) for o in outs] != seq \
            or gang_pods(qsched.cluster) != pods_seq:
        raise AssertionError("numa queue: not all fallbacks, or != the sequential loop")
    del qsched, qtopo

    # -- mixed: f32 here, f64 in the child started with the sequential leg
    reset_launches()
    mixed = {"f32": numa_mixed_run(world, dev, torch.float32)}
    by_path["numa_mixed"] = read_launches("numa mixed")
    mixed["f64"], _ = finish_cli(mixed_run, timeout=600)
    if any(mixed["f32"][k] != mixed["f64"][k] for k in ("assignments", "pods", "assumed")) \
            or not mixed["f32"]["assignments"]:
        raise AssertionError("numa mixed: f32 hybrid != float64, or nothing placed")
    mixed_classes = len({(t.annotations.get(NUMA_AWARE), c) for t, c in numa_requests("m")})

    # -- the batched evaluation: card vs CPU at 50,000 x 2 and random Z 4, 8
    t0 = time.perf_counter()
    wrappers, request = numa_wrappers(world, topo, n)
    wrap_ms = (time.perf_counter() - t0) * 1e3
    reqs_eval = [request, Resource(milli_cpu=8000), Resource(milli_cpu=1000, memory=1 << 30),
                 Resource()]
    batched_checks = numa_batched_check(wrappers, reqs_eval, dev)
    rng = np.random.default_rng(SEED + 8)
    for z in (4, 8):
        batched_checks += numa_batched_check(
            numa_random_wrappers(z, NUMA_RANDOM_NODES, rng),
            [Resource(milli_cpu=c, memory=m, ephemeral_storage=e) for c, m, e in (
                (1000, 0, 0), (3000, 1 << 30, 0), (8000, 4 << 30, 1 << 30), (16000, 0, 0),
                (0, 1 << 30, 0), (0, 0, 0))], dev)
    aware = np.array([w.aware for w in wrappers], dtype=bool)
    t0 = time.perf_counter()
    batched.pack_node_wrappers(wrappers)
    pack_ms = (time.perf_counter() - t0) * 1e3

    def one_eval():
        batched.evaluate_topology_batch(wrappers, request, device=dev)
        batched.copies_capacity(wrappers, request, aware, device=dev)

    prof = profile_windows(one_eval, 3)

    # -- the per-pod scheduler from the NRT profile: card vs CPU twin
    small = numa_world(NUMA_PER_POD_NODES)
    config = SchedulerConfiguration(profiles=(SchedulerProfile(
        filter_enabled=("Dynamic", "NodeResourceTopologyMatch"),
        score_enabled=(PluginWeight("Dynamic", GANG_DYN_W),
                       PluginWeight("NodeResourceTopologyMatch", GANG_TOPO_W))),))
    from crane_scheduler_tpu_torch.convert import nrt_lister_from_crs

    per_pod = {}
    reset_launches()
    for label, device in (("card", dev), ("cpu", "cpu")):
        pcluster = numa_cluster(NUMA_PER_POD_NODES, small)
        psched = build_scheduler_from_config(pcluster, config,
                                             nrt_lister=nrt_lister_from_crs(small[0]),
                                             clock=lambda: NOW, policy=DEFAULT_POLICY,
                                             device=device)
        ptopo = psched._plugins[-1].plugin
        try:
            t0 = time.perf_counter()
            got = []
            for j in range(NUMA_PER_POD_PODS):
                cpu, _ = _NUMA_CLASSES[j % len(_NUMA_CLASSES)]
                pod = numa_template(f"numa-pp-{j}", cpu, numa_awareness(j))
                pcluster.add_pod(pod)
                r = psched.schedule_one(pod)
                got.append((r.node, r.reason))
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            ptopo.cache.stop_cleaner()
        per_pod[label] = (ms, got, gang_pods(pcluster), assumed(ptopo),
                          psched.drip_stats()["fallbacks"])
    by_path["numa_per_pod"] = read_launches("numa per-pod", need=())
    if per_pod["card"][1:] != per_pod["cpu"][1:] or not any(
            node for node, _ in per_pod["card"][1]):
        raise AssertionError("numa per-pod: the card scheduler != its CPU twin")

    full = [g for g in per_gang if g["full_build_ms"] > 0]
    inc = [g for g in per_gang if g["incremental_rows"] > 0]
    out = {
        "nodes": n, "gangs": len(reqs), "pods": total, "placed": placed,
        "unassigned": sum(len(u) for _, u in seq),
        "dynamic_weight": GANG_DYN_W, "topology_weight": GANG_TOPO_W,
        "equal": ["card == CPU twin (placements, unassigned, zone results, assume cache)",
                  "queue == sequential (every outcome a fallback)", "mixed f32 == f64",
                  "incremental vectors == full build", "batched evaluation card == CPU",
                  "per-pod card == CPU twin"],
        "ms_per_gang": statistics.mean(g["ms"] for g in per_gang),
        "ms_per_gang_all": [g["ms"] for g in per_gang],
        "full_build_ms": [g["full_build_ms"] for g in full],
        "incremental_ms": [g["incremental_ms"] for g in inc],
        "incremental_rows": [g["incremental_rows"] for g in inc],
        "stage_ms_per_gang": {k: statistics.mean(g[k] for g in per_gang) for k in (
            "refresh_ms", "fit_ms", "numa_vectors_ms", "full_build_ms", "incremental_ms",
            "build_result_ms", "bind_ms", "step_ms")},
        "stage_ms_median_gang": {k: statistics.median(g[k] for g in per_gang) for k in (
            "ms", "numa_vectors_ms", "bind_ms", "step_ms")},
        "k1_per_gang": by_path["numa_gang"]["score"] / len(reqs),
        "k2_per_gang": by_path["numa_gang"]["gang"] / len(reqs),
        "vector_checks": {**checks, "ms": check_ms},
        "numa_incremental_rows": sched.numa_incremental_rows,
        "last_gang_offsets": offsets_seen, "last_gang_capacity_zero_rows": capacity_zero,
        "twin_cpu_ms_per_gang": twin_ms / len(reqs), "queue_ms_per_gang": queue_ms / len(reqs),
        "queue_fallbacks": stats["fallbacks"],
        "mixed_ms": {k: v["ms"] for k, v in mixed.items()}, "mixed_pods": total + NUMA_BEST_EFFORT,
        "mixed_numa_classes": mixed_classes, "mixed_placed": len(mixed["f32"]["assignments"]),
        "batched": {"wrappers": len(wrappers), "zones": 2, "checks": batched_checks,
                    "random_nodes": NUMA_RANDOM_NODES, "random_zones": [4, 8],
                    "wrapper_build_ms": wrap_ms, "pack_ms": pack_ms,
                    **{k: prof[k] for k in ("device_us", "wall_us", "device_kernels",
                                            "cuda_launch_kernel_calls", "device_events_seen",
                                            "top_device_us")}},
        "per_pod": {"nodes": NUMA_PER_POD_NODES, "pods": NUMA_PER_POD_PODS,
                    "ms_per_pod": {k: v[0] / NUMA_PER_POD_PODS for k, v in per_pod.items()},
                    "placed": sum(1 for node, _ in per_pod["card"][1] if node),
                    "fallbacks": per_pod["card"][4]},
        "cluster_build_ms": build_ms, "launches": by_path,
    }
    log("numa_gang", **out)
    return out, by_path


# -- the scoring sidecar --------------------------------------------------------

class WallClock:
    """``NOW`` plus the seconds since it was made: a live service's clock
    over annotations stamped near ``NOW``, so the implicit-now coalescing
    bucket moves as it does in production."""

    def __init__(self):
        self._t0 = time.monotonic()

    def __call__(self) -> float:
        return NOW + (time.monotonic() - self._t0)


CARD = "cuda"  # the "backend" of every answer from the card
CARD_BODY = b'{"backend": "' + CARD.encode() + b'"'  # how every such render begins


def check_body(body: bytes, leg: str, nodes: int | None = None) -> None:
    """A device-path render: ``"backend": "cuda"``, and all ``nodes``."""
    if not body.startswith(CARD_BODY):
        raise AssertionError(f"service {leg}: body not from the card: {body[:80]!r}")
    if nodes is not None:
        doc = json.loads(body)
        if len(doc["scores"]) != nodes or len(doc["schedulable"]) != nodes:
            raise AssertionError(f"service {leg}: {len(doc['scores'])} of {nodes} nodes")


def no_fallback(svc, leg: str) -> None:
    m = svc.metrics()
    if m["fallbacks"] != 0 or m["expired_at_dispatch"] != 0:
        raise AssertionError(f"service {leg}: fallbacks {m['fallbacks']}, "
                             f"expired at dispatch {m['expired_at_dispatch']}")


def cpu_body(body: bytes) -> bytes:
    """A CPU twin's body with its backend named as the card's."""
    return body.replace(b'"backend": "cpu"', b'"backend": "cuda"', 1)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def service_twins(cluster, dev, dtype, clock):
    card = ScoringService(cluster, DEFAULT_POLICY, dtype=dtype, device=dev, clock=clock)
    cpu = ScoringService(cluster, DEFAULT_POLICY, dtype=dtype, device="cpu", clock=clock)
    card.refresh()
    cpu.refresh()
    return card, cpu


class BrokenScorer:
    """A scorer whose kernel does not launch."""

    def __call__(self, *args, **kwargs):
        raise RuntimeError("K1 did not launch")


def service_score_leg(cluster, dev) -> tuple:
    """Card bodies == CPU-twin bodies at SERVICE_NOWS explicit ``now``s, in
    float32 and float64; then a broken scorer on the card raises instead
    of answering from the oracle."""
    clock = Clock(NOW)
    nows = [NOW + 37.0 * k for k in range(SERVICE_NOWS)]
    f32_renders = 0
    for dtype in (torch.float32, torch.float64):
        card, cpu = service_twins(cluster, dev, dtype, clock)
        for now in nows:
            body = card.score_response_bytes(now=now, refresh=False)
            check_body(body, "score", N_NODES)
            if body != cpu_body(cpu.score_response_bytes(now=now, refresh=False)):
                raise AssertionError(f"service score: card != CPU twin, {dtype}, now {now}")
        no_fallback(card, "score")
        if dtype == torch.float32:
            f32_renders += card.metrics()["score_calls"]
    card.scorer = BrokenScorer()
    try:
        card.score_response_bytes(now=NOW - 37.0, refresh=False)
    except RuntimeError as e:
        if "K1 did not launch" not in str(e):
            raise
    else:
        raise AssertionError("service score: a broken scorer on the card answered")
    no_fallback(card, "score (broken scorer)")
    return f32_renders, len(nows)


def render_pieces(svc, now: float) -> dict:
    """One cache-miss render's pieces, timed from outside the service:
    the snapshot, the scorer call with both copies back (H2D, K1 in
    float32, D2H), the two dicts and ``json.dumps``."""
    t0 = time.perf_counter()
    snap = svc.store.snapshot(bucket=2048)
    t1 = time.perf_counter()
    res = svc.scorer(snap.values, snap.ts, snap.hot_value, snap.hot_ts, snap.node_valid, now)
    n = snap.n_nodes
    sched = res.schedulable[:n].cpu().numpy()
    scores = res.scores[:n].cpu().numpy()
    t2 = time.perf_counter()
    verdicts = (dict(zip(snap.node_names, sched.astype(bool).tolist())),
                dict(zip(snap.node_names, scores.astype(np.int64).tolist())))
    t3 = time.perf_counter()
    json.dumps({"backend": "cuda", "stalenessSeconds": 0.0,
                "schedulable": verdicts[0], "scores": verdicts[1]})
    t4 = time.perf_counter()
    return {"snapshot": (t1 - t0) * 1e3, "scorer_h2d_k1_d2h": (t2 - t1) * 1e3,
            "dicts": (t3 - t2) * 1e3, "json_dumps": (t4 - t3) * 1e3}


PROFILE_RENDERS_ARG = "--profile-renders"  # the child mode of this script


def profile_renders_child() -> int:
    """The child of ``profiled_renders``: the 50,000-node service, then
    ``profile_windows`` over SERVICE_PROFILED_RENDERS cache-miss renders
    per dtype; prints one JSON object."""
    if not torch.cuda.is_available():
        return 2
    dev = torch.device("cuda")
    build_all([score_kernel.KERNEL, gang_kernel.KERNEL])
    cluster = build_cluster(cluster_annotations(compile_policy(DEFAULT_POLICY),
                                                np.random.default_rng(SEED)))
    out = {}
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        svc = ScoringService(cluster, DEFAULT_POLICY, dtype=dtype, device=dev,
                             clock=Clock(NOW), now_bucket_s=0.0)
        svc.refresh()
        calls = iter(range(10**6))

        def render():
            body = svc.score_response_bytes(now=NOW + 1000.0 + next(calls), refresh=False)
            check_body(body, "miss (profiled)", N_NODES)

        out[tag] = profile_windows(render, SERVICE_PROFILED_RENDERS)
        no_fallback(svc, "miss (profiled)")
    print(json.dumps(out), flush=True)
    return 0


def profiled_renders() -> dict:
    """Device us and idle share of a cache-miss render per dtype, from
    ``torch.profiler`` in a fresh process. Late in this script's process a
    short session keeps every host runtime call and, in most sessions, no
    device record, while a young process keeps them all."""
    proc = subprocess.run([sys.executable, __file__, PROFILE_RENDERS_ARG],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"service miss: profiled renders exited {proc.returncode}: "
                             f"{proc.stderr[-800:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def service_miss_leg(cluster, dev) -> dict:
    """SERVICE_MISS_RENDERS cache-miss renders (``now_bucket_s=0``, a new
    explicit ``now`` each) per dtype: host ms per render, its pieces, and
    the device time and idle share of one render under the profiler."""
    out, profiled = {}, profiled_renders()
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        clock = Clock(NOW)
        svc = ScoringService(cluster, DEFAULT_POLICY, dtype=dtype, device=dev, clock=clock,
                             now_bucket_s=0.0)
        svc.refresh()
        svc.score_response_bytes(now=NOW - 1.0, refresh=False)  # warm
        render_ms = []
        for k in range(SERVICE_MISS_RENDERS):
            t0 = time.perf_counter()
            body = svc.score_response_bytes(now=NOW + 0.5 * k, refresh=False)
            render_ms.append((time.perf_counter() - t0) * 1e3)
            check_body(body, "miss")
        pieces = [render_pieces(svc, NOW + 0.25 + 0.5 * k) for k in range(SERVICE_MISS_RENDERS)]
        m = svc.metrics()
        if m["response_cache_hits"] != 0 or m["score_calls"] != 1 + SERVICE_MISS_RENDERS:
            raise AssertionError(f"service miss: a render was not a miss: {m}")
        no_fallback(svc, "miss")
        out[tag] = {
            "render_ms_median": statistics.median(render_ms),
            "render_ms_p90": percentile(render_ms, 90), "render_ms": render_ms,
            "pieces_ms_median": {k: statistics.median(p[k] for p in pieces) for k in pieces[0]},
            "profiled_render": profiled[tag],
        }
    return out


def closed_loop(port: int, clients: int, seconds: float) -> dict:
    """``clients`` threads, each one keep-alive connection sending ``POST
    /v1/score`` with an empty body (default refresh, implicit ``now``)
    back to back for ``seconds``; every answer must come from the card."""
    import http.client
    import threading

    stop_at = time.perf_counter() + seconds
    lats, errors, lock = [], [], threading.Lock()

    def loop():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        mine = []
        try:
            while time.perf_counter() < stop_at:
                t0 = time.perf_counter()
                conn.request("POST", "/v1/score", body=b"{}",
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                mine.append(time.perf_counter() - t0)
                if resp.status != 200 or not data.startswith(CARD_BODY):
                    errors.append((resp.status, data[:80]))
                    return
        except Exception as e:  # surfaced below
            errors.append(repr(e))
        finally:
            conn.close()
            with lock:
                lats.extend(mine)

    threads = [threading.Thread(target=loop) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or not lats:
        raise AssertionError(f"service serve: client errors {errors[:3]}")
    return {"requests": len(lats), "req_per_s": len(lats) / wall,
            "p50_ms": percentile(lats, 50) * 1e3, "p99_ms": percentile(lats, 99) * 1e3}


def service_serve_leg(cluster, dev) -> tuple:
    """``ScoringHTTPServer`` (async front end) under SERVICE_CLIENTS
    closed-loop keep-alive clients for SERVICE_SECONDS, float32 and
    float64; then cold render == cache hit == a 6-thread storm."""
    import threading

    out, by_path = {}, {}
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        svc = ScoringService(cluster, DEFAULT_POLICY, dtype=dtype, device=dev,
                             clock=WallClock())
        svc.refresh()
        server = ScoringHTTPServer(svc, port=0, frontend="async")
        server.start()
        try:
            svc.score_response_bytes(refresh=False)  # warm
            before = svc.metrics()
            reset_launches()
            leg = closed_loop(server.port, SERVICE_CLIENTS, SERVICE_SECONDS)
            launched = {name: kernel.launches for name, kernel in KERNELS.items()}
            m = svc.metrics()
            renders = m["score_calls"] - before["score_calls"]
            want_k1 = renders if dtype == torch.float32 else 0
            if launched != {"score": want_k1, "gang": 0, "drip": 0}:
                raise AssertionError(f"service serve {tag}: launches {launched} for "
                                     f"{renders} renders")
            if tag == "f32":
                by_path["service_http"] = launched
            now = NOW + 3600.0
            svc._resp_cache.clear()
            cold = svc.score_response_bytes(now=now, refresh=False)
            hit = svc.score_response_bytes(now=now, refresh=False)
            stormed, barrier = [], threading.Barrier(SERVICE_STORM)

            def one():
                barrier.wait()
                stormed.append(svc.score_response_bytes(now=now, refresh=False))

            threads = [threading.Thread(target=one) for _ in range(SERVICE_STORM)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if len({cold, hit, *stormed}) != 1 or len(stormed) != SERVICE_STORM:
                raise AssertionError(f"service serve {tag}: cold/hit/storm bytes differ")
            check_body(cold, "serve", N_NODES)
            no_fallback(svc, "serve")
            out[tag] = {
                **leg, "renders": renders,
                **{k: m[k] - before[k] for k in ("coalesced_scores", "response_cache_hits",
                                                 "refreshes", "refresh_skips")},
                "connections_accepted": server.connections_accepted,
                "k1_launches": launched["score"],
            }
        finally:
            server.stop()
    return out, by_path


def service_assign_leg(cluster, dev) -> tuple:
    """``POST /v1/assign`` of SERVICE_ASSIGN_PODS pods, with and without a
    capacity map over every node, on a float32 service; each answer equals
    the CPU twin's ``assign_batch``; one K1 and one K2 launch per call."""
    import http.client

    clock = Clock(NOW)
    card, cpu = service_twins(cluster, dev, torch.float32, clock)
    names = [n.name for n in cluster.list_nodes()]
    caps = np.random.default_rng(SEED + 8).integers(1, 5, len(names))
    capacity = {name: int(c) for name, c in zip(names, caps)}
    server = ScoringHTTPServer(card, port=0, frontend="async")
    server.start()
    out = {}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
        reset_launches()
        calls = 0
        for tag, cap in (("no_capacity", None), ("capacity", capacity)):
            ms = []
            for k in range(SERVICE_ASSIGN_CALLS):
                now = NOW + 11.0 * k
                req = {"numPods": SERVICE_ASSIGN_PODS, "now": now, "refresh": False}
                if cap is not None:
                    req["capacity"] = cap
                body = json.dumps(req).encode()
                t0 = time.perf_counter()
                conn.request("POST", "/v1/assign", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                ms.append((time.perf_counter() - t0) * 1e3)
                calls += 1
                doc = json.loads(data)
                if resp.status != 200 or doc["backend"] != CARD:
                    raise AssertionError(f"service assign: {resp.status} {data[:120]!r}")
                twin = cpu.assign_batch(SERVICE_ASSIGN_PODS, capacity=cap, now=now)
                if (doc["counts"], doc["unassigned"], doc["waterline"]) != (
                        twin.counts, twin.unassigned, twin.waterline):
                    raise AssertionError(f"service assign {tag}: card != CPU twin at {now}")
            out[tag] = {"ms_per_call": ms, "ms_median": statistics.median(ms),
                        "placed": SERVICE_ASSIGN_PODS - doc["unassigned"],
                        "unassigned": doc["unassigned"], "waterline": doc["waterline"],
                        "nodes_used": len(doc["counts"]), "request_bytes": len(body)}
        conn.close()
        launched = read_launches("service assign")
        if launched != {"score": calls, "gang": calls, "drip": 0}:
            raise AssertionError(f"service assign: {launched} launches for {calls} calls")
        no_fallback(card, "assign")
    finally:
        server.stop()
    return out, launched


def service_cli_leg() -> dict:
    """``crane-scorer --f32`` as a subprocess on the card: ``/healthz``,
    ``/v1/score`` from the card, a strict ``/metrics`` parse with no
    fallback and the scorer's build info, then SIGTERM and exit 0."""
    import http.client
    import os
    import signal
    import socket
    from pathlib import Path

    root = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "crane_scheduler_tpu_torch.cli.service_main", "--f32",
         "--port", str(port), "--run-seconds", "20"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        while True:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                health = (resp.status, json.loads(resp.read()))
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > 90:
                    raise AssertionError("service cli did not come up")
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        conn.request("POST", "/v1/score", body=b"{}", headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        score = (resp.status, resp.read())
        conn.request("GET", "/metrics", headers={"Accept": "text/plain"})
        text = conn.getresponse().read().decode()
        conn.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            _, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
    if health != (200, {"status": "ok"}) or score[0] != 200:
        raise AssertionError(f"service cli: healthz {health}, score {score[0]}")
    check_body(score[1], "cli")
    fams = expfmt.parse_exposition(text)
    # an unlabeled counter renders no sample until its first increment
    fallbacks = sum(v for _, _, v in fams["crane_scoring_fallbacks_total"]["samples"])
    roles = [dict(s[1]).get("role") for s in fams["crane_build_info"]["samples"]]
    if fallbacks != 0 or "scorer" not in roles:
        raise AssertionError(f"service cli: fallbacks {fallbacks}, build_info roles {roles}")
    if proc.returncode != 0:
        raise AssertionError(f"service cli exited {proc.returncode}: {err[-400:]!r}")
    return {"up_s": up_s, "families": len(fams), "exit": proc.returncode}


def phase_service(dev, annos) -> tuple:
    """The scoring sidecar at 50,000 nodes: the score, miss, serve, assign
    and cli legs."""
    t0 = time.perf_counter()
    cluster = build_cluster(annos)
    by_path = {}
    reset_launches()
    f32_renders, nows = service_score_leg(cluster, dev)
    service_miss = service_miss_leg(cluster, dev)
    by_path["service_score"] = read_launches("service score", need=("score",))
    # the float32 miss leg: a warm-up, the timed renders and the pieces'
    # scorer calls (the profiled renders run in a child process)
    k1_want = f32_renders + 1 + 2 * SERVICE_MISS_RENDERS
    if by_path["service_score"] != {"score": k1_want, "gang": 0, "drip": 0}:
        raise AssertionError(f"service score: {by_path['service_score']} launches, "
                             f"want {k1_want} of K1 and none of K2")
    serve, serve_paths = service_serve_leg(cluster, dev)
    by_path.update(serve_paths)
    assign, by_path["service_assign"] = service_assign_leg(cluster, dev)
    cli = service_cli_leg()
    out = {
        "nodes": N_NODES, "score_nows": nows, "card_equals_cpu": True,
        "miss": service_miss, "serve": serve, "assign": assign, "cli": cli,
        "launches": by_path, "seconds": time.perf_counter() - t0,
    }
    log("service", **out)
    return out, by_path


# -- the metrics-sync plane and the replicated tier ---------------------------

REPL_REPLICAS = 4  # bench config 19's replica count
REPL_LAG_BUDGET = 64  # config 19's catch-up gate, in versions
REPL_NOWS = 5  # explicit `now`s of the byte-identity check
REPL_CHURN_WINDOWS = 16  # 1% named patches, one delta window each
REPL_RING = 32  # the publisher's resume ring (frames)
REPL_RESUME_IN_RING = 3  # windows published while one replica's feed is down
REPL_CLIENTS = 8  # closed-loop storm clients, one tenant each
REPL_SECONDS = 3.0
REPL_ASSIGN_CALLS = 3
SIM_STEPS = 2  # closed-loop sim steps (cut from 5 to keep the script's wall time)
SIM_BURST_PODS = 10_000
SIM_DRIP_PODS = 256
SIM_STEP_SECONDS = 30.0
CLI_DEMO_NODES = 2_000
CLI_ANNOTATOR_NODES = 1_000
CLI_SIM_PODS = 4_000
BUILD_DIR = "crane_scheduler_tpu_torch/_build"


def node_annotations(cluster) -> dict:
    return {n.name: dict(n.annotations) for n in cluster.list_nodes()}


def store_rows(store) -> tuple:
    """(names, values, ts, hot_value, hot_ts) in name order."""
    names = sorted(store.node_names)
    idx = np.asarray([store.node_id(n) for n in names], dtype=np.int64)
    return (names, store.values[idx].copy(), store.ts[idx].copy(),
            store.hot_value[idx].copy(), store.hot_ts[idx].copy())


def rows_equal(a, b) -> bool:
    """Bit-for-bit equal store rows (NaN in the same places)."""
    if a[0] != b[0]:
        return False
    return all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a[1:], b[1:]))


def repl_annotator_leg(sim, n: int) -> dict:
    """sync_all_once (the per-node path) and sync_all_once_bulk on the
    primary's annotator; then a direct-mode annotator (sharing the
    primary's binding heap) writes its sweep straight into a store, and
    that store's rows must equal a store refreshed from the annotations
    the sweep emitted."""
    from crane_scheduler_tpu_torch.annotator import AnnotatorConfig, NodeAnnotator

    ann = sim.annotator
    t0 = time.perf_counter()
    sim.sync_metrics()
    per_node_ms = (time.perf_counter() - t0) * 1e3
    synced = ann.synced
    if synced != n * len(DEFAULT_POLICY.spec.sync_period) or ann.sync_errors:
        raise AssertionError(f"replicated annotator: synced {synced}, errors {ann.sync_errors}")
    sim.clock.advance(1.0)
    t0 = time.perf_counter()
    ann.sync_all_once_bulk(sim.clock.now())
    bulk_ms = (time.perf_counter() - t0) * 1e3
    # one column render alone: the per-value format_metric_value loop
    column = sim.metrics._columns[DEFAULT_POLICY.spec.sync_period[0].name]
    t0 = time.perf_counter()
    column()
    render_ms = (time.perf_counter() - t0) * 1e3
    direct = NodeAnnotator(sim.cluster, sim.metrics, DEFAULT_POLICY,
                           AnnotatorConfig(direct_store=True))
    direct.binding_records = ann.binding_records
    tensors = compile_policy(DEFAULT_POLICY)
    store = direct.attach_store(NodeLoadStore(tensors))
    sim.clock.advance(1.0)
    t0 = time.perf_counter()
    direct.sync_all_once_bulk(sim.clock.now())
    direct_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    flushed = direct.flush_annotations()
    flush_ms = (time.perf_counter() - t0) * 1e3
    annotated = NodeLoadStore(tensors)
    t0 = time.perf_counter()
    direct.refresh_store(annotated)
    refresh_ms = (time.perf_counter() - t0) * 1e3
    if not rows_equal(store_rows(store), store_rows(annotated)) or len(store) != n:
        raise AssertionError("replicated annotator: direct-store rows != annotation rows")
    return {"sync_all_once_ms": per_node_ms, "sync_node_calls": synced,
            "sync_all_once_bulk_ms": bulk_ms, "column_render_ms": render_ms,
            "direct_sweep_ms": direct_ms, "direct_flush_ms": flush_ms,
            "direct_flushed": flushed, "refresh_store_ms": refresh_ms,
            "direct_rows_equal": True}


class HeapTee:
    """The annotator's C++ binding heap with a Python heap fed the same
    binding stream: reads come from the C++ heap, every write goes to
    both."""

    def __init__(self, native, twin):
        self.native, self.twin = native, twin

    def __len__(self) -> int:
        return len(self.native)

    def __getattr__(self, name):
        return getattr(self.native, name)

    def add_binding(self, binding) -> None:
        self.native.add_binding(binding)
        self.twin.add_binding(binding)

    def add_binding_batch(self, bindings) -> None:
        bindings = list(bindings)
        self.native.add_binding_batch(bindings)
        self.twin.add_binding_batch(bindings)

    def add_bind_columns(self, node_table, node_idx, ts) -> None:
        self.native.add_bind_columns(node_table, node_idx, ts)
        self.twin.add_bind_columns(node_table, node_idx, ts)

    def bindings_gc(self, now=None) -> None:
        self.native.bindings_gc(now)
        self.twin.bindings_gc(now)


def heap_twin_check(tee, policy, now: float) -> dict:
    """The C++ heap and its Python twin after the same binding stream: equal
    sizes and equal per-node counts in every hot-value window."""
    windows = [p.time_range_seconds for p in policy.spec.hot_value]
    out = {"bindings": len(tee.native)}
    counts = {}
    for label, heap in (("native", tee.native), ("python", tee.twin)):
        t0 = time.perf_counter()
        names, c = heap.counts_batch(windows, now)
        out[f"{label}_counts_batch_ms"] = (time.perf_counter() - t0) * 1e3
        counts[label] = {n: c[:, i].tolist() for i, n in enumerate(names) if c[:, i].any()}
    if len(tee.native) != len(tee.twin) or counts["native"] != counts["python"] \
            or not counts["native"]:
        raise AssertionError(f"native: the C++ heap != the Python heap ({len(tee.native)}, "
                             f"{len(tee.twin)} bindings)")
    out["nodes_with_bindings"] = len(counts["native"])
    return out


def render_twin_check(sim, metric: str) -> dict:
    """One metric column of the simulator: the host library's render and
    parse against ``format_metric_value`` and ``go_parse_float`` on the
    same loads, and the column in its three-column form."""
    from crane_scheduler_tpu_torch.loadstore.codec import format_metric_value, go_parse_float
    from crane_scheduler_tpu_torch.native.codec import bulk_render_f5

    hosts, strings, floats = sim.metrics._columns[metric]()
    loads = np.asarray([sim._base[(name, metric)] for name, _ in sim._pairs])
    loads = np.clip(loads + sim.config.per_pod_load * sim._counts_vector(), 0.0, 1.0)
    t0 = time.perf_counter()
    native, parsed, ok = bulk_render_f5(loads, with_parse=True)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    twin = [format_metric_value(v) for v in loads.tolist()]
    twin_parsed = [go_parse_float(v) for v in twin]
    twin_ms = (time.perf_counter() - t0) * 1e3
    if native != twin or strings != twin or not ok.all() or \
            parsed.tolist() != twin_parsed or not np.array_equal(floats, parsed):
        raise AssertionError(f"native: the {metric} column render != format_metric_value")
    return {"values": len(loads), "native_ms": native_ms, "twin_ms": twin_ms,
            "three_columns": len(hosts) == len(strings) == len(floats)}


def repl_sim_leg(sim, twin, dev) -> tuple:
    """SIM_STEPS closed-loop steps on the card and on a CPU twin: a bulk
    annotator sweep, one SIM_BURST_PODS-pod float32 burst, its binds,
    events and hot values; placements and every node's annotation strings
    equal after each step; K1 and K2 once per burst. Then SIM_DRIP_PODS
    pods through ``build_scheduler()``, equal pod for pod."""
    card = sim.build_batch_scheduler(dtype=torch.float32, device=dev)
    cpu = twin.build_batch_scheduler(dtype=torch.float32, device="cpu")
    # the burst's host stages, timed from outside (schedule_batch keeps no
    # stage clock); the rest of a burst is the step and its one fetch
    stages = ("refresh", "_prepare", "_build_result", "_apply_binds")
    spent = time_methods(card, stages)
    steps = []
    reset_launches()
    for step in range(SIM_STEPS):
        row = {}
        for s in (sim, twin):
            s.clock.advance(SIM_STEP_SECONDS)
        t0 = time.perf_counter()
        sim.annotator.sync_all_once_bulk(sim.clock.now())
        row["sync_ms"] = (time.perf_counter() - t0) * 1e3
        twin.annotator.sync_all_once_bulk(twin.clock.now())
        pods = [sim.make_pod() for _ in range(SIM_BURST_PODS)]
        twin_pods = [twin.make_pod() for _ in range(SIM_BURST_PODS)]
        before = dict(spent)
        t0 = time.perf_counter()
        res = card.schedule_batch(pods)
        row["burst_ms"] = (time.perf_counter() - t0) * 1e3
        row["stage_ms"] = {k.lstrip("_"): spent[k] - before[k] for k in stages}
        twin_res = cpu.schedule_batch(twin_pods)
        if res.assignments != twin_res.assignments or res.unassigned != twin_res.unassigned:
            raise AssertionError(f"replicated sim step {step}: card placements != CPU twin")
        for s, r, ps in ((sim, res, pods), (twin, twin_res, twin_pods)):
            for pod in ps:
                s.record(r.assignments.get(pod.key()))
        row["placed"] = len(res.assignments)
        row["hot_nodes"] = len(sim.annotator.hot_values_batch(sim.clock.now()))
        steps.append(row)
    launched = read_launches("replicated sim")
    if launched != {"score": SIM_STEPS, "gang": SIM_STEPS, "drip": 0}:
        raise AssertionError(f"replicated sim: launches {launched} for {SIM_STEPS} bursts")
    for s in (sim, twin):
        s.clock.advance(SIM_STEP_SECONDS)
        s.annotator.sync_all_once_bulk(s.clock.now())
    if node_annotations(sim.cluster) != node_annotations(twin.cluster):
        raise AssertionError("replicated sim: annotation strings != CPU twin")
    if sim.annotator.event_ingestor.translated != SIM_STEPS * SIM_BURST_PODS:
        raise AssertionError(f"replicated sim: {sim.annotator.event_ingestor.translated} "
                             "bind events ingested")
    drip, twin_drip = sim.build_scheduler(device=dev), twin.build_scheduler(device="cpu")
    t0 = time.perf_counter()
    placed = [drip.schedule_one(sim.make_pod()).node for _ in range(SIM_DRIP_PODS)]
    drip_ms = (time.perf_counter() - t0) * 1e3 / SIM_DRIP_PODS
    twin_placed = [twin_drip.schedule_one(twin.make_pod()).node for _ in range(SIM_DRIP_PODS)]
    if placed != twin_placed or None in placed:
        raise AssertionError("replicated sim drip: card placements != CPU twin")
    return {"steps": steps, "drip_ms_per_pod": drip_ms,
            "scheduled": sim.stats.scheduled + SIM_DRIP_PODS,
            "events_ingested": sim.annotator.event_ingestor.translated}, launched


def http_json(port: int, method: str, path: str, doc=None, headers=None, timeout=120):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = None if doc is None else json.dumps(doc).encode()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


REPLICA_BODY = b'{"backend":"' + CARD.encode() + b'"'  # a replica-mode render's start


def wait_until(cond, what: str, timeout: float = 120.0, step: float = 0.001) -> None:
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"replicated: {what} within {timeout} s")
        time.sleep(step)


def identity_check(pub, primary, replicas, twin, nows) -> dict:
    """At a quiesced fence: every `now` posted to the primary and to each
    replica gives one byte string, stamped with the published version, equal
    to the CPU twin replica's render; returns per-replica render ms."""
    v = pub.published_version
    for r in replicas:
        wait_until(lambda r=r: r.applied_version == v, f"{r.name} at v{v}")
    if twin.applied_version != v:
        raise AssertionError(f"replicated: CPU twin at v{twin.applied_version}, not v{v}")
    ms = []
    for now in nows:
        doc = {"now": now, "refresh": True}
        status, body = http_json(primary.port, "POST", "/v1/score", doc)
        if status != 200 or not body.startswith(REPLICA_BODY):
            raise AssertionError(f"replicated identity: primary {status} {body[:80]!r}")
        for r in replicas:
            t0 = time.perf_counter()
            status, got = http_json(r.port, "POST", "/v1/score", doc)
            ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200 or got != body:
                raise AssertionError(f"replicated identity: {r.name} != primary at {now}")
        mirror = twin.service.score_response_bytes(now=now, refresh=True)
        if mirror.replace(b'"backend":"cpu"', REPLICA_BODY[1:], 1) != body:
            raise AssertionError(f"replicated identity: CPU twin != card at {now}")
        if json.loads(body)["version"] != v:
            raise AssertionError(f"replicated identity: body version != published v{v}")
    return {"version": v, "nows": len(nows), "render_ms": ms}


def repl_churn_leg(sim, pub, replicas, rng) -> dict:
    """REPL_CHURN_WINDOWS windows of a 1% named patch, then one window of a
    full annotator sweep: publish ms, frame bytes and catch-up ms from
    publish to every replica's applied version; lag within the budget."""
    names = sim.cluster.node_names()
    metric = DEFAULT_POLICY.spec.sync_period[0].name
    lags, windows = [], []

    def publish(kind: str) -> None:
        t0 = time.perf_counter()
        shipped = pub.publish_window()
        t1 = time.perf_counter()
        v = pub.published_version
        frame_bytes = len(pub._ring[-1][2])

        def caught_up():
            lags.extend(max(0, v - r.applied_version) for r in replicas)
            return all(r.applied_version == v for r in replicas)

        wait_until(caught_up, f"catch-up to v{v}")
        windows.append({"kind": kind, "names": shipped, "publish_ms": (t1 - t0) * 1e3,
                        "frame_bytes": frame_bytes,
                        "catch_up_ms": (time.perf_counter() - t1) * 1e3})

    stamp = format_local_time(sim.clock.now())
    for w in range(REPL_CHURN_WINDOWS):
        picked = rng.choice(len(names), max(1, len(names) // 100), replace=False)
        sim.cluster.patch_node_annotations_bulk(
            {names[int(i)]: {metric: f"{rng.random():.5f},{stamp}"} for i in picked})
        publish("patch_1pct")
    sim.clock.advance(SIM_STEP_SECONDS)
    t0 = time.perf_counter()
    sim.annotator.sync_all_once_bulk(sim.clock.now())
    sweep_ms = (time.perf_counter() - t0) * 1e3
    publish("full_sweep")
    if max(lags) > REPL_LAG_BUDGET:
        raise AssertionError(f"replicated churn: lag {max(lags)} over {REPL_LAG_BUDGET}")
    gaps = {r.name: r.mirror.stats["gaps"] for r in replicas}
    if any(gaps.values()):
        raise AssertionError(f"replicated churn: version gaps {gaps}")
    patch = [w for w in windows if w["kind"] == "patch_1pct"]
    return {"windows": windows, "sweep_ms": sweep_ms, "lag_max": max(lags),
            "lag_samples": len(lags), "gaps": 0,
            "patch_publish_ms_median": statistics.median(w["publish_ms"] for w in patch),
            "patch_catch_up_ms_median": statistics.median(w["catch_up_ms"] for w in patch),
            "patch_frame_bytes_median": statistics.median(w["frame_bytes"] for w in patch)}


def repl_resume_leg(sim, pub, server, replica) -> dict:
    """Stop one replica's feed; publish inside the ring and reconnect (ring
    replay, no snapshot); stop it again, publish past the ring and
    reconnect (one snapshot)."""
    from crane_scheduler_tpu_torch.cluster.replication import DeltaStreamClient

    names = sim.cluster.node_names()
    metric = DEFAULT_POLICY.spec.sync_period[1].name
    out = {}
    stamp = format_local_time(sim.clock.now())
    for j, (leg, count) in enumerate((("in_ring", REPL_RESUME_IN_RING),
                                      ("past_ring", REPL_RING + 2))):
        replica.feed_client.stop()
        deltas0 = replica.mirror.stats["deltas"]
        snaps0 = replica.mirror.stats["snapshots"]
        pub_snaps0 = pub.stats["snapshots_sent"]
        for k in range(count):
            # a value no earlier write used, so every window ships a frame
            sim.cluster.patch_node_annotation(names[k], metric, f"0.{j}{k:04d},{stamp}")
            if pub.publish_window() != 1:
                raise AssertionError(f"replicated resume {leg}: window {k} shipped no frame")
        client = DeltaStreamClient("127.0.0.1", server.port, replica.mirror,
                                   telemetry=replica.telemetry)
        replica.feed_client = client
        t0 = time.perf_counter()
        client.start()
        if not client.wait_caught_up(pub.published_version, timeout_s=120.0):
            raise AssertionError(f"replicated resume {leg}: no catch-up")
        out[leg] = {"windows": count, "catch_up_ms": (time.perf_counter() - t0) * 1e3,
                    "deltas_replayed": replica.mirror.stats["deltas"] - deltas0,
                    "snapshots": replica.mirror.stats["snapshots"] - snaps0,
                    "snapshots_sent": pub.stats["snapshots_sent"] - pub_snaps0,
                    "resumes": client.stats["resumes"]}
    want = {"in_ring": (REPL_RESUME_IN_RING, 0, 0), "past_ring": (0, 1, 1)}
    for leg, (deltas, snaps, sent) in want.items():
        got = out[leg]
        if (got["deltas_replayed"], got["snapshots"], got["snapshots_sent"]) != (deltas, snaps, sent):
            raise AssertionError(f"replicated resume {leg}: {got}")
    return out


def tenant_loop(port: int, tenants, seconds: float, now0: float) -> dict:
    """One closed-loop keep-alive client per tenant, each posting a unique
    explicit ``now`` (no cache hit, no coalescing) for ``seconds``. A 429
    or 503 is a shed (the replica's admission control), counted apart;
    every 200 must be a card render; any other answer fails the leg."""
    import http.client
    import itertools
    import threading

    stop_at = time.perf_counter() + seconds
    lats, errors, lock = [], [], threading.Lock()
    shed = [0]
    counter = itertools.count(1)

    def loop(tenant):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        mine = []
        try:
            while time.perf_counter() < stop_at:
                body = json.dumps({"now": now0 + next(counter) * 1e-3, "refresh": False})
                t0 = time.perf_counter()
                conn.request("POST", "/v1/score", body=body.encode(), headers={
                    "Content-Type": "application/json", "crane-tenant": tenant,
                    "crane-deadline-ms": "10000"})
                resp = conn.getresponse()
                data = resp.read()
                if resp.status in (429, 503):
                    with lock:
                        shed[0] += 1
                    continue
                mine.append(time.perf_counter() - t0)
                if resp.status != 200 or not data.startswith(REPLICA_BODY):
                    errors.append((resp.status, data[:80]))
                    return
        except Exception as e:  # surfaced below
            errors.append(repr(e))
        finally:
            conn.close()
            with lock:
                lats.extend(mine)

    threads = [threading.Thread(target=loop, args=(t,)) for t in tenants]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or not lats:
        raise AssertionError(f"replicated storm: client errors {errors[:3]}")
    return {"served": len(lats), "shed": shed[0], "req_per_s": len(lats) / wall,
            "p50_ms": percentile(lats, 50) * 1e3, "p99_ms": percentile(lats, 99) * 1e3}


def repl_storm_leg(server, replicas, now0: float) -> dict:
    """REPL_CLIENTS closed-loop clients (one tenant each, spread over the
    replicas by the ring) through a 1-replica router, then the
    REPL_REPLICAS-replica hash router; per-replica counts strict-parsed
    from the router's /metrics."""
    from crane_scheduler_tpu_torch.service import ReplicaRouter

    primary = ("127.0.0.1", server.port)
    routers = {}
    try:
        for tag, members in (("1_replica", replicas[:1]), (f"{len(replicas)}_replicas", replicas)):
            router = ReplicaRouter([(r.name, "127.0.0.1", r.port) for r in members],
                                   primary=primary, mode="hash",
                                   lag_budget_versions=REPL_LAG_BUDGET)
            router.start()
            routers[tag] = router
        full = routers[f"{len(replicas)}_replicas"]
        per = {r.name: [] for r in replicas}
        k = 0
        while any(len(v) < REPL_CLIENTS // len(replicas) for v in per.values()):
            k += 1
            owner = full.route_for(f"tenant-{k}")
            if owner is not None and len(per[owner]) < REPL_CLIENTS // len(replicas):
                per[owner].append(f"tenant-{k}")
        tenants = [t for ts in per.values() for t in ts]
        out = {"tenants": per}
        for tag, router in routers.items():
            leg = tenant_loop(router.port, tenants, REPL_SECONDS, now0)
            status, text = http_json(router.port, "GET", "/metrics")
            fams = expfmt.parse_exposition(text.decode())
            served = {dict(labels)["replica"]: v for _, labels, v in
                      fams["crane_router_requests_total"]["samples"]}
            out[tag] = {**leg, "per_replica": served}
        if sorted(out[f"{len(replicas)}_replicas"]["per_replica"]) != sorted(per) or not all(
                v > 0 for v in out[f"{len(replicas)}_replicas"]["per_replica"].values()):
            raise AssertionError(f"replicated storm: not every replica served: {out}")
        return out, full, routers
    except BaseException:
        for router in routers.values():
            router.stop()
        raise


def repl_assign_leg(router, twin, now0: float) -> tuple:
    """``/v1/assign`` of SERVICE_ASSIGN_PODS pods through the hash router
    equals the CPU twin replica's ``assign_batch``; one K1 and one K2 per
    call."""
    reset_launches()
    ms = []
    for k in range(REPL_ASSIGN_CALLS):
        now = now0 + 7.0 * k
        t0 = time.perf_counter()
        status, data = http_json(router.port, "POST", "/v1/assign",
                                 {"numPods": SERVICE_ASSIGN_PODS, "now": now, "refresh": False},
                                 headers={"crane-tenant": "tenant-assign"})
        ms.append((time.perf_counter() - t0) * 1e3)
        doc = json.loads(data)
        if status != 200 or doc["backend"] != CARD:
            raise AssertionError(f"replicated assign: {status} {data[:120]!r}")
        want = twin.service.assign_batch(SERVICE_ASSIGN_PODS, now=now)
        if (doc["counts"], doc["unassigned"], doc["waterline"]) != (
                want.counts, want.unassigned, want.waterline):
            raise AssertionError(f"replicated assign: card != CPU twin at {now}")
    launched = read_launches("replicated assign")
    if launched != {"score": REPL_ASSIGN_CALLS, "gang": REPL_ASSIGN_CALLS, "drip": 0}:
        raise AssertionError(f"replicated assign: launches {launched}")
    return {"ms_per_call": ms, "ms_median": statistics.median(ms),
            "unassigned": doc["unassigned"], "waterline": doc["waterline"]}, launched


def cli_env() -> tuple:
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    return root, env


def start_cli(args, script: bool = False) -> tuple:
    """Start ``python -m args`` (``script``: this script with ``args``) from
    the checkout's root: (process, start)."""
    root, env = cli_env()
    head = [__file__] if script else ["-m"]
    proc = subprocess.Popen([sys.executable, *head, *args], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def finish_cli(started, timeout: float) -> tuple:
    """Wait for a ``start_cli`` process: (its last stdout line as JSON, s)."""
    proc, t0 = started
    try:
        stdout, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"{proc.args[2]} exited {proc.returncode}: {err[-600:]!r}")
    return json.loads(stdout.strip().splitlines()[-1]), time.perf_counter() - t0


def repl_cli_leg() -> tuple:
    """crane-scorer --demo-nodes --replicas 2 --f32 answers one score through
    its router from the card and exits 0 on SIGTERM; crane-annotator runs
    one pass over a JSON node file; crane-sim runs a short burst on the card.
    The three processes run at once."""
    import os

    root, _ = cli_env()
    nodes_file = os.path.join(root, BUILD_DIR, "annotator_nodes.json")
    os.makedirs(os.path.dirname(nodes_file), exist_ok=True)
    with open(nodes_file, "w") as f:
        json.dump([{"name": f"node-{i:05d}", "ip": f"10.9.{i >> 8}.{i & 255}"}
                   for i in range(CLI_ANNOTATOR_NODES)], f)
    annotator_run = start_cli(
        ["crane_scheduler_tpu_torch.cli.annotator_main", "--nodes-file", nodes_file,
         "--health-port", "0", "--run-seconds", "3"])
    sim_run = start_cli(
        ["crane_scheduler_tpu_torch.cli.sim_main", "--nodes", str(CLI_DEMO_NODES),
         "--pods", str(CLI_SIM_PODS), "--f32"])
    try:
        return scorer_cli(), check_annotator_sim_cli(annotator_run, sim_run)
    finally:
        for proc, _ in (annotator_run, sim_run):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def scorer_cli() -> dict:
    """crane-scorer with demo nodes and 2 replicas: one score through its
    router, SIGTERM, exit 0 and its kernel launches."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc, t0 = start_cli(
        ["crane_scheduler_tpu_torch.cli.service_main", "--f32",
         "--port", str(port), "--demo-nodes", str(CLI_DEMO_NODES), "--replicas", "2",
         "--lag-budget", "8", "--now-bucket", "0", "--run-seconds", "120"])
    try:
        while True:
            try:
                status, data = http_json(port, "GET", "/v1/router/status", timeout=10)
                st = json.loads(data)
                reps = st["replicas"]
                if (status == 200 and st["publishedVersion"] >= 0 and len(reps) == 2
                        and all(r["routable"] and r["appliedVersion"] == st["publishedVersion"]
                                for r in reps)):
                    break
            except OSError:
                pass
            if proc.poll() is not None or time.perf_counter() - t0 > 120:
                raise AssertionError("replicated cli: crane-scorer did not come up")
            time.sleep(0.2)
        up_s = time.perf_counter() - t0
        status, body = http_json(port, "POST", "/v1/score", {"now": NOW},
                                 headers={"crane-tenant": "t1"})
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            stdout, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, err = proc.communicate()
    doc = json.loads(body) if status == 200 else {}
    if (status != 200 or not body.startswith(REPLICA_BODY)
            or doc.get("version") != st["publishedVersion"]
            or len(doc.get("scores", ())) != CLI_DEMO_NODES):
        raise AssertionError(f"replicated cli: score {status} {body[:120]!r}")
    if proc.returncode != 0:
        raise AssertionError(f"replicated cli: crane-scorer exited {proc.returncode}: "
                             f"{err[-400:]!r}")
    scorer_launches = json.loads(stdout.strip().splitlines()[-1])["kernel_launches"]
    if scorer_launches["score"] < 1:
        raise AssertionError(f"replicated cli: crane-scorer launched {scorer_launches}")
    return {"up_s": up_s, "version": doc["version"], "exit": proc.returncode,
            "kernel_launches": scorer_launches}


def check_annotator_sim_cli(annotator_run, sim_run) -> dict:
    """crane-annotator's one pass and crane-sim's burst, both on the card."""
    annotator, annotator_s = finish_cli(annotator_run, timeout=120)
    want_synced = CLI_ANNOTATOR_NODES * len(DEFAULT_POLICY.spec.sync_period)
    if (annotator["synced"] != want_synced or annotator["sync_errors"]
            or annotator["device"] != CARD or annotator["schedulable"] != CLI_ANNOTATOR_NODES):
        raise AssertionError(f"replicated cli: crane-annotator {annotator}")
    simulated, sim_s = finish_cli(sim_run, timeout=120)
    if (simulated["scheduled"] != CLI_SIM_PODS or not simulated["device"].startswith(CARD)
            or simulated["kernel_launches"] != {"score": 1, "gang": 1}):
        raise AssertionError(f"replicated cli: crane-sim {simulated}")
    return {"annotator": {**annotator, "seconds": annotator_s},
            "sim": {**{k: simulated[k] for k in ("scheduled", "device", "kernel_launches",
                                                  "latency_ms")}, "seconds": sim_s}}


def phase_replicated(dev) -> tuple:
    """config 19's shape: a 50,000-node ``Simulator`` primary (seed 0,
    default policy) publishing the delta feed to REPL_REPLICAS replicas
    behind the hash router, float32 scoring; the annotator, sim,
    replicas, storm, router-assign and CLI legs."""
    from crane_scheduler_tpu_torch.cluster.replication import DeltaDecoder, DeltaPublisher
    from crane_scheduler_tpu_torch.service import ServingReplica
    from crane_scheduler_tpu_torch.sim import SimConfig, Simulator

    t_phase = time.perf_counter()
    by_path = {}
    rng = np.random.default_rng(SEED + 19)
    from crane_scheduler_tpu_torch.annotator import BindingRecords
    from crane_scheduler_tpu_torch.annotator.bindings import max_hot_value_time_range

    t0 = time.perf_counter()
    sim = Simulator(SimConfig(n_nodes=N_NODES, seed=SEED))
    build_s = time.perf_counter() - t0
    heap = sim.annotator.binding_records
    column = sim.metrics._columns[DEFAULT_POLICY.spec.sync_period[0].name]()
    if type(heap).__name__ != "NativeBindingRecords" or len(column) != 3:
        raise AssertionError(f"replicated: annotator heap {type(heap).__name__}, "
                             f"sim column of {len(column)}")
    annotator = repl_annotator_leg(sim, N_NODES)
    # the twin starts from the annotator leg's last sweep: every
    # annotation was rewritten at that `now` from an empty binding heap
    sim_twin = Simulator(SimConfig(n_nodes=N_NODES, seed=SEED))
    sim_twin.clock.advance(sim.clock.now() - sim_twin.clock.now())
    sim_twin.annotator.sync_all_once_bulk(sim_twin.clock.now())
    if node_annotations(sim_twin.cluster) != node_annotations(sim.cluster):
        raise AssertionError("replicated: CPU twin's first sweep != the primary's")
    # the sim's binding stream feeds a Python heap beside the C++ one
    tee = HeapTee(heap, BindingRecords(sim.annotator.config.binding_heap_size,
                                       max_hot_value_time_range(DEFAULT_POLICY.spec.hot_value)))
    sim.annotator.binding_records = sim.annotator.event_ingestor._records = tee
    sim_out, by_path["annotator_sim"] = repl_sim_leg(sim, sim_twin, dev)
    sim.annotator.binding_records = sim.annotator.event_ingestor._records = heap
    del sim_twin
    t0 = time.perf_counter()
    native = {"heap_type": type(heap).__name__,
              "heap": heap_twin_check(tee, DEFAULT_POLICY, sim.clock.now()),
              "render": render_twin_check(sim, DEFAULT_POLICY.spec.sync_period[0].name)}
    native["seconds"] = time.perf_counter() - t0
    del tee

    # the replicated tier: the primary renders version-stamped bodies too,
    # so its bytes can be held against the replicas'
    pub = DeltaPublisher(sim.cluster, ring_frames=REPL_RING)
    primary_svc = ScoringService(sim.cluster, DEFAULT_POLICY, dtype=torch.float32, device=dev,
                                 now_bucket_s=0.0, version_source=lambda: pub.published_version)
    server = ScoringHTTPServer(primary_svc, port=0, frontend="async", replication=pub)
    server.start()
    replicas, routers = [], {}
    try:
        t0 = time.perf_counter()
        pub.publish_window()
        genesis_publish_ms = (time.perf_counter() - t0) * 1e3
        genesis_bytes = len(pub._ring[-1][2])
        twin = ServingReplica(DEFAULT_POLICY, name="cpu-twin", dtype=torch.float32,
                              device="cpu", now_bucket_s=0.0)

        def twin_send(blob: bytes) -> bool:
            for frame in DeltaDecoder().feed(blob):
                twin.mirror.apply_frame(frame)
            return True

        pub.subscribe(twin_send, twin.mirror.applied_version, name="cpu-twin")
        t0 = time.perf_counter()
        for i in range(REPL_REPLICAS):
            r = ServingReplica(DEFAULT_POLICY, name=f"replica-{i}",
                               feed=("127.0.0.1", server.port), dtype=torch.float32,
                               device=dev, now_bucket_s=0.0)
            r.start()
            replicas.append(r)
        for r in replicas:
            wait_until(lambda r=r: r.applied_version == pub.published_version,
                       f"{r.name} genesis")
        genesis_catch_up_ms = (time.perf_counter() - t0) * 1e3
        services = [primary_svc, twin.service] + [r.service for r in replicas]
        before = [s.metrics()["score_calls"] for s in services]
        reset_launches()
        now0 = sim.clock.now()
        identity = identity_check(pub, server, replicas, twin,
                                  [now0 + 17.0 * k for k in range(REPL_NOWS)])
        churn = repl_churn_leg(sim, pub, replicas, rng)
        identity_churn = identity_check(pub, server, replicas, twin, [now0 + 600.0])
        resume = repl_resume_leg(sim, pub, server, replicas[-1])
        identity_resume = identity_check(pub, server, replicas, twin, [now0 + 900.0])
        storm, full_router, routers = repl_storm_leg(server, replicas, now0 + 5000.0)
        card_renders = sum(s.metrics()["score_calls"] - b
                           for s, b in zip(services, before) if s is not twin.service)
        launched = read_launches("replicated replicas", need=("score",))
        if launched != {"score": card_renders, "gang": 0, "drip": 0}:
            raise AssertionError(f"replicated replicas: launches {launched} for "
                                 f"{card_renders} card renders")
        by_path["replicas"] = launched
        for s in services:
            no_fallback(s, "replicated")
        assign, by_path["router_assign"] = repl_assign_leg(full_router, twin, now0 + 9000.0)
        no_fallback(twin.service, "replicated assign (twin)")
        for r in replicas:
            no_fallback(r.service, "replicated assign")
        statuses = {r.name: r.status() for r in replicas}
    finally:
        for router in routers.values():
            router.stop()
        for r in replicas:
            r.stop()
        pub.stop()
        server.stop()
    scorer, others = repl_cli_leg()
    cli = {"scorer": scorer, **others}
    by_path["cli_demo"] = scorer["kernel_launches"]
    out = {
        "nodes": N_NODES, "replicas": REPL_REPLICAS, "sim_build_s": build_s,
        "annotator": annotator, "sim": sim_out, "native": native,
        "genesis": {"publish_ms": genesis_publish_ms, "frame_bytes": genesis_bytes,
                    "catch_up_ms": genesis_catch_up_ms},
        "identity": identity, "identity_after_churn": identity_churn,
        "identity_after_resume": identity_resume, "churn": churn, "resume": resume,
        "storm": storm, "assign": assign, "replica_status": statuses, "cli": cli,
        "launches": by_path, "seconds": time.perf_counter() - t_phase,
    }
    log("replicated", **out)
    return out, by_path


# -- the operator front doors: the descheduler's closed loop, crane-scheduler,
#    crane-descheduler and the open-loop storm ---------------------------------

DESCHED_HOT = 2  # bench config 11's hot nodes; the rest are cool
DESCHED_HOT_WORKERS = 12  # one-CPU workers per hot node, beside two decoys
DESCHED_CYCLES = 8  # config 11 runs 12; the hot nodes are drained by cycle 5
DESCHED_STEP_S = 60.0
DESCHED_WINDOW = 4  # the cycle budget: one cycle's evictees fill one drip window
DESCHED_ALLOC_MILLI = 16_000
DESCHED_ALLOCATABLE = {"cpu": "16", "pods": "110"}
DESCHED_METRICS = ("cpu_usage_avg_5m", "cpu_usage_max_avg_1h", "cpu_usage_max_avg_1d",
                   "mem_usage_avg_5m", "mem_usage_max_avg_1h", "mem_usage_max_avg_1d")
ONE_CPU = (Container("c", ResourceRequirements(requests={"cpu": "1"})),)


def desched_cluster(n: int) -> tuple:
    """Config 11's cluster widened to ``n`` nodes: DESCHED_HOT hot nodes with
    12 one-CPU workers, a DaemonSet and a kube-system decoy each (14/16
    cpus requested); every other node one one-CPU pod."""
    cluster = ClusterState()
    hot = [f"hot-{i}" for i in range(DESCHED_HOT)]
    cool = [f"cool-{i}" for i in range(n - DESCHED_HOT)]
    for name in hot + cool:
        cluster.add_node(Node(name=name, allocatable=DESCHED_ALLOCATABLE))
    pods = []
    for node in hot:
        pods += [Pod(name=f"{node}-w{j}", containers=ONE_CPU, node_name=node)
                 for j in range(DESCHED_HOT_WORKERS)]
        pods.append(Pod(name=f"{node}-ds", containers=ONE_CPU, node_name=node,
                        owner_references=(OwnerReference(kind="DaemonSet", name="agent"),)))
        pods.append(Pod(name=f"{node}-sys", namespace="kube-system", containers=ONE_CPU,
                        node_name=node))
    pods += [Pod(name=f"{node}-w0", containers=ONE_CPU, node_name=node) for node in cool]
    cluster.add_pods(pods)
    return cluster, hot + cool


def requested_milli(cluster: ClusterState, names) -> dict:
    return {n: sum(pod_fit_request(p).milli_cpu for p in cluster.list_pods(n)) for n in names}


def imbalance(milli: dict) -> float:
    vals = list(milli.values())
    return max(vals) / (sum(vals) / len(vals))


def profile_once(fn) -> tuple:
    """``fn()`` under ``torch.profiler``: its result, and the device kernels,
    device us and host kernel-launch calls the session recorded (late in a
    long process a short session can keep every host call and only some
    device records, or none: then the device fields are None)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    device = device_events(prof)
    return result, {
        "device_kernels": sum(count for key, (count, _) in device.items()
                              if not key.startswith(("Memcpy", "Memset"))) if device else None,
        "device_us": sum(us for _, us in device.values()) if device else None,
        "cuda_launch_kernel_calls": sum(e.count for e in prof.key_averages()
                                        if e.key == "cudaLaunchKernel"),
    }


def desched_leg(mode: str, dev) -> dict:
    """One leg of config 11's closed loop at N_NODES nodes: every cycle the
    six metrics are written from pod requests (``patch_node_annotations_bulk``),
    then (``mode`` "card" or "cpu") ``sync_once`` and the re-placement of
    the cycle's evictees: the card leg through the drip window
    (``schedule_queue`` on the card), the CPU twin one by one
    (``schedule_one``, ``device="cpu"``). ``mode`` "none" runs no descheduler."""
    cluster, names = desched_cluster(N_NODES)
    milli = requested_milli(cluster, names)
    total, start = sum(milli.values()), imbalance(milli)
    clock = [NOW]
    desched = sched = None
    if mode != "none":
        desched = LoadAwareDescheduler(
            cluster, DEFAULT_POLICY,
            DeschedulerConfig(
                watermarks=(WatermarkPolicy("cpu_usage_avg_5m", target=0.32, threshold=0.35),),
                consecutive_syncs=2, max_evictions_per_node=2, max_evictions_per_cycle=4,
                node_cooldown_seconds=0.0),
            clock=lambda: clock[0])
        sched = Scheduler(cluster, clock=lambda: clock[0], device=dev if mode == "card" else "cpu")
        sched.register(ResourceFitPlugin(FitTracker(cluster)), weight=1)
        sched.register(DynamicPlugin(DEFAULT_POLICY, clock=lambda: clock[0]), weight=3)
    reports, placed, timings, profiled = [], [], [], None
    for cycle in range(DESCHED_CYCLES):
        clock[0] = NOW + cycle * DESCHED_STEP_S
        t0 = time.perf_counter()
        stamp = format_local_time(clock[0])
        cluster.patch_node_annotations_bulk({
            n: {m: f"{u / DESCHED_ALLOC_MILLI:.5f},{stamp}" for m in DESCHED_METRICS}
            for n, u in requested_milli(cluster, names).items()})
        t1 = time.perf_counter()
        row = {"annotate_ms": (t1 - t0) * 1e3}
        if desched is not None:
            report = desched.sync_once(clock[0])
            t2 = time.perf_counter()
            per_node: dict = {}
            for ev in report.evicted:
                per_node[ev.node] = per_node.get(ev.node, 0) + 1
            if len(report.evicted) > 4 or any(c > 2 for c in per_node.values()):
                raise AssertionError(f"desched {mode}: cycle {cycle} over budget: {per_node}")
            moved = [Pod(name=f"moved-{cycle}-{i}", containers=ONE_CPU)
                     for i in range(len(report.evicted))]
            cluster.add_pods(moved)
            if mode == "card":
                replace = lambda: sched.schedule_queue(moved, window=DESCHED_WINDOW)  # noqa: E731
                # profile the second window: the first builds and uploads
                # the columns, and its time is kept unprofiled
                if moved and profiled is None and sched.drip_stats()["batch"]["dispatches"]:
                    results, prof = profile_once(replace)
                    profiled = {"cycle": cycle, **prof}
                else:
                    results = replace()
            else:
                results = [sched.schedule_one(p) for p in moved]
            t3 = time.perf_counter()
            row.update(sync_ms=(t2 - t1) * 1e3, replace_ms=(t3 - t2) * 1e3, moved=len(moved))
            reports.append(dataclasses.asdict(report))
            placed.append([r.node for r in results])
        timings.append(row)
    milli = requested_milli(cluster, names)
    out = {"reports": reports, "placed": placed, "timings": timings, "profiled": profiled,
           "imbalance_start": start, "imbalance_final": imbalance(milli),
           "max_util_final": max(milli.values()) / DESCHED_ALLOC_MILLI,
           "mean_util_final": sum(milli.values()) / len(milli) / DESCHED_ALLOC_MILLI,
           "total_milli": total, "final_milli": sum(milli.values())}
    if sched is not None:
        out["drip_stats"] = {k: v for k, v in sched.drip_stats().items() if k != "batch"}
        out["windows"] = sched.drip_stats()["batch"]["dispatches"]
        out["stage_seconds"] = sched.drip_stats()["batch"]["stage_seconds"]
    return out


def phase_desched(dev) -> tuple:
    """Config 11's closed loop at N_NODES nodes: no descheduler; the
    descheduler with re-placement through the drip window on the card; and
    its CPU twin (``schedule_one`` on the CPU). The card leg's cycle
    reports and re-placements equal the twin's; no protected victim, both
    budgets in every cycle, requested cpu conserved, every evictee
    re-placed, and the imbalance down by at least 2x (config 11's gate)."""
    t_phase = time.perf_counter()
    none = desched_leg("none", dev)
    reset_launches()
    card = desched_leg("card", dev)
    launched = read_launches("desched window", need=("drip",))
    # the re-placement is the drip window: K3, and neither K1 nor K2
    if launched["score"] or launched["gang"]:
        raise AssertionError(f"desched: K1/K2 launched on the re-placement path: {launched}")
    cpu = desched_leg("cpu", dev)
    if card["reports"] != cpu["reports"] or card["placed"] != cpu["placed"]:
        raise AssertionError("desched: the card leg's reports or re-placements != the CPU twin's")
    evicted = [e for r in card["reports"] for e in r["evicted"]]
    placed = [node for cyc in card["placed"] for node in cyc]
    if not evicted or len(placed) != len(evicted) or any(node is None for node in placed):
        raise AssertionError(f"desched: {len(evicted)} evicted, re-placed {placed}")
    if any(not e["pod_key"].startswith("default/") or e["pod_key"].endswith("-ds")
           for e in evicted):
        raise AssertionError(f"desched: a protected victim: {evicted}")
    for leg in (none, card, cpu):
        if leg["final_milli"] != leg["total_milli"]:
            raise AssertionError("desched: requested cpu not conserved")
    reduction = none["imbalance_final"] / card["imbalance_final"]
    if reduction < 2.0:
        raise AssertionError(f"desched: imbalance reduction {reduction:.3f}x < 2x")
    if card["windows"] < 1:
        raise AssertionError("desched: no drip window dispatched on the card")

    def ms(leg, key):
        return [round(t[key], 3) for t in leg["timings"] if key in t]

    out = {
        "nodes": N_NODES, "cycles": DESCHED_CYCLES, "evictions": len(evicted),
        "evictions_per_cycle": [len(r["evicted"]) for r in card["reports"]],
        "hot_per_cycle": [len(r["hot"]) for r in card["reports"]],
        "card_equals_cpu_twin": True, "imbalance_reduction": reduction,
        "imbalance": {"no_descheduler": none["imbalance_final"],
                      "descheduler": card["imbalance_final"], "start": card["imbalance_start"]},
        "max_util_final": card["max_util_final"], "mean_util_final": card["mean_util_final"],
        "annotate_ms": ms(card, "annotate_ms"), "sync_once_ms": ms(card, "sync_ms"),
        "replace_window_ms": ms(card, "replace_ms"), "cpu_twin_sync_once_ms": ms(cpu, "sync_ms"),
        "cpu_twin_replace_ms": ms(cpu, "replace_ms"),
        "no_descheduler_annotate_ms": ms(none, "annotate_ms"),
        "windows": card["windows"], "window_stage_seconds": card["stage_seconds"],
        "profiled_window": card["profiled"], "drip_stats": card["drip_stats"],
        "launches": launched, "seconds": time.perf_counter() - t_phase,
    }
    log("desched", **out)
    return out, launched


FD_DEMO_NODES = str(N_NODES)
NUMA_CONFIG = "deploy/noderesourcetopology/scheduler-config.yaml"
FD_CASES = {  # crane-scheduler's sim mode: flags, the bursts (K2 launches) it makes
    # depth cut for the script's wall time: plugin 256 -> 128 pods
    "cli_batch": (["--demo-nodes", FD_DEMO_NODES, "--pods", "20000", "--batch-size", "10000"], 2),
    "cli_plugin": (["--demo-nodes", FD_DEMO_NODES, "--pods", "128"], 0),
    # the NUMA profile's plugin loop is about 0.5 s per pod at 50,000 nodes:
    # 32 pods (cut from 64 to keep the script's wall time)
    "cli_numa": (["--config", NUMA_CONFIG, "--demo-nodes", FD_DEMO_NODES, "--pods", "32"], 0),
}
DESCHED_CLI_SECONDS = 8.0
SCHEDULER_TWIN_ARG = "--scheduler-twin"  # the child mode of front_doors' CPU twins


class DeschedulerCLI:
    """crane-descheduler as a subprocess at N_NODES demo nodes in dry-run;
    a thread reads its output, finds its health port and scrapes
    ``/metrics`` once, mid-run, strictly parsed."""

    def __init__(self):
        import tempfile
        import threading

        root, env = cli_env()
        self.err = tempfile.TemporaryFile(mode="w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "crane_scheduler_tpu_torch.cli.descheduler_main",
             "--demo-nodes", FD_DEMO_NODES, "--dry-run", "--sync-period-seconds", "1",
             "--run-seconds", str(DESCHED_CLI_SECONDS), "--health-port", "0"],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=self.err, text=True)
        self.lines: list = []
        self.scrape: dict = {}
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _watch(self) -> None:
        import re

        for line in self.proc.stdout:
            self.lines.append(line.strip())
            m = re.search(r"healthz\+metrics on :(\d+)", line)
            if m and not self.scrape:
                time.sleep(DESCHED_CLI_SECONDS / 2)  # a few cycles in
                try:
                    status, body = http_json(int(m.group(1)), "GET", "/metrics", timeout=30)
                    self.scrape = {"status": status, "text": body.decode()}
                except OSError as e:
                    self.scrape = {"status": 0, "error": repr(e)}

    def finish(self) -> dict:
        try:
            self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=30)
        self.err.seek(0)
        err = self.err.read()
        self.err.close()
        if self.proc.returncode != 0:
            raise AssertionError(f"crane-descheduler exited {self.proc.returncode}: {err[-600:]!r}")
        stats = json.loads(self.lines[-1])
        if sorted(stats) != ["cycles", "evictions", "hot_streaks"] or stats["cycles"] < 1 \
                or stats["evictions"] != 0:
            raise AssertionError(f"crane-descheduler stats {stats}")
        if self.scrape.get("status") != 200:
            raise AssertionError(f"crane-descheduler /metrics: {self.scrape}")
        families = expfmt.parse_exposition(self.scrape["text"])
        want = ("crane_desched_evictions_total", "crane_desched_hotspot_nodes",
                "crane_desched_skips_total", "crane_desched_cycle_seconds")
        missing = [f for f in want if f not in families]
        cycles_seen = sum(v for name, _, v in families["crane_desched_cycle_seconds"]["samples"]
                          if name.endswith("_count"))
        if missing or cycles_seen < 1:
            raise AssertionError(f"crane-descheduler /metrics: missing {missing}, "
                                 f"{cycles_seen} cycles")
        return {"stats": stats, "seconds": time.perf_counter() - self.t0,
                "metrics_cycles_at_scrape": cycles_seen,
                "desched_samples": {f: [s for s in families[f]["samples"]
                                        if not s[0].endswith("_bucket")] for f in want}}


def scheduler_cli(argv) -> dict:
    """crane-scheduler's ``main`` in this process: its result line, and the
    sorted (pod, node) placements of the simulation it built, as a count
    and a sha256 digest (``Simulator`` is wrapped for the call to keep
    the instance)."""
    import contextlib
    import hashlib
    import io

    from crane_scheduler_tpu_torch import sim as sim_module
    from crane_scheduler_tpu_torch.cli import scheduler_main

    built, base = [], sim_module.Simulator

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    buf = io.StringIO()
    sim_module.Simulator = Recorded
    try:
        with contextlib.redirect_stdout(buf):
            rc = scheduler_main.main(argv)
    finally:
        sim_module.Simulator = base
    if rc != 0 or len(built) != 1:
        raise AssertionError(f"crane-scheduler {argv} exited {rc}, {len(built)} simulations")
    pairs = sorted((p.key(), p.node_name) for p in built[0].cluster.list_pods() if p.node_name)
    return {"line": json.loads(buf.getvalue().strip().splitlines()[-1]),
            "placements": {"pods": len(pairs),
                           "sha256": hashlib.sha256(json.dumps(pairs).encode()).hexdigest()}}


def scheduler_twin_child(argv) -> int:
    """The child mode ``SCHEDULER_TWIN_ARG``: ``scheduler_cli(argv)`` as one
    JSON line (front_doors' CPU twins run so, beside the card runs)."""
    print(json.dumps(scheduler_cli(argv)), flush=True)
    return 0


def run_scheduler_cli(argv, dev) -> dict:
    """crane-scheduler in-process on ``dev`` (the card): ``scheduler_cli``'s
    line and placements, and the kernels' launches over the call."""
    reset_launches()
    t0 = time.perf_counter()
    out = scheduler_cli([*argv, "--device", dev.type])
    seconds = time.perf_counter() - t0
    return {**out, "launches": {name: kernel.launches for name, kernel in KERNELS.items()},
            "seconds": seconds}


def phase_front_doors(dev) -> tuple:
    """crane-scheduler's sim mode at N_NODES demo nodes in batch, plugin and
    NUMA-plugin mode, in-process on the card, each line equal to the same
    flags on ``--device cpu`` (run as subprocesses meanwhile), K2 once per
    batch burst; crane-descheduler as a subprocess in dry-run, its
    ``/metrics`` scraped mid-run. The subprocesses start first, so all
    overlap."""
    t_phase = time.perf_counter()
    desched_cli = DeschedulerCLI()
    twins = {case: start_cli([SCHEDULER_TWIN_ARG, *argv, "--device", "cpu"], script=True)
             for case, (argv, _) in FD_CASES.items()}
    by_path, runs = {}, {}
    try:
        for case, (argv, bursts) in FD_CASES.items():
            runs[case] = run_scheduler_cli(argv, dev)
            launched = runs[case]["launches"]
            # float64 scoring (the CLI's default) launches no K1; each batch
            # burst is one combined step with one K2 launch
            if launched != {"score": 0, "gang": bursts, "drip": 0}:
                raise AssertionError(f"crane-scheduler {case}: launches {launched}, "
                                     f"want K1 0, K2 {bursts}")
            by_path[case] = launched
        for case, started in twins.items():
            twin_out, twin_s = finish_cli(started, timeout=600)
            twin, card = dict(twin_out["line"]), dict(runs[case]["line"])
            card_s = card.pop("wall_seconds")
            runs[case]["cpu_wall_seconds"] = twin.pop("wall_seconds")
            runs[case]["cpu_process_seconds"] = twin_s
            runs[case]["wall_seconds"] = card_s
            if card != twin:
                raise AssertionError(f"crane-scheduler {case}: card {card} != cpu {twin}")
            # the same counts could hide a different placement: hold every
            # (pod, node) pair equal too
            placed = runs[case]["placements"]
            if placed != twin_out["placements"] or \
                    placed["pods"] != card["scheduled"]:
                raise AssertionError(f"crane-scheduler {case}: card placements {placed} != "
                                     f"cpu {twin_out['placements']}")
    finally:
        for proc, _ in twins.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        descheduler = desched_cli.finish()
    out = {
        "nodes": N_NODES,
        "scheduler": {case: {"line": r["line"], "placements": r["placements"],
                             "wall_seconds": r.get("wall_seconds"),
                             "in_process_seconds": r["seconds"],
                             "cpu_wall_seconds": r.get("cpu_wall_seconds"),
                             "cpu_process_seconds": r.get("cpu_process_seconds"),
                             "launches": r["launches"]} for case, r in runs.items()},
        "card_equals_cpu": True, "placements_equal_cpu": True, "descheduler": descheduler,
        "seconds": time.perf_counter() - t_phase,
    }
    log("front_doors", **out)
    return out, by_path


STORM_SEED = 17  # bench config 17's seed
STORM_WARM = 6
STORM_UNLOADED = 40
STORM_PEAK_S = 0.8
STORM_PEAK_WORKERS = 4
STORM_X = 3.0
STORM_MAX_S = 1.5
STORM_MAX_REQUESTS = 600  # config 17's cap on the thread-per-request harness
STORM_DEADLINE_MS = 10_000.0
STORM_PROBE_S = 0.05


def storm_admission(clock=None, brownout=None, telemetry=None):
    from crane_scheduler_tpu_torch.service import AdmissionController
    from crane_scheduler_tpu_torch.service.overload import GradientLimiter, TenantQueues

    return AdmissionController(
        limiter=GradientLimiter(min_limit=2, max_limit=4, initial=4),
        queues=TenantQueues(depth=2), brownout=brownout, telemetry=telemetry,
        clock=clock or time.monotonic)


def phase_storm(dev) -> tuple:
    """Bench config 17's shape at N_NODES nodes: a float32 ``ScoringService``
    (``now_bucket_s=0``) on the card behind the async front end with
    admission control, brownout and the idle reaper; warm, unloaded,
    closed-loop peak, the seeded open-loop storm at 3x peak with a
    ``/healthz`` prober, the deadline leg, and two virtual-time replays."""
    import threading

    from crane_scheduler_tpu_torch.resilience import (
        StormSchedule,
        replay_admission,
        run_open_loop,
        timeline_counts,
    )
    from crane_scheduler_tpu_torch.service import BrownoutController
    from crane_scheduler_tpu_torch.sim import SimConfig, Simulator

    t_phase = time.perf_counter()
    sim = Simulator(SimConfig(n_nodes=N_NODES, seed=STORM_SEED))
    sim.sync_metrics()
    setup_s = time.perf_counter() - t_phase
    svc = ScoringService(sim.cluster, DEFAULT_POLICY, dtype=torch.float32, device=dev,
                         now_bucket_s=0.0)
    svc.refresh()
    brownout = BrownoutController(telemetry=svc.telemetry)
    admission = storm_admission(brownout=brownout, telemetry=svc.telemetry)
    server = ScoringHTTPServer(svc, port=0, frontend="async", admission=admission,
                               brownout=brownout, idle_timeout_s=5.0)
    server.start()
    now0 = sim.clock.now()
    counter, lock = [0], threading.Lock()
    bad_bodies = []

    def fresh_body(*_):
        # a unique `now` per request: every accepted request is a render
        with lock:
            counter[0] += 1
            return json.dumps({"now": now0 + counter[0] * 1e-4, "refresh": False}).encode()

    def post(body, headers=None):
        t0 = time.perf_counter()
        status, data = http_json(server.port, "POST", "/v1/score", json.loads(body),
                                 headers=headers, timeout=60)
        if status == 200 and not data.startswith(CARD_BODY):
            bad_bodies.append(data[:80])
        return status, time.perf_counter() - t0

    before = svc.metrics()
    reset_launches()
    try:
        for _ in range(STORM_WARM):
            if post(fresh_body())[0] != 200:
                raise AssertionError("storm: a warm request failed")
        unloaded = []
        for _ in range(STORM_UNLOADED):
            status, dt = post(fresh_body())
            if status != 200:
                raise AssertionError(f"storm: an unloaded request answered {status}")
            unloaded.append(dt)
        unloaded_p99 = percentile(unloaded, 99)
        peak_stop = time.perf_counter() + STORM_PEAK_S
        served = [0] * STORM_PEAK_WORKERS

        def closed(slot):
            while time.perf_counter() < peak_stop:
                if post(fresh_body())[0] == 200:
                    served[slot] += 1
                else:
                    time.sleep(0.002)

        workers = [threading.Thread(target=closed, args=(i,)) for i in range(STORM_PEAK_WORKERS)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        peak_rps = max(sum(served) / (time.perf_counter() - t0), 1.0)

        storm_rps = STORM_X * peak_rps
        duration = min(STORM_MAX_S, STORM_MAX_REQUESTS / storm_rps)
        schedule = StormSchedule(STORM_SEED, duration_s=duration, phases=[(0.0, storm_rps)],
                                 deadline_ms=STORM_DEADLINE_MS)
        probes, probe_stop = [], threading.Event()

        def prober():
            while not probe_stop.is_set():
                try:
                    probes.append(http_json(server.port, "GET", "/healthz", timeout=5)[0])
                except OSError:
                    probes.append(0)
                probe_stop.wait(STORM_PROBE_S)

        probe_thread = threading.Thread(target=prober, daemon=True)
        probe_thread.start()
        t0 = time.perf_counter()
        results = run_open_loop("127.0.0.1", server.port, schedule.arrivals,
                                target="/v1/score", body_fn=fresh_body, timeout_s=60.0)
        storm_wall = time.perf_counter() - t0
        probe_stop.set()
        probe_thread.join(timeout=5.0)
        accepted = [r for r in results if r.status == 200]
        shed = [r for r in results if r.status in (429, 503, 504)]
        errors = [r for r in results if r.status == 0]
        if errors:
            raise AssertionError(f"storm: transport errors {[r.error for r in errors[:3]]}")
        if len(accepted) + len(shed) != len(results):
            raise AssertionError(f"storm: statuses {sorted({r.status for r in results})}")
        if not probes or any(c != 200 for c in probes):
            raise AssertionError(f"storm: /healthz answered {[c for c in probes if c != 200]}")
        goodput_rps = len(accepted) / duration
        accepted_p99 = percentile([r.latency_s for r in accepted], 99) if accepted else None

        expired = [post(fresh_body(), {"crane-deadline-ms": "-1"})[0] for _ in range(10)]
        if any(s != 504 for s in expired):
            raise AssertionError(f"storm: budget -1 answered {expired}")
        tight = [post(fresh_body(), {"crane-deadline-ms": "0.001"})[0] for _ in range(10)]
        m = svc.metrics()
        if m["expired_at_dispatch"] != 0 or m["fallbacks"] != 0 or bad_bodies:
            raise AssertionError(f"storm: expired at dispatch {m['expired_at_dispatch']}, "
                                 f"fallbacks {m['fallbacks']}, bodies {bad_bodies[:2]}")
        renders = m["score_calls"] - before["score_calls"]
        launched = {name: kernel.launches for name, kernel in KERNELS.items()}

        service_time = max(1.0 / peak_rps, 1e-4)
        t1 = replay_admission(schedule.arrivals, storm_admission, service_time_s=service_time)
        t2 = replay_admission(schedule.arrivals, storm_admission, service_time_s=service_time)
        if t1 != t2:
            raise AssertionError("storm: the same seed replayed to different timelines")
        shed_stats = dict(admission.stats)
    finally:
        server.stop()
    out = {
        "nodes": N_NODES, "setup_s": setup_s, "unloaded_p99_ms": unloaded_p99 * 1e3,
        "unloaded_p50_ms": percentile(unloaded, 50) * 1e3, "peak_rps": peak_rps,
        "storm_rps": storm_rps, "storm_s": duration, "storm_wall_s": storm_wall,
        "arrivals": len(results), "accepted": len(accepted), "shed": len(shed),
        "shed_by_status": {s: sum(r.status == s for r in shed) for s in (429, 503, 504)},
        "goodput_rps": goodput_rps, "goodput_share_of_peak": goodput_rps / peak_rps,
        "accepted_p99_ms": accepted_p99 * 1e3 if accepted_p99 is not None else None,
        "p99_limit_ms": (2.0 * unloaded_p99 + 0.050) * 1e3,
        "reference_gates": {"goodput_share_of_peak_min": 0.8,
                            "accepted_p99_max": "2 x unloaded p99 + 50 ms"},
        "healthz_probes": len(probes), "expired_at_dispatch": 0,
        "deadline_minus_1": expired, "deadline_1us_504": sum(s == 504 for s in tight),
        "replay_equal": True, "replay_counts": timeline_counts(t1),
        "card_renders": renders, "brownout_served": m["brownout_served"] - before["brownout_served"],
        "admission": shed_stats, "launches": launched,
        "seconds": time.perf_counter() - t_phase,
    }
    if launched != {"score": renders, "gang": 0, "drip": 0} or renders < 1:
        raise AssertionError(f"storm: launches {launched} for {renders} card renders")
    log("storm", **out)
    return out, launched


# -- kube: the kube mirror over the wire stub -----------------------------------

KUBE_PAGE = 2000  # list_page_limit (bench config 9)
KUBE_POLICY = "deploy/dynamic/policy-12metrics.yaml"  # config 9's 12 metrics
KUBE_STAMP = "2026-07-30T00:00:00Z"  # the stub's seeded annotation timestamp
KUBE_STORM = 20_000  # node MODIFIED events of the read leg's watch storm
KUBE_PATCH_NODES = N_NODES // 100  # the 1% named patch before the dirty refresh
KUBE_BURSTS = 2
KUBE_BURST_PODS = 10_000
KUBE_DRIP_PODS = DRIP_PODS
KUBE_GANG_NODES = 5_000  # config 22's wire_nodes
KUBE_CLI_NODES = 5_000
KUBE_CLI_PODS = 1_024
KUBE_CLI_BATCH = 256
KUBE_TWIN_ARG = "--kube-scheduler-twin"  # the child mode of the --master CPU twin


def load_kube_stub():
    """``tests/kube_stub.py`` (standard library only), loaded by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "kube_stub.py"
    spec = importlib.util.spec_from_file_location("kube_stub", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kube_now() -> float:
    from crane_scheduler_tpu_torch.utils.timeutil import parse_local_time

    return parse_local_time(KUBE_STAMP) + 30.0


def kube_node_t(node) -> tuple:
    return (node.name, dict(node.annotations),
            tuple((a.type, a.address) for a in node.addresses), dict(node.allocatable))


def kube_pod_t(pod) -> tuple:
    return (pod.name, pod.namespace, dict(pod.annotations),
            tuple((r.kind, r.name) for r in pod.owner_references), pod.containers,
            pod.node_name, pod.init_containers, dict(pod.overhead))


def seeded_node_t(i: int, metrics, extra=None) -> tuple:
    """The stub's ``seed`` node ``i`` as ``kube_node_t`` sees it."""
    anno = {m: f"{(i % 97) / 97:.5f},{KUBE_STAMP}" for m in metrics}
    anno.update(extra or {})
    return (f"node-{i:05d}", anno,
            (("InternalIP", f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"),),
            dict(DRIP_ALLOCATABLE))


def settle(client, server, offsets: dict, what: str, timeout: float = 120.0,
           rv: int | None = None) -> float:
    """Wait until the client's watches delivered the stub's last write (or
    resourceVersion ``rv``): for each kind, its stream's resourceVersion
    within ``offsets[kind]`` of it (a bind's pod MODIFIED precedes its
    Scheduled event by one). Returns the seconds waited."""
    if rv is None:
        rv = int(server.stats()["rv"])
    t0 = time.perf_counter()
    while not all(int(client._rvs.get(kind) or 0) >= rv - off for kind, off in offsets.items()):
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"kube: {what}: the watch did not catch up to rv {rv}: "
                                 f"{dict(client._rvs)}")
        time.sleep(0.005)
    return time.perf_counter() - t0


def hist_count_sum(tel, family: str, **labels) -> tuple:
    fams = expfmt.parse_exposition(tel.registry.render())
    count = total = 0.0
    for name, lab, value in fams.get(family, {}).get("samples", ()):
        if any(dict(lab).get(k) != v for k, v in labels.items()):
            continue
        if name.endswith("_count"):
            count += value
        elif name.endswith("_sum"):
            total += value
    return count, total


def sweep_store(client, policy) -> NodeLoadStore:
    store = NodeLoadStore(compile_policy(policy))
    nodes = client.list_nodes()
    store.bulk_ingest((n.name, n.annotations) for n in nodes)
    store.prune_absent(n.name for n in nodes)
    return store


def mirror_equals(client, want: list, what: str) -> None:
    got = sorted(map(kube_node_t, client.list_nodes()))
    if got != want:
        bad = next((g, w) for g, w in zip(got + [None] * len(want), want + [None] * len(got))
                   if g != w)
        raise AssertionError(f"kube: {what}: the mirror != the stub ({len(got)} nodes, "
                             f"first difference {bad})")


# -- the host library's routes against their twins (the `native` steps) ------------


def host_library_line() -> dict:
    """The host library's build: the compiler, this process's build seconds
    per library (empty when the keyed libraries already existed) and the
    loaded paths."""
    from crane_scheduler_tpu_torch.native import lib

    cxx = lib.compiler_command()
    version = lib.compiler_version(tuple(cxx))
    return {"compiler": " ".join(cxx), "compiler_version": version.splitlines()[0],
            "python_include": lib.python_include(),
            "python_headers": lib.python_headers_present(), "build_s": dict(lib.build_seconds),
            "libraries": lib.library_paths()}


def expected_list_backend() -> str:
    """The LIST decoder the client takes on this host: the object decoder
    where ``Python.h`` exists, else the columnar scanner."""
    from crane_scheduler_tpu_torch.native.lib import python_headers_present

    return "pylist" if python_headers_present() else "native"


def spy_list_backends() -> tuple[list, object]:
    """Record the decoder of every LIST page the client decodes (it imports
    ``decode_list_page`` from its module at each call). Returns the record
    and the function that stops it."""
    from crane_scheduler_tpu_torch.native import listdecode

    decode, seen = listdecode.decode_list_page, []

    def spy(*args, **kwargs):
        page = decode(*args, **kwargs)
        seen.append(page.backend)
        return page

    listdecode.decode_list_page = spy
    return seen, lambda: setattr(listdecode, "decode_list_page", decode)


def list_bodies(client, path: str, kind: int) -> list:
    """Every page body of a paginated LIST (``KUBE_PAGE`` items a page)."""
    from crane_scheduler_tpu_torch.native.listdecode import decode_list_page

    bodies, token = [], None
    while True:
        url = f"{path}?limit={KUBE_PAGE}" + (f"&continue={token}" if token else "")
        bodies.append(client._get_bytes(url))
        token = decode_list_page(bodies[-1], kind, native="pylist").cont
        if not token:
            return bodies


DECODE_ROUTES = {"pylist": "pylist", "native": True, "python": False}


def decode_three_ways(bodies, kind: int, to_t) -> dict:
    """Decode (and materialize) every page on each route; the models must
    be equal. Returns ms per route and the item count."""
    from crane_scheduler_tpu_torch.native.listdecode import decode_list_page

    ms, models = {}, {}
    for route, native in DECODE_ROUTES.items():
        t0 = time.perf_counter()
        pages = [decode_list_page(b, kind, native=native) for b in bodies]
        objs = [o for page in pages for o in page.materialize()]
        ms[route] = (time.perf_counter() - t0) * 1e3
        if {page.backend for page in pages} != {route}:
            raise AssertionError(f"native: {route} pages came back {[p.backend for p in pages]}")
        models[route] = [to_t(o) for o in objs]
    if not models["pylist"] == models["native"] == models["python"]:
        raise AssertionError(f"native: kind {kind} pages decode differently by route")
    return {"ms_by_backend": ms, "items": len(models["python"]), "pages": len(bodies)}


def reuse_check(bodies) -> dict:
    """The object decoder's resourceVersion reuse at full width: the node
    pages without their allocatable maps (an allocatable node is a
    per-object row, never a reuse marker), decoded once fresh and once with
    every row's rv known. Every row must come back a marker, and the fresh
    instances put in their place must equal a fresh decode. Without
    allocatable every node is built by the object decoder in C, so the
    fresh decode is also held against the scanner's and the twin's."""
    from crane_scheduler_tpu_torch.native.listdecode import decode_list_page

    # the stub renders each node's status as {"addresses": [...],
    # "allocatable": {...}}: cut the allocatable member out of the bytes
    member = (", " + json.dumps({"allocatable": DRIP_ALLOCATABLE})[1:-1]).encode()
    stripped = [body.replace(member, b"") for body in bodies]
    if sum(body.count(member) for body in bodies) != N_NODES:
        raise AssertionError("native: the node pages' allocatable members are not the stub's")
    t0 = time.perf_counter()
    fresh = [decode_list_page(b, 0, native="pylist") for b in stripped]
    fresh_objs = [o for page in fresh for o in page.materialize()]
    fresh_ms = (time.perf_counter() - t0) * 1e3
    if any(page.fallback_rows for page in fresh):
        raise AssertionError("native: a node without allocatable took the per-object path")
    fresh_t = list(map(kube_node_t, fresh_objs))
    for route in (True, False):
        objs = [o for b in stripped for o in decode_list_page(b, 0, native=route).materialize()]
        if list(map(kube_node_t, objs)) != fresh_t:
            raise AssertionError(f"native: the object decoder's nodes != native={route}'s")
    known = {n.name: rv for page in fresh for n, rv in zip(page.materialize(), page.rvs)}
    by_name = {n.name: n for n in fresh_objs}
    t0 = time.perf_counter()
    again = [decode_list_page(b, 0, known_rvs=known) for b in stripped]
    objs = [o for page in again for o in page.materialize()]
    reuse_ms = (time.perf_counter() - t0) * 1e3
    markers = sum(isinstance(o, str) for o in objs)
    reused = [by_name[o] if isinstance(o, str) else o for o in objs]
    if markers != len(fresh_objs) or None in known.values() or \
            list(map(kube_node_t, reused)) != fresh_t:
        raise AssertionError(f"native: reuse gave {markers} markers of {len(fresh_objs)} rows")
    return {"rows": len(objs), "markers": markers, "fresh_decode_ms": fresh_ms,
            "reuse_decode_ms": reuse_ms}


def per_line_watch(lines) -> tuple:
    """The per-line route of a drained node batch: ``json.loads`` per line."""
    from crane_scheduler_tpu_torch.cluster.kube_wire import node_from_json

    batch, last_rv, error_obj, n_seen = [], None, None, 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        n_seen += 1
        change = json.loads(line)
        change_type, obj = change.get("type", ""), change.get("object", {})
        if change_type == "ERROR":
            error_obj = obj
            break
        if change_type != "BOOKMARK":
            batch.append((change_type, node_from_json(obj)))
        obj_rv = obj.get("metadata", {}).get("resourceVersion")
        if obj_rv is not None:
            last_rv = obj_rv
    return batch, last_rv, error_obj, n_seen


def capture_node_watch(client) -> list:
    """Record every drained node batch the client parses, with its result
    (an instance attribute shadows the method; delete it to stop)."""
    captured = []
    parse = client._parse_watch_lines

    def capture(lines, rv_key):
        out = parse(lines, rv_key)
        if rv_key == "nodes":
            captured.append((list(lines), out))
        return out

    client._parse_watch_lines = capture
    return captured


def watch_twin_check(captured) -> dict:
    """Every captured batch took ``decode_watch_lines`` and equals the
    per-line route on the same lines."""
    from crane_scheduler_tpu_torch.native.listdecode import decode_watch_lines

    lines = model_s = per_line_s = 0
    for batch_lines, (batch, last_rv, error_obj, n_seen, model) in captured:
        t0 = time.perf_counter()
        want = per_line_watch(batch_lines)
        per_line_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        decode_watch_lines(b"\n".join(batch_lines), 0)
        model_s += time.perf_counter() - t0
        got = ([(t, kube_node_t(n)) for t, n in batch], last_rv, error_obj, n_seen)
        if not model or got != ([(t, kube_node_t(n)) for t, n in want[0]],) + want[1:]:
            raise AssertionError("native: a watch batch differs from the per-line route")
        lines += n_seen
    return {"batches": len(captured), "lines": lines, "decode_watch_lines_ms": model_s * 1e3,
            "per_line_ms": per_line_s * 1e3}


def codec_twin_check(raws) -> dict:
    """``bulk_parse_annotations`` against the numpy twin over one sweep's
    strings: equal values and timestamps (NaN where the twin has NaN)."""
    from crane_scheduler_tpu_torch.loadstore.codec import bulk_decode_annotations
    from crane_scheduler_tpu_torch.native.codec import bulk_parse_annotations

    t0 = time.perf_counter()
    got = bulk_parse_annotations(raws)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = bulk_decode_annotations(raws)
    twin_ms = (time.perf_counter() - t0) * 1e3
    for a, b in zip(got, want):
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError("native: bulk_parse_annotations != bulk_decode_annotations")
    return {"strings": len(raws), "native_ms": native_ms, "twin_ms": twin_ms,
            "finite_ts": int(np.isfinite(got[1]).sum())}


def check_bulk_routes(client, what: str) -> dict:
    """Every bulk flush of 128 or more rode the host library's engine."""
    native, pipelined = client.bulk_flushes["native"], client.bulk_flushes["pipelined"]
    if native[0] < 1 or pipelined[2] >= 128:
        raise AssertionError(f"native: {what}: bulk flushes {client.bulk_flushes}")
    return {k: dict(zip(("batches", "requests", "largest"), v))
            for k, v in client.bulk_flushes.items()}


def kube_read_leg(kube_stub, dev, tel) -> tuple:
    """Config 9's read path at 50,000 nodes: bootstrap, the columnar refresh
    against a sweep, a forced relist, a 20,000-event watch storm, a relist,
    and a 1% named patch over the wire through ``dirty_ingest``. Returns
    (line, server, client, batch scheduler, policy) for the bursts."""
    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient
    from crane_scheduler_tpu_torch.policy import load_policy_from_file

    policy = load_policy_from_file(KUBE_POLICY)
    metrics = [sp.name for sp in policy.spec.sync_period]
    now = kube_now()
    server = kube_stub.KubeStubSubprocess()
    client = None
    try:
        t0 = time.perf_counter()
        server.seed(N_NODES, "node-", metrics=metrics, allocatable=DRIP_ALLOCATABLE)
        seed_s = time.perf_counter() - t0
        client = KubeClusterClient(server.url, list_page_limit=KUBE_PAGE, telemetry=tel)
        seen, stop_spy = spy_list_backends()
        t0 = time.perf_counter()
        try:
            client.start()
        finally:
            stop_spy()
        bootstrap_ms = (time.perf_counter() - t0) * 1e3
        pages, decode_s = hist_count_sum(tel, "crane_kube_list_decode_seconds", kind="nodes")
        want = [seeded_node_t(i, metrics) for i in range(N_NODES)]
        mirror_equals(client, want, "bootstrap")
        boot_backends = {b: seen.count(b) for b in set(seen)}
        # the node pages and one pod page
        if boot_backends != {expected_list_backend(): int(pages) + 1}:
            raise AssertionError(f"kube: bootstrap pages by backend {boot_backends}")

        batch = BatchScheduler(client, policy, dtype=torch.float32, clock=lambda: now,
                               device=dev, telemetry=tel)
        stats = batch.refresh_stats
        t0 = time.perf_counter()
        batch.refresh()
        columnar_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        sweep = sweep_store(client, policy)
        sweep_ms = (time.perf_counter() - t0) * 1e3
        if stats["columnar_ingest"] != 1 or not rows_equal(store_rows(batch.store),
                                                           store_rows(sweep)):
            raise AssertionError(f"kube: the columnar refresh != the sweep ({stats})")

        t0 = time.perf_counter()
        client._relist_nodes()
        relist_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        batch.refresh()
        relist_refresh_ms = (time.perf_counter() - t0) * 1e3
        if stats["columnar_ingest"] != 2 or not rows_equal(
                store_rows(batch.store), store_rows(sweep_store(client, policy))):
            raise AssertionError("kube: the refresh after a relist != the sweep")

        applied0, batches0 = client.watch_applied, client.watch_batches
        coalesced0 = client.watch_coalesced
        rv0 = int(server.stats()["rv"])
        captured = capture_node_watch(client)
        t0 = time.perf_counter()
        server.storm("nodes", KUBE_STORM)  # the stub generates it on a thread
        storm_wait_s = settle(client, server, {"nodes": 0}, "storm", timeout=300.0,
                              rv=rv0 + KUBE_STORM)
        storm_s = time.perf_counter() - t0
        del client._parse_watch_lines
        applied = client.watch_applied - applied0
        want = [seeded_node_t(i, metrics, {"crane.io/storm": str(i)} if i < KUBE_STORM else None)
                for i in range(N_NODES)]
        mirror_equals(client, want, "watch storm")

        t0 = time.perf_counter()
        client._relist_nodes()
        storm_relist_ms = (time.perf_counter() - t0) * 1e3
        batch.refresh()
        rng = np.random.default_rng(SEED + 11)
        patched = sorted(rng.choice(N_NODES, KUBE_PATCH_NODES, replace=False).tolist())
        values = rng.uniform(0.0, 1.0, (len(patched), len(metrics)))
        stamp = KUBE_STAMP.replace(":00Z", ":10Z")
        per_node = {f"node-{i:05d}": {m: f"{values[j, k]:.5f},{stamp}"
                                      for k, m in enumerate(metrics)}
                    for j, i in enumerate(patched)}
        t0 = time.perf_counter()
        n_patched = client.patch_node_annotations_bulk(per_node)
        patch_ms = (time.perf_counter() - t0) * 1e3
        echo_s = settle(client, server, {"nodes": 0}, "patch echoes")
        dirty0 = stats["dirty_ingest"]
        t0 = time.perf_counter()
        batch.refresh()
        dirty_ms = (time.perf_counter() - t0) * 1e3
        if n_patched != KUBE_PATCH_NODES or stats["dirty_ingest"] != dirty0 + 1:
            raise AssertionError(f"kube: the 1% patch: {n_patched} patched, refresh {stats}")
        if not rows_equal(store_rows(batch.store), store_rows(sweep_store(client, policy))):
            raise AssertionError("kube: the dirty refresh != the sweep")
        for j, i in enumerate(patched):
            want[i][1].update(per_node[f"node-{i:05d}"])
        mirror_equals(client, want, "1% patch")
        if stats["columnar_ingest"] < 1 or stats["dirty_ingest"] < 1:
            raise AssertionError(f"kube: refresh counters {stats}")
        t0 = time.perf_counter()
        _, names, keys, values, _ = client.node_annotation_columns()
        metric_set = set(metrics)
        bodies = list_bodies(client, "/api/v1/nodes", 0)
        native = {
            "host_library": host_library_line(), "bootstrap_pages_by_backend": boot_backends,
            "node_pages": decode_three_ways(bodies, 0, kube_node_t),
            "reuse": reuse_check(bodies), "rv_reuse_size": client.rv_reuse_size(),
            "watch": watch_twin_check(captured),
            "codec": codec_twin_check([v for k, v in zip(keys, values) if k in metric_set]),
            "bulk_flushes": check_bulk_routes(client, "1% patch"),
        }
        if native["codec"]["strings"] != N_NODES * len(metrics):
            raise AssertionError(f"native: codec over {native['codec']['strings']} strings")
        native["seconds"] = time.perf_counter() - t0
        line = {
            "nodes": N_NODES, "metrics": len(metrics), "page_limit": KUBE_PAGE,
            "stub_seed_s": seed_s, "bootstrap_ms": bootstrap_ms, "node_pages": pages,
            "node_decode_ms": decode_s * 1e3, "mirror_equals_stub": True,
            "columnar_refresh_ms": columnar_ms, "sweep_refresh_ms": sweep_ms,
            "relist_ms": relist_ms, "refresh_after_relist_ms": relist_refresh_ms,
            "storm_events": KUBE_STORM, "storm_applied": applied, "storm_s": storm_s,
            "storm_wait_s": storm_wait_s,
            "storm_events_per_s": KUBE_STORM / storm_s,
            "storm_transactions": client.watch_batches - batches0,
            "storm_coalesced": client.watch_coalesced - coalesced0,
            "relist_after_storm_ms": storm_relist_ms, "patch_nodes": n_patched,
            "patch_ms": patch_ms, "patch_echo_s": echo_s, "dirty_refresh_ms": dirty_ms,
            "columnar_ingest": stats["columnar_ingest"], "dirty_ingest": stats["dirty_ingest"],
            "relists": client.relists, "watch_errors": client.watch_errors, "native": native,
        }
        return line, server, client, batch, policy
    except BaseException:
        if client is not None:
            client.stop()
        server.stop()
        raise


def kube_burst_leg(server, client, batch, policy, tel) -> tuple:
    """Two float32 bursts of 10,000 pods over the wire (creation POSTs, K1
    and K2, binding POSTs) against a CPU twin over an in-memory cluster
    with the mirror's nodes, the same `now` and pod names."""
    now = kube_now()
    twin_cluster = ClusterState()
    for node in client.list_nodes():
        twin_cluster.add_node(node)
    twin = BatchScheduler(twin_cluster, policy, dtype=torch.float32, clock=lambda: now,
                          device="cpu")
    tel.lifecycle.batch_sample = KUBE_BURST_PODS  # track every pod to its watch_confirm
    confirmed0 = tel.lifecycle.confirmed_total
    e2e0 = hist_count_sum(tel, "crane_placement_e2e_seconds")[0]
    posts0 = server.stats()["requests"].get("POST", 0)
    reset_launches()
    burst_ms, stage_ms, settle_s, placed, card = [], [], [], 0, []
    for k in range(KUBE_BURSTS):
        names = [f"kb{k}-{i:05d}" for i in range(KUBE_BURST_PODS)]
        batch.burst_stage_ms = dict.fromkeys(BURST_STAGES, 0.0)
        t0 = time.perf_counter()
        result = batch.schedule_pod_burst("kube", names)
        burst_ms.append((time.perf_counter() - t0) * 1e3)
        stage_ms.append(dict(batch.burst_stage_ms))
        settle_s.append(settle(client, server, {"pods": 1, "events": 0}, f"burst {k}"))
        idx = np.asarray(result.node_idx)
        placed += int((idx >= 0).sum())
        card.append([result.node_table[j] if j >= 0 else None for j in idx.tolist()])
    launched = read_launches("kube burst")
    if launched != {"score": KUBE_BURSTS, "gang": KUBE_BURSTS, "drip": 0}:
        raise AssertionError(f"kube burst: launches {launched}, want K1 and K2 once per burst")
    for k in range(KUBE_BURSTS):
        result = twin.schedule_pod_burst("kube", [f"kb{k}-{i:05d}" for i in range(KUBE_BURST_PODS)])
        want = [result.node_table[j] if j >= 0 else None
                for j in np.asarray(result.node_idx).tolist()]
        if card[k] != want:
            raise AssertionError(f"kube burst {k}: wire placements != the in-memory CPU twin's")
    stats = server.stats()
    confirmed = tel.lifecycle.confirmed_total - confirmed0
    e2e = hist_count_sum(tel, "crane_placement_e2e_seconds")[0] - e2e0
    if stats["duplicate_binds"] != 0 or stats["bind_posts"] != placed:
        raise AssertionError(f"kube burst: bind_posts {stats['bind_posts']}, duplicates "
                             f"{stats['duplicate_binds']}, placed {placed}")
    if confirmed != placed or e2e != placed:
        raise AssertionError(f"kube burst: watch_confirm {confirmed}, e2e observations {e2e}, "
                             f"placed {placed}")
    if sum(client.count_pods_all().values()) != placed:
        raise AssertionError("kube burst: the mirror's bound counts != the pods placed")
    posts = stats["requests"].get("POST", 0) - posts0
    t0 = time.perf_counter()
    native = {"bulk_flushes": check_bulk_routes(client, "burst"),
              "pod_pages": decode_three_ways(list_bodies(client, "/api/v1/pods", 1), 1,
                                             kube_pod_t)}
    if native["pod_pages"]["items"] != KUBE_BURSTS * KUBE_BURST_PODS:
        raise AssertionError(f"native: {native['pod_pages']['items']} pods listed")
    native["seconds"] = time.perf_counter() - t0
    line = {
        "bursts": KUBE_BURSTS, "pods_per_burst": KUBE_BURST_PODS, "placed": placed,
        "equal_to_cpu_twin": True, "ms_per_burst": burst_ms, "stage_ms_per_burst": stage_ms,
        "settle_s_per_burst": settle_s, "posts": posts,
        "posts_per_s": posts / (sum(burst_ms) / 1e3), "bind_posts": stats["bind_posts"],
        "duplicate_binds": stats["duplicate_binds"], "watch_confirm": confirmed,
        "placement_e2e_observations": e2e,
        "placement_e2e_mean_ms": 1e3 * (lambda c, s: s / c if c else 0.0)(
            *hist_count_sum(tel, "crane_placement_e2e_seconds")),
        "refresh_stats": dict(batch.refresh_stats), "launches": launched, "native": native,
    }
    return line, launched


def kube_drip_scheduler(cluster, dev) -> Scheduler:
    clock = kube_now
    sched = Scheduler(cluster, clock=clock, columnar=True, device=dev)
    sched.register(ResourceFitPlugin(FitTracker(cluster)), weight=1)
    sched.register(DynamicPlugin(DEFAULT_POLICY, clock=clock), weight=3)
    return sched


def kube_drip_pods(prefix: str, count: int, cpu: str = "100m") -> list:
    return [Pod(name=f"{prefix}-{i:05d}", containers=(Container("c", ResourceRequirements(
        requests={"cpu": cpu, "memory": "128Mi"})),)) for i in range(count)]


def kube_drip_leg(kube_stub, dev) -> tuple:
    """Config 15's drip storm over the wire at 50,000 nodes: 4,096 pods
    created with ``add_pod``, ``schedule_queue(window=128)`` on
    ``Scheduler(client, columnar=True)`` (ResourceFit x1, Dynamic x3),
    against the same queue on an in-memory cluster with the same nodes,
    on the card."""
    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient

    metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
    server = kube_stub.KubeStubSubprocess()
    client = None
    try:
        server.seed(N_NODES, "node-", metrics=metrics, allocatable=DRIP_ALLOCATABLE)
        client = KubeClusterClient(server.url, list_page_limit=KUBE_PAGE)
        t0 = time.perf_counter()
        client.start()
        bootstrap_ms = (time.perf_counter() - t0) * 1e3
        twin = ClusterState()
        for node in client.list_nodes():
            twin.add_node(node)
        sched = kube_drip_scheduler(client, dev)
        warm = kube_drip_pods("kwarm", DRIP_WINDOW, cpu="100000")
        pods = kube_drip_pods("kdrip", KUBE_DRIP_PODS)
        t0 = time.perf_counter()
        for pod in warm + pods:
            client.add_pod(pod)
        create_s = time.perf_counter() - t0
        settle(client, server, {"pods": 0}, "drip creations")
        if any(r.node for r in sched.schedule_queue(warm, window=DRIP_WINDOW)):
            raise AssertionError("kube drip: a warm-up pod was placed")
        pre = sched.drip_stats()
        reset_launches()
        t0 = time.perf_counter()
        results = sched.schedule_queue(pods, window=DRIP_WINDOW)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launched = read_launches("kube drip", need=("drip",))
        if launched["score"] or launched["gang"]:
            raise AssertionError(f"kube drip: launches {launched}")
        drip = sched.drip_stats()
        all_kernel_windows(drip, pre, "kube drip")
        stats = server.stats()
        binds = sum(r.node is not None for r in results)
        if (binds != KUBE_DRIP_PODS or stats["bind_posts"] != KUBE_DRIP_PODS
                or stats["duplicate_binds"] != 0 or drip["fallbacks"]
                or drip["folds"] - pre["folds"] != KUBE_DRIP_PODS):
            raise AssertionError(f"kube drip: {binds} binds, bind_posts {stats['bind_posts']}, "
                                 f"duplicates {stats['duplicate_binds']}, drip {drip}")
        twin_sched = kube_drip_scheduler(twin, dev)
        twin.add_pods(warm + pods)
        twin_sched.schedule_queue(warm, window=DRIP_WINDOW)
        t0 = time.perf_counter()
        want = twin_sched.schedule_queue(pods, window=DRIP_WINDOW)
        twin_ms = (time.perf_counter() - t0) * 1e3
        if placements(results) != placements(want):
            raise AssertionError("kube drip: wire placements != the in-memory queue's")
        windows = drip["batch"]["dispatches"] - pre["batch"]["dispatches"]
        line = {
            "nodes": N_NODES, "pods": KUBE_DRIP_PODS, "window": DRIP_WINDOW,
            "bootstrap_ms": bootstrap_ms, "add_pod_s": create_s,
            "ms_per_pod": wall_ms / KUBE_DRIP_PODS, "wall_ms": wall_ms,
            "binds_per_s": binds / (wall_ms / 1e3), "windows": windows,
            "in_memory_ms_per_pod": twin_ms / KUBE_DRIP_PODS, "equal_to_in_memory": True,
            "bind_posts": stats["bind_posts"], "duplicate_binds": stats["duplicate_binds"],
            "folds": drip["folds"] - pre["folds"], "launches": launched,
        }
        return line, launched
    finally:
        if client is not None:
            client.stop()
        server.stop()


def kube_gang_leg(kube_stub, dev) -> tuple:
    """Config 22's gangs over the wire: 24 gangs (224 pods) through
    ``schedule_gang_queue(window=8)`` on a 5,000-node stub, against the
    same queue on an in-memory cluster with the mirror's nodes."""
    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient

    metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
    now = kube_now()
    server = kube_stub.KubeStubSubprocess()
    client = None
    total = sum(c for _, c in GANG_SHAPES)
    kw = dict(window=GANG_WINDOW, dynamic_weight=GANG_DYN_W, topology_weight=GANG_TOPO_W)
    try:
        server.seed(KUBE_GANG_NODES, "node-", metrics=metrics, allocatable=DRIP_ALLOCATABLE)
        client = KubeClusterClient(server.url, list_page_limit=KUBE_PAGE)
        client.start()
        twin = ClusterState()
        for node in client.list_nodes():
            twin.add_node(node)
        wire = BatchScheduler(client, DEFAULT_POLICY, dtype=torch.float32, clock=lambda: now,
                              device=dev)
        reset_launches()
        t0 = time.perf_counter()
        out = wire.schedule_gang_queue(gang_requests("w"), **kw)
        wire_ms = (time.perf_counter() - t0) * 1e3
        launched = read_launches("kube gang", need=("gang",))
        if launched["gang"] != len(GANG_SHAPES):
            raise AssertionError(f"kube gang: launches {launched} for {len(GANG_SHAPES)} gangs")
        stats = server.stats()
        placed = sum(len(o.assignments) for o in out)
        if (placed != total or stats["bind_posts"] != placed or stats["duplicate_binds"] != 0
                or wire.gang_stats()["fallbacks"]):
            raise AssertionError(f"kube gang: {placed}/{total} placed, bind_posts "
                                 f"{stats['bind_posts']}, duplicates {stats['duplicate_binds']}")
        mem = BatchScheduler(twin, DEFAULT_POLICY, dtype=torch.float32, clock=lambda: now,
                             device=dev)
        t0 = time.perf_counter()
        want = mem.schedule_gang_queue(gang_requests("w"), **kw)
        mem_ms = (time.perf_counter() - t0) * 1e3
        if [dict(o.assignments) for o in out] != [dict(o.assignments) for o in want]:
            raise AssertionError("kube gang: wire placements != the in-memory queue's")
        line = {
            "nodes": KUBE_GANG_NODES, "gangs": len(GANG_SHAPES), "pods": placed,
            "ms_per_gang": wire_ms / len(GANG_SHAPES),
            "in_memory_ms_per_gang": mem_ms / len(GANG_SHAPES), "equal_to_in_memory": True,
            "bind_posts": stats["bind_posts"], "duplicate_binds": stats["duplicate_binds"],
            "launches": launched,
        }
        return line, launched
    finally:
        if client is not None:
            client.stop()
        server.stop()


def kube_cli_stub(kube_stub, stamp_epoch: float):
    """A 5,000-node stub with fresh seeded annotations stamped at
    ``stamp_epoch`` and 1,024 pending pods (500m cpu, 128Mi)."""
    return fresh_stub(kube_stub, KUBE_CLI_NODES, stamp_epoch,
                      kube_drip_pods("fd", KUBE_CLI_PODS, cpu="500m"), seed=SEED + 23)


def stub_bindings(url: str) -> dict:
    """The sorted (pod, node) bindings the stub holds: count and sha256."""
    import hashlib
    import urllib.request

    with urllib.request.urlopen(url + "/api/v1/pods", timeout=120) as resp:  # noqa: S310
        items = json.loads(resp.read())["items"]
    pairs = sorted((f"{o['metadata']['namespace']}/{o['metadata']['name']}",
                    (o.get("spec") or {}).get("nodeName") or "") for o in items)
    bound = [p for p in pairs if p[1]]
    return {"pods": len(pairs), "bound": len(bound),
            "sha256": hashlib.sha256(json.dumps(pairs).encode()).hexdigest()}


def kube_scheduler_cli(url: str, device: str, extra=()) -> dict:
    """crane-scheduler ``--master`` in this process: its result line (no
    ``wall_seconds``, ``master`` or reconcile time), its wall seconds and
    the stub's bindings after it."""
    import contextlib
    import io

    from crane_scheduler_tpu_torch.cli import scheduler_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = scheduler_main.main(["--master", url, "--batch-size", str(KUBE_CLI_BATCH),
                                  "--device", device, *extra])
    if rc != 0:
        raise AssertionError(f"crane-scheduler --master exited {rc}")
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    wall = line.pop("wall_seconds")
    line.pop("master")
    if "recovery" in line:
        line["recovery"].pop("elapsed_s")
    return {"line": line, "wall_seconds": wall, "bindings": stub_bindings(url)}


def kube_scheduler_twin_child(stamp_epoch: float, extra) -> int:
    """The child mode ``KUBE_TWIN_ARG``: crane-scheduler ``--master --device
    cpu`` and the flags ``extra`` on its own identically seeded stub, as
    one JSON line."""
    server = kube_cli_stub(load_kube_stub(), stamp_epoch)
    try:
        out = kube_scheduler_cli(server.url, "cpu", extra)
    finally:
        server.stop()
    print(json.dumps(out), flush=True)
    return 0


def kube_scorer_cli(url: str, now: float) -> dict:
    """crane-scorer ``--master --f32`` on the card and ``--device cpu`` as
    subprocesses over one stub: one ``POST /v1/score`` each at ``now``;
    the bodies, their exit lines and launches."""
    import re
    import signal
    import socket

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    runs = {}
    for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        port = free_port()
        runs[name] = (port, start_cli(
            ["crane_scheduler_tpu_torch.cli.service_main", "--master", url, "--f32",
             "--port", str(port), "--now-bucket", "0", "--run-seconds", "300", *extra]))
    bodies, exits = {}, {}
    try:
        for name, (port, (proc, t0)) in runs.items():
            while True:
                try:
                    status, _ = http_json(port, "GET", "/healthz", timeout=10)
                    if status == 200:
                        break
                except OSError:
                    pass
                if proc.poll() is not None or time.perf_counter() - t0 > 180:
                    raise AssertionError(f"kube cli: crane-scorer ({name}) did not come up")
                time.sleep(0.1)
            status, body = http_json(port, "POST", "/v1/score", {"now": now})
            if status != 200:
                raise AssertionError(f"kube cli: crane-scorer ({name}) answered {status}")
            bodies[name] = body
    finally:
        for name, (port, (proc, t0)) in runs.items():
            proc.send_signal(signal.SIGTERM)
            try:
                stdout, err = proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, err = proc.communicate()
            exits[name] = (proc.returncode, stdout, err)
    for name, (rc, stdout, err) in exits.items():
        if rc != 0:
            raise AssertionError(f"kube cli: crane-scorer ({name}) exited {rc}: {err[-400:]!r}")
    drop = lambda b: re.sub(rb'"stalenessSeconds": [0-9.e-]+, ', b"", b)  # noqa: E731
    card = drop(bodies["card"])
    if not card.startswith(CARD_BODY) or \
            card.replace(CARD_BODY, b'{"backend": "cpu"', 1) != drop(bodies["cpu"]):
        raise AssertionError("kube cli: crane-scorer card body != the CPU twin's")
    launches = {name: json.loads(stdout.strip().splitlines()[-1])["kernel_launches"]
                for name, (_, stdout, _) in exits.items()}
    if launches != {"card": {"score": 1, "gang": 0}, "cpu": {"score": 0, "gang": 0}}:
        raise AssertionError(f"kube cli: crane-scorer launches {launches}")
    nodes = len(json.loads(bodies["card"])["scores"])
    if nodes != KUBE_CLI_NODES:
        raise AssertionError(f"kube cli: crane-scorer scored {nodes} nodes")
    return {"bytes": len(bodies["card"]), "nodes": nodes, "card_equals_cpu": True,
            "launches": launches["card"]}


def kube_cli_leg(kube_stub, dev) -> tuple:
    """crane-scorer and crane-scheduler with ``--master`` on a 5,000-node
    stub with 1,024 pending pods, each against a CPU twin: the scorer's
    body bytes, the scheduler's result line and the stub's bindings (the
    scheduler's twin, on its own identically seeded stub, in this
    script's child mode)."""
    stamp_epoch = time.time()
    twin_run = start_cli([KUBE_TWIN_ARG, repr(stamp_epoch)], script=True)
    by_path = {}
    try:
        server = kube_cli_stub(kube_stub, stamp_epoch)
        try:
            scorer = kube_scorer_cli(server.url, stamp_epoch + 5.0)
            by_path["kube_cli_scorer"] = scorer["launches"]
            reset_launches()
            t0 = time.perf_counter()
            card = kube_scheduler_cli(server.url, dev.type)
            card["in_process_seconds"] = time.perf_counter() - t0
            launched = read_launches("kube cli scheduler", need=("gang",))
        finally:
            server.stop()
        batches = -(-KUBE_CLI_PODS // KUBE_CLI_BATCH)
        if launched != {"score": 0, "gang": batches, "drip": 0}:
            raise AssertionError(f"kube cli: crane-scheduler launches {launched}, "
                                 f"want K1 0, K2 {batches}")
        by_path["kube_cli_scheduler"] = launched
        twin, twin_s = finish_cli(twin_run, timeout=600)
        twin_run = None
        if card["line"] != twin["line"] or card["bindings"] != twin["bindings"]:
            raise AssertionError(f"kube cli: crane-scheduler card {card['line']} "
                                 f"{card['bindings']} != cpu {twin['line']} {twin['bindings']}")
        if card["bindings"]["bound"] != card["line"]["scheduled"] or \
                card["line"]["nodes"] != KUBE_CLI_NODES:
            raise AssertionError(f"kube cli: crane-scheduler {card}")
    finally:
        if twin_run is not None and twin_run[0].poll() is None:
            twin_run[0].kill()
            twin_run[0].communicate()
    line = {"nodes": KUBE_CLI_NODES, "pods": KUBE_CLI_PODS, "batch_size": KUBE_CLI_BATCH,
            "scheduler": {**card, "cpu_wall_seconds": twin["wall_seconds"],
                          "cpu_process_seconds": twin_s, "launches": launched,
                          "equal_to_cpu": True},
            "scorer": scorer}
    return line, by_path


def phase_kube(dev) -> tuple:
    """The kube mirror over the wire stub (each stub in its own process):
    the read path, two bursts, the drip storm, config 22's gangs and the
    ``--master`` front doors."""
    t_phase = time.perf_counter()
    kube_stub = load_kube_stub()
    tel = Telemetry(lifecycle_capacity=4 * KUBE_BURST_PODS)
    by_path = {}
    t0 = time.perf_counter()
    read, server, client, batch, policy = kube_read_leg(kube_stub, dev, tel)
    read["seconds"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        burst, by_path["kube_burst"] = kube_burst_leg(server, client, batch, policy, tel)
        burst["seconds"] = time.perf_counter() - t0
    finally:
        client.stop()
        server.stop()
    t0 = time.perf_counter()
    drip, by_path["kube_drip"] = kube_drip_leg(kube_stub, dev)
    drip["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gang, by_path["kube_gang"] = kube_gang_leg(kube_stub, dev)
    gang["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli, cli_paths = kube_cli_leg(kube_stub, dev)
    cli["seconds"] = time.perf_counter() - t0
    by_path.update(cli_paths)
    out = {"read": read, "burst": burst, "drip": drip, "gang": gang, "cli": cli,
           "seconds": time.perf_counter() - t_phase}
    log("kube", **out)
    return out, by_path



# -- control: the control plane on the kube mirror -------------------------------------

CONTROL_NODES = N_NODES  # the serve, SIGTERM and standby legs' stub
CONTROL_PODS = 2_048  # pods per serve leg (config 15's storm, 4,096, cut for wall time)
CONTROL_WINDOW = 32  # crane-scheduler --serve --window
CONTROL_SIGTERM_AT = 512  # binds before the SIGTERM leg's signal
CONTROL_KILL_BATCH = 8  # pods per mid-pipeline-fill life (config 16)
CONTROL_KILLS = 8  # config 16's seeded kill_process events
CONTROL_KILL_SEED = 16
CONTROL_FAILOVER_GATE_S = 5.0  # config 16's failover gate (report only)
CONTROL_DESCHED_SECONDS = 6.0
CONTROL_CHAOS_STEPS, CONTROL_CHAOS_OUTAGE, CONTROL_CHAOS_HEAL = 24, 4, 16  # config 12
CONTROL_CHAOS_NODES = 6  # config 12's own nodes: 1 hot, 5 cool
CONTROL_CHAOS_SEED = 12
SERVE_TWIN_ARG = "--serve-twin"  # the child mode of the serve leg's CPU twin
CLI_CHILD_ARG = "--cli-child"  # a port CLI's main() in a child process of this script
CONTROL_ORPHAN = ("default/fd-00000", "node-00001")  # the one-shot leg's orphan intent


def fresh_stub(kube_stub, n: int, stamp_epoch: float, pods=(), seed: int = SEED + 29):
    """A stub in its own process: ``n`` seeded nodes with config 15's
    allocatable, annotations from ``seed`` stamped at ``stamp_epoch``
    (fresh for a CLI on the wall clock), and ``pods`` created pending."""
    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient

    metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
    server = kube_stub.KubeStubSubprocess()
    try:
        server.seed(n, "node-", allocatable=DRIP_ALLOCATABLE)
        writer = KubeClusterClient(server.url)  # writes only: never started
        values = np.random.default_rng(seed).uniform(0.0, 1.0, (n, len(metrics)))
        stamp = format_local_time(stamp_epoch)
        patched = writer.patch_node_annotations_bulk({
            f"node-{i:05d}": {m: f"{values[i, k]:.5f},{stamp}" for k, m in enumerate(metrics)}
            for i in range(n)})
        pods = list(pods)
        writer.add_pods(pods)
        writer.stop()
        if patched != n or server.stats()["requests"].get("POST", 0) < len(pods):
            raise AssertionError(f"stub: {patched} of {n} nodes annotated")
        return server
    except BaseException:
        server.stop()
        raise


def journal_lines(jdir: str) -> list:
    from crane_scheduler_tpu_torch.resilience.recovery import IntentJournal

    return list(IntentJournal.read(jdir))


def check_journal_closed(jdir: str, what: str) -> dict:
    """Every intent in ``jdir`` acked, tombstoned or resolved."""
    recs = journal_lines(jdir)
    intents = {r["id"] for r in recs if r["t"] == "intent"}
    closed = {r["id"] for r in recs if r["t"] in ("ack", "tombstone", "resolved")}
    if not intents or intents - closed:
        raise AssertionError(f"{what}: intents {len(intents)}, open {sorted(intents - closed)[:5]}")
    kinds = {}
    for r in recs:
        kinds[r["t"]] = kinds.get(r["t"], 0) + 1
    return kinds


def cli_child(module: str, argv) -> int:
    """The child mode ``CLI_CHILD_ARG``: ``module``'s ``main(argv)`` in this
    process, a process of its own, so the CLI's signal handlers and Lease
    elector stay in it. At exit one more line, ``{"child": ...}``: the
    kernels' launches over the call and the drip windows that the
    schedulers it built dispatched, by device (``build_scheduler_from_config``
    is wrapped for the call to keep them)."""
    import importlib

    from crane_scheduler_tpu_torch import config as config_module

    built, base = [], config_module.build_scheduler_from_config

    def recorded(*args, **kwargs):
        sched = base(*args, **kwargs)
        built.append(sched)
        return sched

    config_module.build_scheduler_from_config = recorded
    reset_launches()
    rc = importlib.import_module(module).main(argv)
    windows = {}
    for sched in built:
        dev = torch.device(sched.device).type
        windows[dev] = windows.get(dev, 0) + sched.drip_stats()["batch"]["dispatches"]
    print(json.dumps({"child": {"rc": rc, "drip_windows": windows, "launches": {
        name: kernel.launches for name, kernel in KERNELS.items()}}}), flush=True)
    return rc


def child_output(stdout: str, what: str) -> tuple:
    """A ``CLI_CHILD_ARG`` process's stdout: (the CLI's last JSON line, the
    child's own line)."""
    lines = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    if len(lines) < 2 or "child" not in lines[-1]:
        raise AssertionError(f"{what}: no exit line from the child: {stdout[-400:]!r}")
    return lines[-2], lines[-1]["child"]


def finish_child(started, timeout: float, what: str) -> tuple:
    """Wait for a ``CLI_CHILD_ARG`` process started by ``start_cli``: (the
    CLI's line, the child's line, s)."""
    proc, t0 = started
    try:
        stdout, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}: {err[-600:]!r}")
    return (*child_output(stdout, what), time.perf_counter() - t0)


def card_windows(child: dict, dev, what: str) -> int:
    """The drip windows a child dispatched, all of them on ``dev``."""
    windows = child["drip_windows"]
    if set(windows) != {dev.type} or windows[dev.type] < 1:
        raise AssertionError(f"{what}: drip windows {windows}, want them on {dev.type}")
    return windows[dev.type]


def add_launches(*children) -> dict:
    return {name: sum(c["launches"][name] for c in children) for name in KERNELS}


def serve_cli(url: str, jdir: str, device: str, extra=(), log_path: str | None = None):
    """crane-scheduler ``--master --serve`` as a subprocess, in this
    script's ``CLI_CHILD_ARG`` mode; with ``log_path`` its stdout goes to
    that file."""
    root, env = cli_env()
    args = [sys.executable, __file__, CLI_CHILD_ARG, "crane_scheduler_tpu_torch.cli.scheduler_main",
            "--master", url, "--serve", "--window", str(CONTROL_WINDOW), "--journal-dir", jdir,
            "--device", device, *extra]
    out = open(log_path, "w") if log_path else subprocess.PIPE
    proc = subprocess.Popen(args, cwd=root, env=env, stdout=out, stderr=subprocess.PIPE,
                            text=True)
    if log_path:
        out.close()
    return proc


def serve_line(proc, log_path: str | None = None, sig=None, timeout: float = 180.0) -> tuple:
    """Signal a serve process (SIGTERM by default), wait: (its result line,
    its child line)."""
    import signal

    proc.send_signal(sig or signal.SIGTERM)
    try:
        stdout, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"serve exited {proc.returncode}: {err[-800:]!r}")
    if log_path:
        with open(log_path) as f:
            stdout = f.read()
    return child_output(stdout, "serve")


def wait_binds(server, target: int, procs, what: str, timeout: float = 300.0) -> tuple:
    """Poll the stub until ``target`` binding POSTs: (seconds to the first
    bind above the starting count, seconds to the target)."""
    t0 = time.perf_counter()
    base = server.stats()["bind_posts"]
    first = None
    while True:
        posts = server.stats()["bind_posts"]
        now = time.perf_counter() - t0
        if first is None and posts > base:
            first = now
        if posts >= target:
            return first if first is not None else now, now
        for proc in procs:
            if proc.poll() is not None:
                raise AssertionError(f"{what}: a scheduler exited {proc.returncode} at "
                                     f"{posts} binds: {proc.communicate()[1][-800:]!r}")
        if now > timeout:
            raise AssertionError(f"{what}: {posts} of {target} binds after {timeout} s")
        time.sleep(0.01)


def orphan_intent(jdir: str, pod: str, node: str) -> None:
    """The journal a crashed scheduler leaves: one bind intent, no outcome."""
    import os

    os.makedirs(jdir, exist_ok=True)
    with open(os.path.join(jdir, "intent-000001.jsonl"), "w") as f:
        f.write(json.dumps({"v": 1, "t": "intent", "id": 1, "op": "bind", "pod": pod,
                            "node": node, "window": 0, "trace": None, "ts": 1.0},
                           separators=(",", ":")) + "\n")


def scratch_dir_path(name: str) -> str:
    import os

    root, _ = cli_env()
    return os.path.join(root, BUILD_DIR, "control", name)


def scratch_dir(name: str) -> str:
    """An empty scratch directory under ``_build/control`` (gitignored)."""
    import os
    import shutil

    path = scratch_dir_path(name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def serve_twin_run(server, device: str, jdir: str) -> dict:
    """The serve leg: 2,048 pods seeded before the process starts, bound by
    ``--serve``, then SIGTERM. Result line, child line, bindings and
    timings."""
    proc = serve_cli(server.url, jdir, device)
    t0 = time.perf_counter()
    try:
        first, done = wait_binds(server, CONTROL_PODS, [proc], f"serve ({device})")
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    line, child = serve_line(proc)
    wall = line.pop("wall_seconds")
    line.pop("master")
    line["recovery"].pop("elapsed_s")
    stats = server.stats()
    return {"line": line, "child": child, "wall_seconds": wall, "start_to_first_bind_s": first,
            "first_to_last_bind_s": done - first, "process_seconds": time.perf_counter() - t0,
            "bindings": stub_bindings(server.url), "bind_posts": stats["bind_posts"],
            "duplicate_binds": stats["duplicate_binds"]}


def serve_twin_child(stamp_epoch: float) -> int:
    """The child mode ``SERVE_TWIN_ARG``: the serve leg with ``--device
    cpu`` on its own identically seeded stub, one JSON line."""
    server = fresh_stub(load_kube_stub(), CONTROL_NODES, stamp_epoch,
                        kube_drip_pods("sv", CONTROL_PODS))
    try:
        out = serve_twin_run(server, "cpu", scratch_dir("twin-serve"))
    finally:
        server.stop()
    print(json.dumps(out), flush=True)
    return 0


def control_oneshot_leg(kube_stub, dev) -> tuple:
    """One-shot ``--master --journal-dir --batch-size 256`` on PR 11's
    ``kube.cli`` stub (5,000 nodes, 1,024 pending pods) after an orphan
    bind intent: the reconciler finds the pod unbound, every pod binds
    once, K2 once per batch, equal to the CPU twin (``KUBE_TWIN_ARG``
    with the same flags and its own orphan)."""
    stamp_epoch = time.time()
    twin_dir = scratch_dir("twin-oneshot")
    orphan_intent(twin_dir, *CONTROL_ORPHAN)
    twin_run = start_cli([KUBE_TWIN_ARG, repr(stamp_epoch), "--journal-dir", twin_dir],
                         script=True)
    try:
        server = kube_cli_stub(kube_stub, stamp_epoch)
        try:
            jdir = scratch_dir("oneshot")
            orphan_intent(jdir, *CONTROL_ORPHAN)
            reset_launches()
            card = kube_scheduler_cli(server.url, dev.type, ("--journal-dir", jdir))
            launched = read_launches("control one-shot", need=("gang",))
            stats = server.stats()
        finally:
            server.stop()
        twin, twin_s = finish_cli(twin_run, timeout=600)
        twin_run = None
    finally:
        if twin_run is not None and twin_run[0].poll() is None:
            twin_run[0].kill()
            twin_run[0].communicate()
    batches = -(-KUBE_CLI_PODS // KUBE_CLI_BATCH)
    if launched != {"score": 0, "gang": batches, "drip": 0}:
        raise AssertionError(f"control one-shot: launches {launched}, want K1 0, K2 {batches}")
    rec = card["line"]["recovery"]
    if rec["outcomes"] != {"unbound_reschedulable": 1} or \
            card["line"]["scheduled"] != KUBE_CLI_PODS or \
            card["bindings"]["bound"] != KUBE_CLI_PODS or stats["duplicate_binds"] != 0 or \
            stats["bind_posts"] != KUBE_CLI_PODS:
        raise AssertionError(f"control one-shot: {card['line']} {card['bindings']} {stats}")
    if card["line"] != twin["line"] or card["bindings"] != twin["bindings"]:
        raise AssertionError(f"control one-shot: card {card['line']} {card['bindings']} != "
                             f"cpu {twin['line']} {twin['bindings']}")
    return {"nodes": KUBE_CLI_NODES, "pods": KUBE_CLI_PODS, **card, "launches": launched,
            "cpu_wall_seconds": twin["wall_seconds"], "cpu_process_seconds": twin_s,
            "equal_to_cpu": True}, launched


def control_serve_legs(kube_stub, dev, stamp_epoch: float, twin_run) -> tuple:
    """serve, sigterm and standby on one 50,000-node stub (annotations
    stamped ``stamp_epoch``; each leg adds its own 2,048 pods): the serve
    leg equals its CPU twin's bindings (``twin_run``, started with the
    phase); SIGTERM mid-storm drains, the restart reconciles; the standby
    takes over a SIGKILLed leader. Each process's launches and drip
    windows come from its exit line. Returns the lines, the paths' launch
    counts and the stub (kept for the shard phase's wire leg)."""
    import os
    import signal
    import threading

    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient

    server = None
    live = []  # serve processes, killed if a leg fails
    by_path = {}
    try:
        t0 = time.perf_counter()
        server = fresh_stub(kube_stub, CONTROL_NODES, stamp_epoch,
                            kube_drip_pods("sv", CONTROL_PODS))
        seed_s = time.perf_counter() - t0
        jdir = scratch_dir("serve")
        serve = serve_twin_run(server, dev.type, jdir)
        child = serve.pop("child")
        serve["drip_windows"] = card_windows(child, dev, "control serve")
        by_path["control_serve"] = child["launches"]
        serve["journal"] = check_journal_closed(jdir, "control serve")
        serve["ms_per_pod"] = serve["first_to_last_bind_s"] * 1e3 / CONTROL_PODS
        serve["pods_per_s"] = CONTROL_PODS / serve["first_to_last_bind_s"]
        serve["stub_seed_s"] = seed_s
        if serve["line"]["scheduled"] != CONTROL_PODS or serve["duplicate_binds"] or \
                serve["bind_posts"] != CONTROL_PODS or serve["bindings"]["bound"] != CONTROL_PODS:
            raise AssertionError(f"control serve: {serve}")
        # the CPU twin ran on its own stub meanwhile; joined before the next
        # legs, whose processes would slow it down
        twin, twin_s = finish_cli(twin_run, timeout=900)
        card_windows(twin.pop("child"), torch.device("cpu"), "control serve twin")
        if serve["line"] != twin["line"] or serve["bindings"] != twin["bindings"]:
            raise AssertionError(f"control serve: card {serve['line']} {serve['bindings']} != "
                                 f"cpu {twin['line']} {twin['bindings']}")
        serve.update(cpu_ms_per_pod=twin["first_to_last_bind_s"] * 1e3 / CONTROL_PODS,
                     cpu_process_seconds=twin_s, equal_to_cpu=True)

        def feed(prefix, start, count):
            """Create pending pods ``start .. start + count`` from a thread
            (sequential POSTs)."""
            writer = KubeClusterClient(server.url)
            pods = kube_drip_pods(prefix, CONTROL_PODS)[start:start + count]
            thread = threading.Thread(target=lambda: (writer.add_pods(pods), writer.stop()),
                                      daemon=True)
            thread.start()
            return thread

        # -- sigterm: the signal lands mid-storm; the restart binds the rest
        # (at least the second part, created after the first life exited,
        # so it is up, handlers installed, before its own signal). The
        # first part is no multiple of the window, so a window can be
        # open when the first life reads the signal.
        base = server.stats()["bind_posts"]
        jdir = scratch_dir("sigterm")
        half = CONTROL_PODS // 2 + CONTROL_WINDOW // 2 + 1
        proc = serve_cli(server.url, jdir, dev.type)
        live.append(proc)
        feeder = feed("st", 0, half)
        wait_binds(server, base + CONTROL_SIGTERM_AT, [proc], "control sigterm")
        first, first_child = serve_line(proc)
        feeder.join()
        mid = server.stats()["bind_posts"] - base
        proc = serve_cli(server.url, jdir, dev.type)
        live.append(proc)
        feed("st", half, CONTROL_PODS - half).join()
        wait_binds(server, base + CONTROL_PODS, [proc], "control sigterm restart")
        second, second_child = serve_line(proc)
        stats = server.stats()
        if "drained_at_exit" not in first or "recovery" not in second or \
                stats["duplicate_binds"] or stats["bind_posts"] != base + CONTROL_PODS or \
                first["scheduled"] + second["scheduled"] != CONTROL_PODS:
            raise AssertionError(f"control sigterm: {first} {second} {stats}")
        by_path["control_sigterm"] = add_launches(first_child, second_child)
        sigterm = {"binds_at_signal": mid, "drained_at_exit": first["drained_at_exit"],
                   "first_life_scheduled": first["scheduled"],
                   "restart_scheduled": second["scheduled"], "restart_recovery": second["recovery"],
                   "duplicate_binds": 0, "lost_binds": 0,
                   "drip_windows": [card_windows(c, dev, "control sigterm")
                                    for c in (first_child, second_child)],
                   "launches": by_path["control_sigterm"]}

        # -- standby: two processes on one lock; the leader dies mid-storm
        base = server.stats()["bind_posts"]
        jdir = scratch_dir("standby")
        lock = os.path.join(jdir, "leader.lock")
        procs = [serve_cli(server.url, jdir, dev.type, ("--lock-file", lock)) for _ in range(2)]
        live.extend(procs)
        t_lock = time.perf_counter()
        while True:
            try:
                with open(lock) as f:
                    holder = json.load(f)["holderIdentity"]
                break
            except (OSError, ValueError, KeyError):
                if time.perf_counter() - t_lock > 120:
                    raise AssertionError("control standby: no leader") from None
                time.sleep(0.05)
        leader = next(p for p in procs if holder == f"scheduler-{p.pid}")
        standby = next(p for p in procs if p is not leader)
        # the two started together: the standby's bootstrap ends about when
        # the leader's does; give it two more seconds to wait on the lock
        time.sleep(2.0)
        feeder = feed("sb", 0, CONTROL_PODS)
        wait_binds(server, base + CONTROL_PODS // 2, procs, "control standby leader")
        t_kill = time.perf_counter()
        leader.send_signal(signal.SIGKILL)
        leader.communicate()
        at_kill = server.stats()["bind_posts"] - base
        feeder.join()
        wait_binds(server, base + CONTROL_PODS, [standby], "control standby")
        line, child = serve_line(standby)
        stats = server.stats()
        if stats["duplicate_binds"] or stats["bind_posts"] != base + CONTROL_PODS or \
                "failover_seconds" not in line:
            raise AssertionError(f"control standby: {line} {stats}")
        # the SIGKILLed leader prints no exit line: the path's counts are
        # the standby's
        by_path["control_standby"] = child["launches"]
        standby_out = {"binds_at_kill": at_kill, "standby_scheduled": line["scheduled"],
                       "failover_seconds": line["failover_seconds"],
                       "failover_gate_s": CONTROL_FAILOVER_GATE_S,
                       "kill_to_all_bound_s": time.perf_counter() - t_kill,
                       "recovery": line["recovery"], "duplicate_binds": 0, "lost_binds": 0,
                       "drip_windows": card_windows(child, dev, "control standby"),
                       "launches": child["launches"]}
        return serve, sigterm, standby_out, by_path, server
    except BaseException:
        if server is not None:
            server.stop()
        raise
    finally:
        for proc in live:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def kill_soak(dev, seed: int, root: str, server, tag: str) -> list:
    """Config 16's three kill sites against ``server``, an in-process stub
    (namespaces prefixed with ``tag``): seeded mid-pipeline-fill kills
    (``KillSwitch`` at a journal offset, ``SimulatedCrash``) with
    reconcile-then-rebind lives, a half-filled drip window abandoned on the
    card, and an eviction whose response is lost. Returns the timeline."""
    import os

    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient
    from crane_scheduler_tpu_torch.resilience import ChaosPlan
    from crane_scheduler_tpu_torch.resilience.recovery import (
        IntentJournal,
        KillSwitch,
        Reconciler,
        SimulatedCrash,
    )

    def die():
        raise SimulatedCrash("kill")

    plan = ChaosPlan.generate(seed, steps=CONTROL_KILLS * 4, n_faults=CONTROL_KILLS,
                              kinds=("kill_process",))
    timeline = []
    for li, ev in enumerate(e for e in plan.events if e.kind == "kill_process"):
        ns = f"{tag}kill{li}"
        jdir = os.path.join(root, ns)
        for i in range(CONTROL_KILL_BATCH):
            server.state.add_pod(ns, f"soak-{i:04d}")
        pairs = [(f"{ns}/soak-{i:04d}", f"node-{i:05d}") for i in range(CONTROL_KILL_BATCH)]
        off = 1 + ev.param("offset") % 1100
        journal = IntentJournal(jdir)
        journal.kill_switch = KillSwitch(off, action=die)
        client = KubeClusterClient(server.url)
        client.attach_intent_journal(journal)
        crashed = False
        try:
            client.bind_pods(pairs)
        except SimulatedCrash:
            crashed = True
        client.stop()
        journal.close()
        journal2 = IntentJournal(jdir)
        client2 = KubeClusterClient(server.url)
        client2.attach_intent_journal(journal2)
        report = Reconciler(journal2, client2.get_pod_live).reconcile()
        redo = {k: n for k, n, _t, _a in report.reschedule}
        if redo:
            client2.bind_pods(list(redo.items()))
        pending = [(k, n) for k, n in pairs
                   if k not in redo and not client2.get_pod_live(k).node_name]
        if pending:
            client2.bind_pods(pending)
        client2.stop()
        journal2.close()
        for k, n in pairs:
            if server.state.bind_posts.get(k, 0) != 1 or \
                    server.state.pods[k]["spec"].get("nodeName") != n:
                raise AssertionError(f"control kill: {k} after a kill at {off}: "
                                     f"{server.state.bind_posts.get(k, 0)} POSTs")
        timeline.append({"leg": "pipeline", "offset": off, "crashed": crashed,
                         "outcomes": dict(sorted(report.outcomes.items())),
                         "reposted": len(redo), "swept": len(pending)})

    ns = f"{tag}window"
    for i in range(5):
        server.state.add_pod(ns, f"soak-{i:04d}",
                             spec={"containers": [{"resources": {"requests": {
                                 "cpu": "100m", "memory": "128Mi"}}}]})
    client = KubeClusterClient(server.url, list_page_limit=KUBE_PAGE)
    client.start()
    queue = kube_drip_scheduler(client, dev).open_queue(window=64)
    for p in client.list_pods():
        if p.namespace == ns:
            queue.offer(p)
    held = len(queue)
    if held != 5 or queue.results:
        raise AssertionError("control kill: the window dispatched before the kill")
    client.stop()  # the kill: the queue dies undrained, nothing reached the wire
    client2 = KubeClusterClient(server.url, list_page_limit=KUBE_PAGE)
    client2.start()
    queue2 = kube_drip_scheduler(client2, dev).open_queue(window=64)
    for p in client2.list_pods():
        if p.namespace == ns and not p.node_name:
            queue2.offer(p)
    drained = queue2.drain()
    bound = [r for r in queue2.take_results() if r.node]
    client2.stop()
    if not drained == held == len(bound) or any(
            server.state.bind_posts.get(f"{ns}/soak-{i:04d}", 0) != 1 for i in range(5)):
        raise AssertionError(f"control kill window: {held} held, {drained} drained")
    timeline.append({"leg": "window", "held": held, "rebound": len(bound)})

    ns = f"{tag}evict"
    server.state.add_pod(ns, "victim", spec={"nodeName": "node-00000"})
    server.state.inject_write_faults((0, {}))
    jdir = os.path.join(root, "evict")
    journal = IntentJournal(jdir)
    client = KubeClusterClient(server.url)
    client.attach_intent_journal(journal)
    if client.evict_pod(f"{ns}/victim") is not False:
        raise AssertionError("control kill: the lost eviction reported success")
    client.stop()
    journal.close()
    journal2 = IntentJournal(jdir)
    client2 = KubeClusterClient(server.url)
    report = Reconciler(journal2, client2.get_pod_live).reconcile()
    client2.stop()
    journal2.close()
    # the restarted descheduler re-arms the cooldown; its next sweep
    # inside the cooldown must not POST
    desched = LoadAwareDescheduler(ClusterState(), DEFAULT_POLICY, DeschedulerConfig(
        watermarks=(WatermarkPolicy("cpu_usage_avg_5m", 0.5, 0.7),),
        node_cooldown_seconds=300.0))
    for node in report.rearm_cooldowns:
        desched.rearm_cooldown(node, now=1000.0)
    if report.rearm_cooldowns != ["node-00000"] or \
            sum(server.state.evict_posts.values()) != 0 or \
            desched._last_evict.get("node-00000") != 1000.0:
        raise AssertionError(f"control kill eviction: {report.as_dict()}")
    timeline.append({"leg": "eviction", "outcomes": dict(sorted(report.outcomes.items()))})
    if server.state.duplicate_binds() or server.state.duplicate_evictions():
        raise AssertionError("control kill: a duplicate POST")
    return timeline


def control_kill_leg(dev) -> tuple:
    """Config 16's kill sites twice with one seed, on one in-process
    50,000-node stub: the same timeline."""
    metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
    server = load_kube_stub().KubeStubServer().start()
    try:
        anno = {m: f"0.30000,{KUBE_STAMP}" for m in metrics}
        for i in range(CONTROL_NODES):
            server.state.add_node(f"node-{i:05d}", f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}",
                                  annotations=dict(anno), allocatable=DRIP_ALLOCATABLE)
        reset_launches()
        t0 = time.perf_counter()
        first = kill_soak(dev, CONTROL_KILL_SEED, scratch_dir("kill-a"), server, "a-")
        soak_s = time.perf_counter() - t0
        second = kill_soak(dev, CONTROL_KILL_SEED, scratch_dir("kill-b"), server, "b-")
        launched = read_launches("control kill", need=())
    finally:
        server.stop()
    if first != second:
        raise AssertionError("control kill: the same seed gave two timelines")
    pipe = [t for t in first if t["leg"] == "pipeline"]
    return {"nodes": CONTROL_NODES, "kills": len(pipe),
            "landed_mid_stream": sum(t["crashed"] for t in pipe),
            "reconciler_reposts": sum(t["reposted"] for t in pipe),
            "sweep_binds": sum(t["swept"] for t in pipe), "duplicate_binds": 0,
            "lost_binds": 0, "duplicate_evictions": 0, "deterministic": True,
            "soak_seconds": soak_s, "timeline": first, "launches": launched}, launched


def desched_stub(kube_stub, n: int, stamp_epoch: float):
    """Config 11's world at ``n`` nodes on an in-process stub: hot nodes
    with 12 one-CPU workers, a DaemonSet and a kube-system decoy each; one
    one-CPU pod on every other node; every metric of the default policy
    at the node's requested cpu share, stamped ``stamp_epoch``."""
    server = kube_stub.KubeStubServer().start()
    st = server.state
    stamp = format_local_time(stamp_epoch)
    metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
    spec = lambda node: {"nodeName": node,  # noqa: E731
                         "containers": [{"resources": {"requests": {"cpu": "1"}}}]}
    for i in range(n):
        hot = i < DESCHED_HOT
        name = f"hot-{i}" if hot else f"cool-{i - DESCHED_HOT}"
        share = (DESCHED_HOT_WORKERS + 2) / 16 if hot else 1 / 16
        st.add_node(name, f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}",
                    annotations={m: f"{share:.5f},{stamp}" for m in metrics},
                    allocatable=DESCHED_ALLOCATABLE)
        if hot:
            for j in range(DESCHED_HOT_WORKERS):
                st.add_pod("default", f"{name}-w{j}", spec=spec(name))
            st.add_pod("default", f"{name}-ds", spec=spec(name),
                       owner_references=[{"kind": "DaemonSet", "name": "agent"}])
            st.add_pod("kube-system", f"{name}-sys", spec=spec(name))
        else:
            st.add_pod("default", f"{name}-w0", spec=spec(name))
    return server


def desched_cli(url: str, jdir: str, extra=(), seconds: float = CONTROL_DESCHED_SECONDS):
    """crane-descheduler ``--master`` as a subprocess, in this script's
    ``CLI_CHILD_ARG`` mode."""
    return start_cli([CLI_CHILD_ARG, "crane_scheduler_tpu_torch.cli.descheduler_main",
                      "--master", url, "--journal-dir", jdir, "--health-port", "0",
                      "--sync-period-seconds", "3", "--consecutive-syncs", "1",
                      "--max-evictions-per-node", "2", "--max-evictions-per-cycle", "4",
                      "--cpu-target", "0.32", "--cpu-threshold", "0.35",
                      "--node-cooldown-seconds", "300", "--run-seconds", str(seconds), *extra],
                     script=True)


def desched_lives(kube_stub) -> dict:
    """The two-life indeterminate eviction on the hot/cool pair of the
    descheduler drive (one victim and a DaemonSet pod on the hot node): the
    eviction's response is lost, the restart reconciles."""
    server = kube_stub.KubeStubServer().start()
    try:
        st, stamp = server.state, format_local_time(time.time())
        metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
        for i, (name, share) in enumerate((("hot-0", 0.92), ("cool-0", 0.15))):
            st.add_node(name, f"10.0.0.{i + 1}", allocatable={"cpu": "8", "pods": "100"},
                        annotations={m: f"{share:.5f},{stamp}" for m in metrics})
        victim = {"nodeName": "hot-0", "containers": [{"resources": {"requests": {"cpu": "1"}}}]}
        st.add_pod("default", "victim", spec=victim)
        st.add_pod("default", "ds", spec=victim,
                   owner_references=[{"kind": "DaemonSet", "name": "d"}])
        st.inject_write_faults((0, {}))
        jdir = scratch_dir("desched-lives")
        lives = []
        for _life in range(2):
            line, _child, _s = finish_child(desched_cli(server.url, jdir, seconds=2.0), 120,
                                            "control desched lives")
            with st.lock:
                lives.append((line, sum(st.evict_posts.values()),
                              [r["t"] for r in journal_lines(jdir)]))
        (l1, posts1, kinds1), (l2, posts2, _kinds2) = lives
        if posts1 != 0 or "unresolved" not in kinds1 or posts2 != 0 or \
                l2["recovery"]["outcomes"] != {"evict_unapplied": 1} or \
                l2["recovery"]["rearm_cooldowns"] != ["hot-0"] or st.duplicate_evictions():
            raise AssertionError(f"control desched lives: {lives}")
        return {"life1_evict_posts": posts1, "life1_journal": kinds1,
                "life2_recovery": l2["recovery"], "life2_evict_posts": posts2}
    finally:
        server.stop()


def control_desched_leg(kube_stub) -> tuple:
    """crane-descheduler ``--master --journal-dir --leader-elect`` on config
    11's world at 50,000 nodes: 4 evictions, no DaemonSet or kube-system
    victim, no duplicate, the Lease held, the journal closed (the
    descheduler is host Python with no ``--device``: no twin; the CPU
    tests hold it against the reference). The two-life indeterminate
    eviction runs meanwhile. The launches come from the child's exit
    line."""
    server = desched_stub(kube_stub, CONTROL_NODES, time.time())
    run = None
    try:
        jdir = scratch_dir("desched")
        run = desched_cli(server.url, jdir, ("--leader-elect",))
        lives = desched_lives(kube_stub)
        line, child, seconds = finish_child(run, 300, "control desched")
        with server.state.lock:
            evicted = sorted(e["key"] for e in server.state.evictions)
            lease = server.state.leases.get("crane-system/crane-scheduler-tpu-descheduler")
            duplicates = server.state.duplicate_evictions()
        if duplicates or lease is None or line["evictions"] != 4 or len(evicted) != 4 or \
                any(k.endswith(("-ds", "-sys")) or k.startswith("kube-system/")
                    for k in evicted):
            raise AssertionError(f"control desched: {line} {evicted} lease {lease} "
                                 f"duplicates {duplicates}")
        kinds = check_journal_closed(jdir, "control desched")
    finally:
        if run is not None and run[0].poll() is None:
            run[0].kill()
            run[0].communicate()
        server.stop()
    line["recovery"].pop("elapsed_s")
    return {"nodes": CONTROL_NODES, "evicted": evicted, "stats": line, "journal": kinds,
            "process_seconds": seconds, "two_lives": lives}, child["launches"]


class ChaosDriver:
    """Config 12's loop on a virtual clock (one step a simulated minute)
    through the port's pieces: a breaker-wrapped Prometheus sweep written
    as annotations through the mirror, the degraded-mode controller, the
    descheduler (suspended while degraded) and a drip scheduler on the
    card, while a ``ChaosPlan`` injects faults into the stubs."""

    METRIC = "cpu_usage_avg_5m"

    def __init__(self, kube_stub, plan, dev, n_nodes: int):
        from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient
        from crane_scheduler_tpu_torch.metrics import PrometheusClient
        from crane_scheduler_tpu_torch.metrics.source import MetricsTransportError
        from crane_scheduler_tpu_torch.resilience import (
            CircuitBreaker,
            DegradedModeController,
            HealthRegistry,
            RetryPolicy,
        )

        m = self.METRIC
        self.policy = DynamicSchedulerPolicy(spec=PolicySpec(
            sync_period=(SyncPolicy(m, 180.0),), predicate=(PredicatePolicy(m, 0.65),),
            priority=(PriorityPolicy(m, 1.0),)))
        self.plan, self.now, self.step = plan, NOW, 0
        self.server = kube_stub.KubeStubServer().start()
        self.prom = kube_stub.ChaosPromServer().start()
        self.names, self.ips = [], {}
        spec = lambda node: {"nodeName": node,  # noqa: E731
                             "containers": [{"resources": {"requests": {"cpu": "1"}}}]}
        for i in range(n_nodes):
            name = "hot-0" if i == 0 else f"cool-{i - 1}"
            ip = f"10.0.0.{i + 1}"
            self.server.state.add_node(name, ip, allocatable={"cpu": "16", "pods": "110"})
            self.names.append(name)
            self.ips[name] = ip
            for j in range(12 if i == 0 else 1):
                self.server.state.add_pod("default", f"{name}-w{j}", spec=spec(name))
        self.prom.set_all([self.ips["hot-0"]], 0.90)
        self.prom.set_all([self.ips[n] for n in self.names[1:]], 0.10)
        self.client = KubeClusterClient(self.server.url)
        self.client.start()
        self.transport_error = MetricsTransportError
        self.breaker = CircuitBreaker("prometheus", failure_threshold=3, window_s=600.0,
                                      reset_timeout_s=90.0, clock=lambda: self.now)
        self.health = HealthRegistry()
        self.health.watch_breaker(self.breaker)
        self.promc = PrometheusClient(self.prom.url, timeout=2.0, breaker=self.breaker,
                                      retry_policy=RetryPolicy(
                                          max_attempts=2, base_delay_s=0.0, max_delay_s=0.0,
                                          deadline_s=30.0, retryable=(MetricsTransportError,),
                                          seed=plan.seed, sleep=lambda s: None))
        self.degraded = DegradedModeController(self.policy.spec, min_eval_interval_s=0.0)
        self.desched = LoadAwareDescheduler(
            self.client, self.policy,
            DeschedulerConfig(watermarks=(WatermarkPolicy(m, target=0.32, threshold=0.35),),
                              consecutive_syncs=2, max_evictions_per_node=2,
                              max_evictions_per_cycle=4, node_cooldown_seconds=0.0),
            clock=lambda: self.now, degraded=self.degraded)
        self.sched = Scheduler(self.client, clock=lambda: self.now, device=dev)
        self.sched.register(ResourceFitPlugin(FitTracker(self.client)), weight=1)
        self.sched.register(DynamicPlugin(self.policy, clock=lambda: self.now,
                                          degraded=self.degraded), weight=3)
        self.stats = {"sweep_failures": 0, "failfast_sweeps": 0, "degraded_steps": [],
                      "suspended": 0, "evicted": 0, "evicted_while_degraded": 0,
                      "verdicts": 0, "placed": 0, "breaker_states": set()}
        self._torn_until = None
        deadline = time.time() + 30.0
        while len(self.client.list_nodes()) < n_nodes or len(self.client.list_pods()) < 17:
            if time.time() > deadline:
                raise AssertionError("control chaos: the mirror never bootstrapped")
            time.sleep(0.02)

    def appliers(self) -> dict:
        st, prom = self.server.state, self.prom

        def kube_write_storm(e):
            status = e.param("status", 503)
            st.inject_write_faults(*[(status, {}, {"Retry-After": "0.01"} if status == 429
                                      else {})] * e.param("count", 3))

        def torn_watch(e):
            st.torn_watch_writes = True
            self._torn_until = self.step + e.param("count", 1)

        def watch_410(e):
            st.inject_watch_410_after("nodes", e.param("after", 1))
            st.close_watches()

        def skew(e):
            stamp = format_local_time(self.now + e.param("offset_s", -3600.0))
            with st.lock:
                for node in st.nodes.values():
                    anno = node["metadata"].setdefault("annotations", {})
                    if self.METRIC in anno:
                        anno[self.METRIC] = f"{anno[self.METRIC].split(',')[0]},{stamp}"
                        st._stamp(node)
                        st._notify("nodes", "MODIFIED", node)

        def prom_storm(e):
            status = e.param("status", 503)
            prom.inject_faults(*[(status, 0.01) if status == 429 else status]
                               * e.param("count", 3))

        return {"prom_outage": lambda e: setattr(prom, "outage", True),
                "prom_heal": lambda e: (setattr(prom, "outage", False),
                                        setattr(prom, "delay_s", 0.0)),
                "prom_storm": prom_storm,
                "prom_slow": lambda e: setattr(prom, "delay_s", e.param("delay_s", 0.1)),
                "kube_read_storm": lambda e: st.inject_read_faults(
                    *[(e.param("status", 503), {})] * e.param("count", 3)),
                "kube_write_storm": kube_write_storm, "torn_watch": torn_watch,
                "close_watches": lambda e: st.close_watches(), "watch_410": watch_410,
                "skew_annotations": skew, "skew_heal": lambda e: None}

    def one_step(self, schedule: bool) -> None:
        s = self.stats
        hits = self.prom.hits
        try:
            by_inst = self.promc.query_all_by_metric(self.METRIC)
            stamp = format_local_time(self.now)
            self.client.patch_node_annotations_bulk({
                n: {self.METRIC: f"{by_inst[self.ips[n]]},{stamp}"}
                for n in self.names if self.ips[n] in by_inst})
            deadline = time.time() + 2.0
            while time.time() < deadline and not any(
                    (n.annotations or {}).get(self.METRIC, "").endswith(f",{stamp}")
                    for n in self.client.list_nodes()):
                time.sleep(0.01)
        except self.transport_error:
            s["sweep_failures"] += 1
            s["failfast_sweeps"] += self.prom.hits == hits
        self.degraded.update((dict(n.annotations or {}) for n in self.client.list_nodes()),
                             self.now)
        s["breaker_states"].add(self.breaker.state)
        if self.degraded.active:
            s["degraded_steps"].append(self.step)
        report = self.desched.sync_once(self.now)
        s["suspended"] += bool(report.suspended)
        s["evicted"] += len(report.evicted)
        if self.degraded.active:
            s["evicted_while_degraded"] += len(report.evicted)
        if schedule:
            pod = Pod(name=f"chaos-{self.step}", containers=ONE_CPU)
            self.client.add_pod(pod)
            result = self.sched.schedule_one(pod)
            s["verdicts"] += result is not None
            s["placed"] += result.node is not None

    def run(self) -> dict:
        appliers = self.appliers()
        for step in range(self.plan.steps):
            self.step, self.now = step, NOW + step * 60.0
            if self._torn_until is not None and step >= self._torn_until:
                self.server.state.torn_watch_writes = False
                self._torn_until = None
            self.plan.apply(step, appliers)
            self.one_step(schedule=step % 2 == 0)
        # heal everything and settle four steps
        st = self.server.state
        self.prom.outage, self.prom.delay_s = False, 0.0
        with self.prom.lock:
            self.prom.faults.clear()
        st.torn_watch_writes, st.response_delay_s = False, 0.0
        with st.lock:
            st.read_faults.clear()
            st.write_faults.clear()
        for _ in range(4):
            self.step += 1
            self.now += 60.0
            self.one_step(schedule=False)
        deadline = time.time() + 10.0
        while True:
            with st.lock:
                want = {n: dict(o["metadata"].get("annotations") or {})
                        for n, o in st.nodes.items()}
            if {n.name: dict(n.annotations or {}) for n in self.client.list_nodes()} == want:
                break
            if time.time() > deadline:
                raise AssertionError("control chaos: the mirror never converged")
            time.sleep(0.05)
        s = dict(self.stats, breaker_states=sorted(self.stats["breaker_states"]))
        s.update(duplicate_binds=st.duplicate_binds(), duplicate_evictions=st.duplicate_evictions(),
                 healthy_after=self.health.overall() == "healthy"
                 and self.breaker.state == "closed" and not self.degraded.active)
        if s["duplicate_binds"] or s["duplicate_evictions"] or s["evicted_while_degraded"] or \
                not s["healthy_after"] or s["verdicts"] != (self.plan.steps + 1) // 2:
            raise AssertionError(f"control chaos: {self.plan.describe()} {s}")
        return s

    def close(self) -> None:
        try:
            self.client.stop()
        finally:
            self.server.stop()
            self.prom.stop()


def control_chaos_leg(kube_stub, dev) -> tuple:
    """Config 12's scripted outage and one generated plan through the
    port's pieces, the scheduler on the card."""
    from crane_scheduler_tpu_torch.resilience import ChaosPlan

    reset_launches()
    out = {}
    plans = {
        "scripted": ChaosPlan(seed=1, steps=CONTROL_CHAOS_STEPS)
        .add(CONTROL_CHAOS_OUTAGE, "prom_outage").add(CONTROL_CHAOS_HEAL, "prom_heal"),
        "generated": ChaosPlan.generate(CONTROL_CHAOS_SEED, steps=CONTROL_CHAOS_STEPS,
                                        n_faults=3, quiet_tail=8),
    }
    for name, plan in plans.items():
        t0 = time.perf_counter()
        driver = ChaosDriver(kube_stub, plan, dev, CONTROL_CHAOS_NODES)
        try:
            out[name] = driver.run()
        finally:
            driver.close()
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["plan"] = plan.describe().splitlines()
    s = out["scripted"]
    if not s["degraded_steps"] or "open" not in s["breaker_states"] or not s["failfast_sweeps"] \
            or s["suspended"] < len(set(s["degraded_steps"])):
        raise AssertionError(f"control chaos: the scripted outage {s}")
    launched = read_launches("control chaos", need=())
    return out, launched


def phase_control(dev) -> tuple:
    """The control plane on the kube mirror: the journaled one-shot, the
    serve loop, SIGTERM, config 16's kill sites, the warm standby,
    crane-descheduler ``--master`` and config 12's chaos. The serve leg's
    CPU twin starts first and runs beside the one-shot leg."""
    t_phase = time.perf_counter()
    kube_stub = load_kube_stub()
    by_path, out = {}, {}
    serve_stamp = time.time()
    twin_run = start_cli([SERVE_TWIN_ARG, repr(serve_stamp)], script=True)
    wire = None
    try:
        t0 = time.perf_counter()
        out["oneshot"], by_path["control_oneshot"] = control_oneshot_leg(kube_stub, dev)
        out["oneshot"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve, sigterm, standby, serve_paths, wire = control_serve_legs(
            kube_stub, dev, serve_stamp, twin_run)
        out.update(serve=serve, sigterm=sigterm, standby=standby)
        by_path.update(serve_paths)
        out["serve_legs_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["kill"], by_path["control_kill"] = control_kill_leg(dev)
        out["kill"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["descheduler"], by_path["control_descheduler"] = control_desched_leg(kube_stub)
        out["descheduler"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["chaos"], by_path["control_chaos"] = control_chaos_leg(kube_stub, dev)
        out["chaos_seconds"] = time.perf_counter() - t0
    except BaseException:
        if wire is not None:
            wire.stop()
        raise
    finally:
        if twin_run[0].poll() is None:
            twin_run[0].kill()
            twin_run[0].communicate()
    out["seconds"] = time.perf_counter() - t_phase
    log("control", **out)
    return out, by_path, wire


# -- shards: the shard plane --------------------------------------------------------

SHARD_NODES = 250_000  # config 18's mirror (config 21's is 1,000,000: cut for wall time)
SHARD_PODS = 512  # config 18's storm
SHARD_STORMS = 3  # timed storms per scheduler count: pods/s is their median
SHARD_WINDOW = 128
SHARD_SCALING = (1, 2, 4)
SHARD_GATES = {2: 1.8, 4: 3.0}  # config 18's scaling gates (report only here)
SHARD_CONFLICT_NODES = 4_000
SHARD_CONFLICT_PODS = 800
SHARD_CONFLICT_OVERLAP = 0.25
SHARD_CONFLICT_WINDOW = 16
SHARD_CONFLICT_GATE = 0.05  # config 18's conflict-rate gate (report only here)
SHARD_RING_VNODES = 64
SHARD_WIRE_PODS = 4_096
SHARD_WIRE_MOVE_AT = 1_024  # binds before the ring file moves a token
SHARD_ALLOCATABLE = {"cpu": "64", "memory": "256Gi", "ephemeral-storage": "100Gi",
                     "pods": "1100"}  # config 21's


def shard_node_list(n: int) -> list:
    """Config 21's mirror rows: eight shared annotation variants stamped
    20 s before ``kube_now()``, config 21's allocatable."""
    metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
    ts = format_local_time(kube_now() - 20.0)
    variants = [{m: f"{0.20 + 0.01 * ((j + k) % 11):.5f},{ts}" for k, m in enumerate(metrics)}
                for j in range(8)]
    return [Node(name=f"node-{i:07d}", annotations=variants[i % 8], allocatable=SHARD_ALLOCATABLE)
            for i in range(n)]


def shard_cluster(nodes) -> ClusterState:
    # a reshard journals every moved name: size the journal for the scale
    cluster = ClusterState(dirty_journal_cap=65536)
    cluster.replace_nodes(nodes)
    return cluster


def shard_factory(dev):
    def build(view):
        return kube_drip_scheduler(view, dev)
    return build


def shard_pods(cluster, tag: str, count: int, cpu: str = "100m") -> list:
    pods = kube_drip_pods(f"sh-{tag}", count, cpu=cpu)
    cluster.add_pods(pods)
    return pods


def shard_storm(nodes, k: int, dev, threaded: bool) -> tuple:
    """``k`` schedulers over disjoint crc shards of a fresh cluster: one
    warm window of infeasible pods each, then ``SHARD_STORMS`` storms of
    ``SHARD_PODS`` pods split evenly. (placements per storm and shard,
    seconds per storm, conflicts)."""
    from crane_scheduler_tpu_torch.framework.shardplane import ShardedPlacementPlane

    cluster = shard_cluster(nodes)
    plane = ShardedPlacementPlane(cluster, k)
    plane.add_scheduler(shard_factory(dev))
    warm = [shard_pods(cluster, f"w{k}-{i}", SHARD_WINDOW, cpu="100000") for i in range(k)]
    for res in plane.run_storm(warm, window=SHARD_WINDOW, threaded=threaded):
        if any(r.node for r in res):
            raise AssertionError("shards: a warm-up pod was placed")
    observed = [{n.name for n in view.list_nodes()} for view in plane.views]
    placed, seconds = [], []
    for s in range(SHARD_STORMS):
        queues = [shard_pods(cluster, f"s{k}-{s}-{i}", SHARD_PODS // k) for i in range(k)]
        t0 = time.perf_counter()
        results = plane.run_storm(queues, window=SHARD_WINDOW, threaded=threaded)
        seconds.append(time.perf_counter() - t0)
        for i, res in enumerate(results):
            for r in res:
                if r.node is None or r.node not in observed[i]:
                    raise AssertionError(f"shards: shard {i} placed {r.pod_key} on {r.node}")
        placed.append([placements(res) for res in results])
    return placed, seconds, plane.conflict_stats()


def shards_scaling_leg(nodes, dev) -> tuple:
    """1, 2 and 4 schedulers, threaded on the card, each against the same
    plane on CPU tensors with ``threaded=False``."""
    reset_launches()
    out = {}
    for k in SHARD_SCALING:
        card, seconds, conflicts = shard_storm(nodes, k, dev, threaded=True)
        twin, twin_s, _ = shard_storm(nodes, k, torch.device("cpu"), threaded=False)
        if card != twin or conflicts:
            raise AssertionError(f"shards scaling: {k} schedulers: card != CPU twin "
                                 f"(conflicts {conflicts})")
        out[k] = {"pods_per_s": SHARD_PODS / statistics.median(seconds),
                  "pods_per_s_each": [SHARD_PODS / t for t in seconds], "seconds": seconds,
                  "cpu_twin_seconds": twin_s, "equal_to_cpu": True}
    for k, gate in SHARD_GATES.items():
        out[k]["speedup"] = out[k]["pods_per_s"] / out[1]["pods_per_s"]
        out[k]["gate"] = gate
    return out, read_launches("shards scaling", need=("drip",))


def drip_columns_of(sched):
    drip = sched._ensure_drip(sched._recognition())
    drip.ensure(kube_now())
    return drip


def same_columns(a, b, what: str) -> None:
    if a.names != b.names or any(not np.array_equal(getattr(a, c), getattr(b, c))
                                 for c in ("schedulable", "fail_entry", "weighted")):
        raise AssertionError(f"{what}: dirty-patched columns != a from-scratch build")


def shards_columns_leg(nodes, dev) -> tuple:
    """A 4-shard ring plane on the 250,000-node mirror: each shard's first
    probe builds its columns; one named patch on a shard-0 node; the
    re-probes: only shard 0 patches, one row; its columns equal a fresh
    build. Then config 21's reshard: a one-token and an eight-token move,
    ms per moved name, and every shard's patched columns equal a fresh
    build."""
    from crane_scheduler_tpu_torch.cluster.shards import HashRing
    from crane_scheduler_tpu_torch.framework.shardplane import ShardedPlacementPlane

    reset_launches()
    cluster = shard_cluster(nodes)
    ring = HashRing(4, vnodes=SHARD_RING_VNODES)
    plane = ShardedPlacementPlane(cluster, 4, layout=ring)
    scheds = plane.add_scheduler(shard_factory(dev))
    probes = iter(shard_pods(cluster, "probe", 64, cpu="100000"))  # infeasible: no binds

    def probe_all() -> list:
        out = []
        for sched in scheds:
            t0 = time.perf_counter()
            if sched.schedule_one(next(probes)).node is not None:
                raise AssertionError("shards: an infeasible probe was placed")
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    build_ms = probe_all()
    before = [s.drip_stats() for s in scheds]
    victim = next(n.name for n in nodes if ring.owners(n.name) == (0,))
    metric = DEFAULT_POLICY.spec.sync_period[0].name
    cluster.patch_node_annotation(victim, metric, f"0.90000,{format_local_time(kube_now())}")
    reprobe_ms = probe_all()
    after = [s.drip_stats() for s in scheds]
    delta = [{k: after[i][k] - before[i][k] for k in ("dirty_patches", "dirty_rows",
                                                       "full_sweeps", "rebuilds")}
             for i in range(4)]
    if delta[0]["dirty_patches"] < 1 or delta[0]["dirty_rows"] != 1 or \
            delta[0]["full_sweeps"] or any(any(d.values()) for d in delta[1:]):
        raise AssertionError(f"shards columns: re-probe counters {delta}")
    same_columns(drip_columns_of(scheds[0]), drip_columns_of(shard_factory(dev)(plane.views[0])),
                 "shards columns")

    # the reshard leg: warm the crc index (one token moved and back), then
    # a one-token and an eight-token move, timed
    _p, owners = ring.tokens()
    w = next(i for i, s in enumerate(owners) if s == 1)
    t0 = time.perf_counter()
    plane.reshard(ring.with_moves([(w, 2)]))
    plane.reshard(ring.with_moves([(w, 1)]))
    index_ms = (time.perf_counter() - t0) * 1e3
    moves = {}
    for label, count in (("one_token", 1), ("eight_tokens", 8)):
        _p, owners = ring.tokens()
        idx = [i for i, s in enumerate(owners) if s == 0][:count]
        target = ring.with_moves([(i, 1) for i in idx])
        want = {n.name for n in nodes if ring.owners(n.name) != target.owners(n.name)}
        t0 = time.perf_counter()
        moved = plane.reshard(target)
        ms = (time.perf_counter() - t0) * 1e3
        if set(moved) != want or not moved:
            raise AssertionError(f"shards reshard: {label} moved {len(moved)}, want {len(want)}")
        t0 = time.perf_counter()
        probe_all()
        moves[label] = {"moved": len(moved), "ms": ms, "ms_per_moved_name": ms / len(moved),
                        "refresh_ms": (time.perf_counter() - t0) * 1e3}
    for i, sched in enumerate(scheds):
        same_columns(drip_columns_of(sched), drip_columns_of(shard_factory(dev)(plane.views[i])),
                     f"shards reshard shard {i}")
        owned = {n.name for n in plane.views[i].list_nodes()}
        if owned != {n.name for n in nodes if i in ring.owners(n.name)}:
            raise AssertionError(f"shards reshard: shard {i}'s view != its ring ownership")
    out = {"nodes": len(nodes), "shards": 4, "vnodes": SHARD_RING_VNODES,
           "build_ms": build_ms, "reprobe_ms": reprobe_ms, "counters": delta,
           "equal_to_rebuild": True, "index_warm_ms": index_ms, **moves,
           "eight_vs_one_per_name": moves["eight_tokens"]["ms_per_moved_name"]
           / moves["one_token"]["ms_per_moved_name"]}
    return out, read_launches("shards columns", need=())


def shards_conflict_leg(kube_stub, dev) -> tuple:
    """Two schedulers with overlap 0.25 over a 4,000-node stub, 800 pods,
    threaded: the conflict rate; no duplicate POST, one POST per pod."""
    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient
    from crane_scheduler_tpu_torch.framework.shardplane import ShardedPlacementPlane

    metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
    server = kube_stub.KubeStubSubprocess()
    client = None
    try:
        server.seed(SHARD_CONFLICT_NODES, "node-", metrics=metrics, allocatable=DRIP_ALLOCATABLE)
        client = KubeClusterClient(server.url, list_page_limit=KUBE_PAGE)
        client.start()
        plane = ShardedPlacementPlane(client, 2, overlap=SHARD_CONFLICT_OVERLAP)
        plane.add_scheduler(shard_factory(dev))
        queues = [kube_drip_pods(f"cf{i}", SHARD_CONFLICT_PODS // 2) for i in range(2)]
        for pod in queues[0] + queues[1]:
            client.add_pod(pod)
        settle(client, server, {"pods": 0}, "shards conflict creations")
        reset_launches()
        t0 = time.perf_counter()
        results = plane.run_storm(queues, window=SHARD_CONFLICT_WINDOW, threaded=True)
        seconds = time.perf_counter() - t0
        launched = read_launches("shards conflict", need=("drip",))
        stats = server.stats()
        placed = sum(r.node is not None for res in results for r in res)
        conflicts = plane.conflict_stats()
        if stats["duplicate_binds"] or stats["bind_posts"] != SHARD_CONFLICT_PODS or \
                placed != SHARD_CONFLICT_PODS:
            raise AssertionError(f"shards conflict: {placed} placed, {stats}")
        return {"nodes": SHARD_CONFLICT_NODES, "pods": SHARD_CONFLICT_PODS,
                "overlap": SHARD_CONFLICT_OVERLAP, "conflicts": conflicts,
                "conflict_rate": sum(conflicts.values()) / SHARD_CONFLICT_PODS,
                "gate": SHARD_CONFLICT_GATE, "pods_per_s": SHARD_CONFLICT_PODS / seconds,
                "bind_posts": stats["bind_posts"], "duplicate_binds": 0}, launched
    finally:
        if client is not None:
            client.stop()
        server.stop()


def shards_wire_leg(server, dev) -> tuple:
    """Two ``--serve --shards 2 --shard-index {0,1} --shard-ring R``
    processes over the control phase's 50,000-node stub and 4,096 new
    pods; a ring move is written after 1,024 binds. Every pod binds once,
    both processes adopt the move, each binds only its own pods. The
    launches are the two processes' own, from their exit lines."""
    import os
    import threading

    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient
    from crane_scheduler_tpu_torch.cluster.shards import HashRing

    root = scratch_dir("wire")
    ring_path = os.path.join(root, "ring.json")
    ring = HashRing(2, vnodes=32)
    with open(ring_path, "w") as f:
        json.dump(ring.spec_dict(), f)
    base = server.stats()["bind_posts"]
    logs = [os.path.join(root, f"shard{i}.out") for i in range(2)]
    jdirs = [os.path.join(root, f"j{i}") for i in range(2)]
    procs = [serve_cli(server.url, jdirs[i], dev.type,
                       ("--shards", "2", "--shard-index", str(i), "--shard-ring", ring_path),
                       log_path=logs[i]) for i in range(2)]
    try:
        # a process opens its journal once its mirror is bootstrapped
        t_up = time.perf_counter()
        while not all(os.path.exists(os.path.join(j, "intent-000001.jsonl")) for j in jdirs):
            for proc in procs:
                if proc.poll() is not None:
                    raise AssertionError(f"shards wire: a scheduler exited {proc.returncode}")
            if time.perf_counter() - t_up > 120:
                raise AssertionError("shards wire: the schedulers never came up")
            time.sleep(0.05)
        time.sleep(0.5)
        writer = KubeClusterClient(server.url)
        feeder = threading.Thread(target=lambda: (writer.add_pods(
            kube_drip_pods("wire", SHARD_WIRE_PODS)), writer.stop()), daemon=True)
        t0 = time.perf_counter()
        feeder.start()
        wait_binds(server, base + SHARD_WIRE_MOVE_AT, procs, "shards wire")
        _p, owners = ring.tokens()
        target = ring.with_moves([(next(i for i, s in enumerate(owners) if s == 0), 1)])
        with open(ring_path + ".tmp", "w") as f:
            json.dump(target.spec_dict(), f)
        os.replace(ring_path + ".tmp", ring_path)
        at_move = server.stats()["bind_posts"] - base
        feeder.join()
        wait_binds(server, base + SHARD_WIRE_PODS, procs, "shards wire")
        seconds = time.perf_counter() - t0
        deadline = time.perf_counter() + 60.0
        while not all('"event": "reshard"' in open(p).read() for p in logs):
            if time.perf_counter() > deadline:
                raise AssertionError("shards wire: a process never adopted the ring move")
            time.sleep(0.1)
        ends = [serve_line(proc, log_path=logs[i]) for i, proc in enumerate(procs)]
        lines = [line for line, _ in ends]
        children = [child for _, child in ends]
        events = [json.loads(next(ln for ln in open(p) if '"event": "reshard"' in ln))
                  for p in logs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    stats = server.stats()
    if stats["duplicate_binds"] or stats["bind_posts"] != base + SHARD_WIRE_PODS or \
            sum(line["scheduled"] for line in lines) != SHARD_WIRE_PODS:
        raise AssertionError(f"shards wire: {lines} {stats}")
    return {"nodes": CONTROL_NODES, "pods": SHARD_WIRE_PODS, "binds_at_move": at_move,
            "moved_nodes": [e["moved_nodes"] for e in events],
            "scheduled": [line["scheduled"] for line in lines], "seconds": seconds,
            "drip_windows": [card_windows(c, dev, "shards wire") for c in children],
            "duplicate_binds": 0, "lost_binds": 0}, add_launches(*children)


def phase_shards(dev, wire) -> tuple:
    """The shard plane: config 18's columns, scaling and conflict legs and
    config 21's reshard and wire legs. ``wire`` is the control phase's
    50,000-node stub; it is stopped here."""
    server = wire
    t_phase = time.perf_counter()
    by_path, out = {}, {}
    try:
        t0 = time.perf_counter()
        nodes = shard_node_list(SHARD_NODES)
        out["mirror_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["columns"], by_path["shards_columns"] = shards_columns_leg(nodes, dev)
        out["columns"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["scaling"], by_path["shards_scaling"] = shards_scaling_leg(nodes, dev)
        out["scaling_seconds"] = time.perf_counter() - t0
        del nodes
        t0 = time.perf_counter()
        out["conflict"], by_path["shards_conflict"] = shards_conflict_leg(load_kube_stub(), dev)
        out["conflict"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["wire"], by_path["shards_wire"] = shards_wire_leg(server, dev)
        out["wire"]["leg_seconds"] = time.perf_counter() - t0
    finally:
        server.stop()
    out["seconds"] = time.perf_counter() - t_phase
    log("shards", **out)
    return out, by_path


# -- slice 14: the node mesh ---------------------------------------------------------

MESH_TILES = 4  # the mesh legs' tiles, all on cuda:0 (XLA's virtual devices' counterpart)
MESH_CONFIG18_TILES = 8  # test_sharded_drip.py's forced 8-device mesh
MESH_STEP_TIMED = 20  # step calls per CUDA-event timing
MESH_STEP_MODES = (("plain", {}), ("combined", {"dynamic_weight": 3, "max_offset": 200}))
MESH_HIT_BURSTS = 3
MESH_DRIP_PODS = 1_024
MESH_DRIP_REPARTITION = {3: 2, 6: 1}  # window -> tiles after it (4 -> 2 -> 1)
MESH_PLANE_NODES = 4_000
MESH_PLANE_PODS = 256
MESH_RANK_ARG = "--mesh-rank"  # the child mode of the two-process leg


def card_mesh(dev, tiles: int):
    """``tiles`` tiles of the node axis, all on ``dev``."""
    from crane_scheduler_tpu_torch.parallel import make_node_mesh

    return make_node_mesh(tiles, [dev] * tiles)


def launched(fn):
    """``fn()`` and the kernels' launches during it."""
    before = {name: kernel.launches for name, kernel in KERNELS.items()}
    out = fn()
    return out, {name: kernel.launches - before[name] for name, kernel in KERNELS.items()}


def add_counts(total: dict, more: dict) -> dict:
    return {name: total.get(name, 0) + more.get(name, 0) for name in KERNELS}


def mesh_gang_vectors(n: int, first: int = 0) -> tuple:
    """``tests/distributed_worker.py``'s capacities and offsets for the
    global rows ``first`` .. ``first + n``."""
    gidx = np.arange(first, first + n)
    return 1 + (gidx % 5).astype(np.int64), ((gidx * 37) % 201).astype(np.int32)


def mesh_step_leg(dev, snap) -> tuple:
    """``ShardedScheduleStep`` on 4 tiles of the card and on a 1-tile mesh,
    f64 and f32 hybrid, plain and combined, 100,000 pods: packed words equal
    ``ScheduleStep`` on the card and a 4-tile CPU twin; K1 (f32) and K2 once
    per tile; CUDA-event ms per step, tiled against single."""
    from crane_scheduler_tpu_torch.parallel import (
        ScheduleStep,
        ShardedScheduleStep,
        TiledSnapshot,
        make_node_mesh,
    )

    tensors = compile_policy(DEFAULT_POLICY)
    cpu = torch.device("cpu")
    cap, off = mesh_gang_vectors(snap.values.shape[0])
    out, total, wants = {}, {}, {}
    for dname, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        for mode, kw in MESH_STEP_MODES:
            vec = {} if mode == "plain" else {"capacity": cap, "offsets": off}
            single = ScheduleStep(tensors, dtype=dtype, device=dev, **kw)
            tiled = ShardedScheduleStep(tensors, card_mesh(dev, MESH_TILES), dtype=dtype, **kw)
            one = ShardedScheduleStep(tensors, make_node_mesh(1), dtype=dtype, **kw)
            twin = ShardedScheduleStep(tensors, make_node_mesh(MESH_TILES, [cpu] * MESH_TILES),
                                       dtype=dtype, **kw)
            sp, tp = single.prepare(snap, NOW, **vec), tiled.prepare(snap, NOW, **vec)
            if not isinstance(tp, TiledSnapshot) or len(tp.values) != MESH_TILES:
                raise AssertionError("mesh step: the snapshot is not tiled")
            want = single.packed(sp, BURST_PODS).result()
            got, per_step = launched(lambda: tiled.packed(tp, BURST_PODS).result())
            expect = {"score": MESH_TILES if dtype == torch.float32 else 0, "gang": MESH_TILES,
                      "drip": 0}
            if dev.type != "cuda":  # a CPU rehearsal: the plain versions launch nothing
                expect = dict.fromkeys(expect, 0)
            if per_step != expect:
                raise AssertionError(f"mesh step {dname} {mode}: launches {per_step}, want {expect}")
            t0 = time.perf_counter()
            cpu_words = twin.packed(twin.prepare(snap, NOW, **vec), BURST_PODS).result()
            twin_s = time.perf_counter() - t0
            for label, words in (("4 tiles", got), ("1 tile", one.packed(
                    one.prepare(snap, NOW, **vec), BURST_PODS).result()), ("CPU twin", cpu_words)):
                if words.dtype != want.dtype or not np.array_equal(words, want):
                    raise AssertionError(f"mesh step {dname} {mode}: {label} != ScheduleStep")
            wants[(dname, mode)] = want
            total = add_counts(total, per_step)
            out[f"{dname}_{mode}"] = {
                "tiled_ms": cuda_ms(lambda: tiled.packed(tp, BURST_PODS), MESH_STEP_TIMED),
                "single_ms": cuda_ms(lambda: single.packed(sp, BURST_PODS), MESH_STEP_TIMED),
                "launches_per_tiled_step": per_step, "cpu_twin_s": twin_s,
                "waterline": int(want.view(np.int32)[-1]),
            }
    return out, total, wants


def mesh_burst_leg(dev, annos) -> tuple:
    """``BatchScheduler(mesh=4 tiles, f32)`` against a mesh-free twin on a
    twin cluster: a cold burst, 3 hit bursts and a delta burst (1% of the
    nodes re-annotated), then a direct-mode pair for one column burst.
    Placements and ``refresh_stats`` paths equal; launches are the tiled
    scheduler's."""
    tensors = compile_policy(DEFAULT_POLICY)
    names = [f"node-{i:05d}" for i in range(N_NODES)]
    mesh = card_mesh(dev, MESH_TILES)
    clock = Clock(NOW)
    tiled = BatchScheduler(build_cluster(annos), DEFAULT_POLICY, dtype=torch.float32,
                           clock=clock, mesh=mesh)
    flat = BatchScheduler(build_cluster(annos), DEFAULT_POLICY, dtype=torch.float32,
                          clock=clock, device=dev)
    rngs = [np.random.default_rng(SEED + 41) for _ in range(2)]
    total, ms = {}, {"tiled": [], "flat": []}

    def burst(a, b, tag):
        nonlocal total
        pods = [f"{tag}-{i}" for i in range(BURST_PODS)]
        t0 = time.perf_counter()
        got, n = launched(lambda: a.schedule_pod_burst("mesh", pods))
        ms["tiled"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        want = b.schedule_pod_burst("mesh", pods)
        ms["flat"].append((time.perf_counter() - t0) * 1e3)
        if got.node_table != want.node_table or not np.array_equal(got.node_idx, want.node_idx):
            raise AssertionError(f"mesh burst {tag}: placements != the mesh-free twin's")
        if n != {**dict.fromkeys(("score", "gang"), MESH_TILES if dev.type == "cuda" else 0),
                 "drip": 0}:
            raise AssertionError(f"mesh burst {tag}: launches {n}")
        total = add_counts(total, n)
        clock.t += 7.0

    for k in range(1 + MESH_HIT_BURSTS):
        burst(tiled, flat, f"mb{k}")
    for sched, rng in zip((tiled, flat), rngs):
        patch_nodes(sched.cluster, names, tensors.metric_names, rng, clock.t)
    burst(tiled, flat, "mbd")
    keys = ("hit", "columns", "delta", "full")
    stats = [{k: s.refresh_stats[k] for k in keys} for s in (tiled, flat)]
    if stats[0] != stats[1] or stats[0] != {"hit": MESH_HIT_BURSTS, "columns": 0, "delta": 1,
                                             "full": 1}:
        raise AssertionError(f"mesh burst: refresh_stats {stats}")
    stores = [NodeLoadStore(tensors) for _ in range(2)]
    rngs = [np.random.default_rng(SEED + 43) for _ in range(2)]
    for store, rng in zip(stores, rngs):
        annotator_sweep(store, names, tensors.metric_names, rng, NOW - 30.0)
    clock.t = NOW
    direct = [BatchScheduler(ClusterState(), DEFAULT_POLICY, dtype=torch.float32, clock=clock,
                             store=store, refresh_from_cluster=False, **where)
              for store, where in zip(stores, ({"mesh": mesh}, {"device": dev}))]
    burst(*direct, "mbc0")
    for store, rng in zip(stores, rngs):
        annotator_sweep(store, names, tensors.metric_names, rng, clock.t)
    burst(*direct, "mbc1")
    col_stats = [{k: s.refresh_stats[k] for k in keys} for s in direct]
    if col_stats[0] != col_stats[1] or col_stats[0]["columns"] != 1:
        raise AssertionError(f"mesh burst: column refresh_stats {col_stats}")
    return {"refresh_stats": stats[0], "column_refresh_stats": col_stats[0],
            "tiled_burst_ms": ms["tiled"], "flat_burst_ms": ms["flat"]}, total


def host_window(schedulable, weighted, bounded, free, vecs) -> tuple:
    """The window as the host's scalar loop: per pod the fit mask, the
    first maximum, the feasible and tie counts, and the fold."""
    free = free.copy()
    rows = []
    for vec in vecs:
        mask = schedulable & ~(bounded & ((vec > 0) & (free < vec)).any(axis=1))
        feasible = int(mask.sum())
        if feasible == 0:
            rows.append((-1, 0, 0))
            continue
        w = np.where(mask, weighted, I64_MIN)
        best = int(np.argmax(w))
        rows.append((best, feasible, int((mask & (weighted == w[best])).sum())))
        free[best] -= vec
    out = np.asarray(rows, dtype=np.int64)
    return out[:, 0], out[:, 1], out[:, 2]


def fold_host(free, chosen, vecs):
    free = free.copy()
    for c, vec in zip(chosen, vecs):
        if c >= 0:
            free[int(c)] -= vec
    return free


def same_window(got, want, ties: bool) -> bool:
    keep = 3 if ties else 2
    return all(np.array_equal(np.asarray(g), np.asarray(w))
               for g, w in list(zip(got, want))[:keep])


def mesh_drip_leg(dev, annos) -> tuple:
    """Config 15's 50,000 nodes: ``DripBatchKernel(mesh=4 tiles)`` over
    1,024 pods in windows of 128, with and without the tie count, the carry
    kept across windows and the mesh repartitioned 4 -> 2 -> 1 mid-stream,
    each window equal to the single-device window and the host's scalar
    loop; then ``Scheduler(mesh=4 tiles).schedule_queue`` == a mesh-free
    ``Scheduler``'s."""
    from crane_scheduler_tpu_torch.parallel import make_node_mesh

    rng = np.random.default_rng(SEED + 47)
    schedulable, weighted, bounded, free, vecs, _ = window_case(N_NODES, MESH_DRIP_PODS,
                                                                "random", rng)
    out, total = {}, {}
    for ties in (True, False):
        kern = drip_batch.DripBatchKernel(mesh=card_mesh(dev, MESH_TILES))
        base = drip_batch.DripBatchKernel(device=dev)
        host_free, window_ms = free.copy(), []
        for w in range(MESH_DRIP_PODS // DRIP_WINDOW):
            if w in MESH_DRIP_REPARTITION:
                tiles = MESH_DRIP_REPARTITION[w]
                if not kern.repartition(card_mesh(dev, tiles) if tiles > 1 else make_node_mesh(1)):
                    raise AssertionError("mesh drip: the repartition changed nothing")
            v = vecs[w * DRIP_WINDOW:(w + 1) * DRIP_WINDOW]
            t0 = time.perf_counter()
            got = kern.dispatch(schedulable, weighted, bounded, host_free, v, want_ties=ties)
            window_ms.append((time.perf_counter() - t0) * 1e3)
            want = base.dispatch(schedulable, weighted, bounded, host_free, v, want_ties=ties)
            if not same_window(got, want, ties) or \
                    not same_window(got, host_window(schedulable, weighted, bounded,
                                                     host_free, v), ties):
                raise AssertionError(f"mesh drip: window {w} (ties={ties}) diverged")
            host_free = fold_host(host_free, got[0], v)
            kern.mark_synced(host_free)
            base.mark_synced(host_free)
        if kern.repartitions != 2 or kern.free_uploads != 3:
            raise AssertionError(f"mesh drip: {kern.repartitions} repartitions, "
                                 f"{kern.free_uploads} carry uploads")
        out["seeded" if ties else "unseeded"] = {"window_ms": window_ms,
                                                 "free_uploads": kern.free_uploads}
    mesh = card_mesh(dev, MESH_TILES)
    runs = {}
    for name, kw in (("tiled", {"mesh": mesh}), ("flat", {})):
        cluster = drip_cluster(annos)
        sched = drip_scheduler(cluster, dev, **kw)
        pods = storm(cluster, "md", MESH_DRIP_PODS)
        t0 = time.perf_counter()
        results, n = launched(lambda: sched.schedule_queue(pods, window=DRIP_WINDOW))
        runs[name] = (placements(results), time.perf_counter() - t0, sched)
        if name == "tiled":
            total = add_counts(total, n)
    if runs["tiled"][0] != runs["flat"][0] or not all(p[0] for p in runs["tiled"][0]):
        raise AssertionError("mesh drip: Scheduler(mesh=) placements != the mesh-free twin's")
    if runs["tiled"][2]._batch_kernel.mesh is not mesh:
        raise AssertionError("mesh drip: the scheduler's window is not on the mesh")
    out["queue_s"] = {"tiled": runs["tiled"][1], "flat": runs["flat"][1]}
    return out, total


def fuzz_window(rng, n: int, k: int, span: int) -> tuple:
    """``tests/test_sharded_drip.py``'s fuzz inputs."""
    schedulable = rng.random(n) < 0.8
    weighted = rng.integers(0, span, n).astype(np.int64)
    bounded = rng.random(n) < 0.7
    free = np.stack([rng.integers(0, 4000, n), rng.integers(0, 2 << 30, n),
                     rng.integers(0, 1 << 20, n), rng.integers(0, 20, n)], axis=1)
    vecs = np.stack([rng.integers(0, 3000, k), rng.integers(0, 1 << 30, k),
                     np.zeros(k, np.int64), np.ones(k, np.int64)], axis=1)
    return schedulable, weighted, bounded, free.astype(np.int64), vecs.astype(np.int64)


def mesh_config18_leg(dev) -> tuple:
    """Config 18's ``shard_map`` parity leg on an 8-tile mesh of the card:
    the kernel fuzz (tie-heavy and wide spans) and a node count below the
    tile count against the single-device window and its CPU version; the
    seeded tie replay (10 identical nodes, 100 pods, window 16) against
    the per-pod columnar and scalar paths with equal RNG streams; and
    ``ShardedPlacementPlane(mesh=, threaded=False)`` == the plane without
    a mesh."""
    from crane_scheduler_tpu_torch.framework.shardplane import ShardedPlacementPlane

    cpu = torch.device("cpu")
    mesh8 = card_mesh(dev, MESH_CONFIG18_TILES)
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n, k = int(rng.integers(5, 700)), int(rng.integers(1, 40))
        args = fuzz_window(rng, n, k, 5 if seed % 2 == 0 else 2**33)
        got = drip_batch.DripBatchKernel(mesh=mesh8).dispatch(*args)
        for want in (drip_batch.DripBatchKernel(device=dev).dispatch(*args),
                     drip_batch.DripBatchKernel(device=cpu).dispatch(*args)):
            if not same_window(got, want, True):
                raise AssertionError(f"config 18: fuzz seed {seed} diverged")
    tiny = fuzz_window(np.random.default_rng(5), 3, 4, 3)
    if not same_window(drip_batch.DripBatchKernel(mesh=mesh8).dispatch(*tiny),
                       drip_batch.DripBatchKernel(device=cpu).dispatch(*tiny), True):
        raise AssertionError("config 18: fewer nodes than tiles diverged")
    fresh = format_local_time(NOW - 30.0)
    metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
    same = [(f"node-{i:02d}", {m: f"0.30000,{fresh}" for m in metrics}) for i in range(10)]
    runs, total = {}, {}
    for name, kw in (("mesh", {"mesh": mesh8}), ("perpod", {}), ("scalar", {"columnar": False})):
        cluster = drip_cluster(same)
        sched = drip_scheduler(cluster, dev, tie_break_seed=7, **kw)
        pods = storm(cluster, "tie", 100)
        if name == "mesh":
            results, n = launched(lambda: sched.schedule_queue(pods, window=16))
            total = add_counts(total, n)
        else:
            results = [sched.schedule_one(p) for p in pods]
        runs[name] = (placements(results), sched._tie_rng.getstate(), sched)
    if not runs["mesh"][0] == runs["perpod"][0] == runs["scalar"][0] or \
            not runs["mesh"][1] == runs["perpod"][1] == runs["scalar"][1]:
        raise AssertionError("config 18: the seeded tie replay diverged")
    replays = runs["mesh"][2].drip_stats()["batch"]["replays"]
    if replays < 1 or len({p[0] for p in runs["mesh"][0]}) < 2:
        raise AssertionError(f"config 18: {replays} replays")
    nodes = shard_node_list(MESH_PLANE_NODES)
    planes = {}
    for name, mesh in (("mesh", card_mesh(dev, MESH_TILES)), ("flat", None)):
        cluster = shard_cluster(nodes)
        plane = ShardedPlacementPlane(cluster, 2, mesh=mesh)
        plane.add_scheduler(shard_factory(dev))
        queues = [shard_pods(cluster, f"m18-{i}", MESH_PLANE_PODS // 2) for i in range(2)]
        results, n = launched(lambda: plane.run_storm(queues, window=SHARD_WINDOW,
                                                      threaded=False))
        planes[name] = [placements(r) for r in results]
        if mesh is not None:
            total = add_counts(total, n)
            if any(s._batch_kernel.mesh is not mesh for s in plane.schedulers):
                raise AssertionError("config 18: a plane scheduler's window is off the mesh")
    if planes["mesh"] != planes["flat"]:
        raise AssertionError("config 18: the plane on the mesh != the plane without")
    return {"fuzz_seeds": 6, "tie_replays": replays, "plane_pods": MESH_PLANE_PODS}, total


def mesh_dist_store(names: list, tensors) -> NodeLoadStore:
    """The two-process leg's store over ``names`` (``node-NNNNN``): usages
    and stale rows from each node's global index, as
    ``tests/distributed_worker.py`` builds them."""
    gidx = np.array([int(n.split("-")[1]) for n in names])
    store = NodeLoadStore(tensors)
    stamps = {age: format_local_time(NOW - age) for age in (600.0, 30.0, 10.0)}
    rows = []
    for g, name in zip(gidx, names):
        anno = {m: f"{((g * 7 + j * 13) % 97) / 100.0:.5f},"
                   f"{stamps[600.0 if (g + j) % 11 == 0 else 30.0]}"
                for j, m in enumerate(tensors.metric_names)}
        if g % 3 == 0:
            anno["node_hot_value"] = f"{g % 4},{stamps[10.0]}"
        rows.append((name, anno))
    store.bulk_ingest(rows)
    return store


def mesh_dist_words(step, snap, prepare, pods: int, first: int = 0) -> dict:
    """Packed words of one step as a digest (sha256, length) and the
    launches; ``snap``'s rows are the global rows from ``first`` on."""
    import hashlib

    cap, off = mesh_gang_vectors(snap.values.shape[0], first)
    prepared = prepare(step, snap, NOW, capacity=cap, offsets=off)
    words, n = launched(lambda: step.packed(prepared, pods).result())
    return {"sha256": hashlib.sha256(words.tobytes()).hexdigest(), "words": int(words.size),
            "launches": n}


def mesh_rank_child(rank: int, port: int, device: str, nodes: int, pods: int) -> int:
    """The child mode ``MESH_RANK_ARG``: rank ``rank`` of a two-process gloo
    world on ``device`` (the card: cuda:0), half of ``nodes`` nodes on two
    tiles; the f64 and f32 hybrid combined steps' packed digests for
    ``pods`` pods as one JSON line."""
    from crane_scheduler_tpu_torch.parallel import (
        ShardedScheduleStep,
        global_node_mesh,
        initialize,
        partition_nodes,
        prepare_from_local_shard,
    )
    from crane_scheduler_tpu_torch.parallel.distributed import shutdown

    dev = torch.device(device)
    t0 = time.perf_counter()
    initialize(f"127.0.0.1:{port}", 2, rank, device=dev, backend="gloo")
    tensors = compile_policy(DEFAULT_POLICY)
    names = partition_nodes([f"node-{i:05d}" for i in range(nodes)], 2, rank)
    snap = mesh_dist_store(names, tensors).snapshot(bucket=len(names))
    out = {"rank": rank}
    for dname, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        step = ShardedScheduleStep(tensors, global_node_mesh([dev] * 2), dtype=dtype,
                                   dynamic_weight=3, max_offset=200)
        t1 = time.perf_counter()
        out[dname] = mesh_dist_words(step, snap, prepare_from_local_shard, pods,
                                     rank * len(names))
        out[dname]["seconds"] = time.perf_counter() - t1
    shutdown()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


def free_tcp_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_mesh_ranks(dev) -> list:
    """The two-process leg's children (``MESH_RANK_ARG``), started early:
    their imports, stores and CUDA contexts overlap the legs before."""
    port = free_tcp_port()
    return [start_cli([MESH_RANK_ARG, str(rank), str(port), str(dev), str(N_PADDED),
                       str(BURST_PODS)], script=True) for rank in range(2)]


def mesh_distributed_leg(dev, snap, wants, started) -> tuple:
    """An NCCL world of one process (4 tiles of the card, the combines as
    NCCL all-reduces): ``prepare_from_local_shard`` plus the step == the
    single-process step. Then two processes on cuda:0 over gloo, each
    owning half of 51,200 nodes: both ranks' packed words == the
    single-process step's over the same nodes, f64 and f32 hybrid."""
    from crane_scheduler_tpu_torch.parallel import (
        ScheduleStep,
        ShardedScheduleStep,
        global_node_mesh,
        initialize,
        prepare_from_local_shard,
    )
    from crane_scheduler_tpu_torch.parallel.distributed import shutdown

    tensors = compile_policy(DEFAULT_POLICY)
    cap, off = mesh_gang_vectors(snap.values.shape[0])
    out, total = {}, {}
    t0 = time.perf_counter()
    initialize(f"127.0.0.1:{free_tcp_port()}", 1, 0, device=dev)
    try:
        import torch.distributed as dist

        if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo"):
            raise AssertionError(f"mesh distributed: backend {dist.get_backend()}")
        for dname, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            step = ShardedScheduleStep(tensors, global_node_mesh([dev] * MESH_TILES),
                                       dtype=dtype, dynamic_weight=3, max_offset=200)
            prepared = prepare_from_local_shard(step, snap, NOW, capacity=cap, offsets=off)
            words, n = launched(lambda: step.packed(prepared, BURST_PODS).result())
            if not np.array_equal(words, wants[(dname, "combined")]):
                raise AssertionError(f"mesh distributed: NCCL world of 1 ({dname}) != the step")
            total = add_counts(total, n)
    finally:
        shutdown()
    out["nccl_world1_s"] = time.perf_counter() - t0
    full = mesh_dist_store([f"node-{i:05d}" for i in range(N_PADDED)], tensors)
    whole = full.snapshot(bucket=N_PADDED)
    want = {dname: mesh_dist_words(ScheduleStep(tensors, dtype=dtype, device=dev,
                                                dynamic_weight=3, max_offset=200),
                                   whole, lambda s, sn, now, **kw: s.prepare(sn, now, **kw),
                                   BURST_PODS)
            for dname, dtype in (("f64", torch.float64), ("f32", torch.float32))}
    ranks = []
    for proc in started:
        line, seconds = finish_cli(proc, 300)
        ranks.append(line)
        out[f"rank{line['rank']}_s"] = seconds
    for line in ranks:
        for dname in ("f64", "f32"):
            got = line[dname]
            if (got["sha256"], got["words"]) != (want[dname]["sha256"], want[dname]["words"]):
                raise AssertionError(f"mesh distributed: rank {line['rank']} {dname} != the "
                                     "single-process step")
            total = add_counts(total, got["launches"])
        out[f"rank{line['rank']}_step_s"] = {d: line[d]["seconds"] for d in ("f64", "f32")}
    out["gloo_words"] = want["f64"]["words"]
    return out, total


def mesh_cli_legs(dev) -> tuple:
    """crane-sim ``--mode sharded --devices 1`` (card == ``--device cpu``);
    crane-scheduler ``--master --placement-mesh 1`` one shot (plugin mode)
    over the 5,000-node stub == its ``--device cpu`` twin on an
    identically seeded stub; ``--placement-mesh 2`` on one card fails with
    the reference's device-count error; crane-scorer with the three
    distributed flags (an NCCL world of one) serves a ``/v1/score`` body
    equal to the plain run's."""
    import contextlib
    import io

    from crane_scheduler_tpu_torch.cli import sim_main

    def sim_line(device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = sim_main.main(["--nodes", str(CLI_DEMO_NODES), "--pods", str(CLI_SIM_PODS),
                                "--f32", "--mode", "sharded", "--devices", "1",
                                "--device", device])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        if rc != 0:
            raise AssertionError(f"crane-sim sharded ({device}) exited {rc}")
        return line

    by_path, out = {}, {}
    scorers = start_mesh_scorers(dev)
    try:
        return mesh_cli_runs(dev, sim_line, scorers, by_path, out)
    except BaseException:
        for _port, (proc, _t0) in scorers.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        raise


def mesh_cli_runs(dev, sim_line, scorers, by_path, out) -> tuple:
    """``mesh_cli_legs`` once its scorers are starting."""
    import contextlib
    import io

    from crane_scheduler_tpu_torch.cli import scheduler_main

    reset_launches()
    card = sim_line(dev.type)
    by_path["mesh_cli_sim"] = read_launches("crane-sim --mode sharded")
    cpu = sim_line("cpu")
    for line in (card, cpu):
        line.pop("latency_ms"), line.pop("kernel_launches")
    if card.pop("device") != str(card_mesh(dev, 1).devices[0]) or cpu.pop("device") != "cpu" \
            or card != cpu:
        raise AssertionError(f"crane-sim sharded: card != CPU: {card} {cpu}")
    out["sim"] = {"scheduled": card["scheduled"]}

    kube_stub = load_kube_stub()
    stamp = time.time()
    lines = {}
    for device in (dev.type, "cpu")[: 2 if dev.type == "cuda" else 1]:
        server = kube_cli_stub(kube_stub, stamp)
        try:
            buf = io.StringIO()
            if device == dev.type:  # fails at its mesh, once the mirror is up
                over = start_cli(["crane_scheduler_tpu_torch.cli.scheduler_main", "--master",
                                  server.url, "--placement-mesh", "2", "--device", device])[0]
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = scheduler_main.main(["--master", server.url, "--placement-mesh", "1",
                                          "--device", device])
            if rc != 0:
                raise AssertionError(f"crane-scheduler --placement-mesh 1 ({device}) exited {rc}")
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            line.pop("wall_seconds"), line.pop("master")
            lines[device] = (line, stub_bindings(server.url), time.perf_counter() - t0)
            if device == dev.type:
                by_path["mesh_cli_scheduler"] = {k: v.launches for k, v in KERNELS.items()}
                _, err = over.communicate(timeout=300)
                last = err.strip().splitlines()[-1] if err.strip() else ""
                if over.returncode != 1 or \
                        last != "ValueError: requested 2 devices, only 1 available":
                    raise AssertionError(f"--placement-mesh 2: rc {over.returncode}, {last!r}")
        finally:
            server.stop()
    card_run, cpu_run = lines[dev.type], lines["cpu"]
    if card_run[:2] != cpu_run[:2] or card_run[0]["scheduled"] < 1:
        raise AssertionError(f"crane-scheduler --placement-mesh 1: card != CPU twin: {lines}")
    out["scheduler"] = {"line": card_run[0], "sha256": card_run[1]["sha256"],
                        "card_s": card_run[2], "cpu_s": cpu_run[2],
                        "placement_mesh_2": "ValueError: requested 2 devices, only 1 available"}
    out["scorer"], by_path["mesh_cli_scorer"] = mesh_scorer_cli(dev, scorers)
    return out, by_path


def start_mesh_scorers(dev) -> dict:
    """crane-scorer ``--demo-nodes 2000 --f32`` on the card as two
    subprocesses, plain and with ``--coordinator-address`` /
    ``--num-processes 1`` / ``--process-id 0`` (an NCCL world of one)."""
    runs = {}
    for name, extra in (("plain", []), ("distributed", [
            "--coordinator-address", f"127.0.0.1:{free_tcp_port()}", "--num-processes", "1",
            "--process-id", "0"])):
        port = free_tcp_port()
        runs[name] = (port, start_cli(
            ["crane_scheduler_tpu_torch.cli.service_main", "--demo-nodes", str(CLI_DEMO_NODES),
             "--f32", "--port", str(port), "--now-bucket", "0", "--run-seconds", "300",
             "--device", dev.type, *extra]))
    return runs


def mesh_scorer_cli(dev, runs) -> tuple:
    """The ``start_mesh_scorers`` processes: one ``POST /v1/score`` each at
    one ``now``; the bodies equal apart from the staleness (each process's
    own refresh time), the process line printed, equal launches."""
    import re
    import signal

    bodies, exits = {}, {}
    now = NOW + 5.0
    try:
        for name, (port, (proc, t0)) in runs.items():
            while True:
                try:
                    status, _ = http_json(port, "GET", "/healthz", timeout=10)
                    if status == 200:
                        break
                except OSError:
                    pass
                if proc.poll() is not None or time.perf_counter() - t0 > 180:
                    raise AssertionError(f"mesh cli: crane-scorer ({name}) did not come up")
                time.sleep(0.1)
            status, body = http_json(port, "POST", "/v1/score", {"now": now})
            if status != 200:
                raise AssertionError(f"mesh cli: crane-scorer ({name}) answered {status}")
            bodies[name] = body
    finally:
        for name, (port, (proc, t0)) in runs.items():
            proc.send_signal(signal.SIGTERM)
            try:
                stdout, err = proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, err = proc.communicate()
            exits[name] = (proc.returncode, stdout, err)
    for name, (rc, _stdout, err) in exits.items():
        if rc != 0:
            raise AssertionError(f"mesh cli: crane-scorer ({name}) exited {rc}: {err[-400:]!r}")
    drop = lambda b: re.sub(rb'"stalenessSeconds": [0-9.e-]+, ', b"", b)  # noqa: E731
    if not bodies["plain"].startswith(b'{"backend": "' + dev.type.encode() + b'"') or \
            drop(bodies["plain"]) != drop(bodies["distributed"]):
        raise AssertionError("mesh cli: crane-scorer distributed body != the plain run's")
    process = [ln for ln in exits["distributed"][1].splitlines()
               if ln.startswith("torch.distributed: ")]
    if process != ["torch.distributed: process 0/1, 1 global devices"]:
        raise AssertionError(f"mesh cli: crane-scorer process line {process}")
    launches = {name: json.loads(stdout.strip().splitlines()[-1])["kernel_launches"]
                for name, (_, stdout, _) in exits.items()}
    if launches["plain"] != launches["distributed"] or \
            launches["plain"]["score"] < (dev.type == "cuda"):
        raise AssertionError(f"mesh cli: crane-scorer launches {launches}")
    return {"bytes": len(bodies["plain"]), "equal": True, "process_line": process[0]}, \
        launches["distributed"]


def phase_mesh(dev) -> tuple:
    """The node mesh on the card: the tiled step, the mesh burst, the
    shard-parallel drip window, config 18's parity leg, the NCCL world of
    one and the two-process gloo step, and the mesh flags of three CLIs."""
    t_phase = time.perf_counter()
    out, by_path = {}, {}
    tensors = compile_policy(DEFAULT_POLICY)
    annos = cluster_annotations(tensors, np.random.default_rng(SEED + 53))
    store = NodeLoadStore(tensors)
    store.bulk_ingest(annos)
    snap = store.snapshot(bucket=2048)
    if snap.values.shape[0] != N_PADDED:
        raise AssertionError(f"mesh: {snap.values.shape[0]} rows, want {N_PADDED}")
    legs = (
        ("step", lambda: mesh_step_leg(dev, snap)),
        ("burst", lambda: mesh_burst_leg(dev, annos)),
        ("drip", lambda: mesh_drip_leg(dev, annos)),
        ("config18", lambda: mesh_config18_leg(dev)),
    )
    children = []  # the rank children, stopped here whatever happens
    try:
        return run_mesh_legs(dev, snap, legs, out, by_path, t_phase, children)
    finally:
        for proc, _t0 in children:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def run_mesh_legs(dev, snap, legs, out, by_path, t_phase, children) -> tuple:
    """``phase_mesh``'s legs in order (the rank children start after the
    step leg, into ``children``)."""
    wants = ranks = None
    for name, fn in legs:
        t0 = time.perf_counter()
        got = fn()
        out[name], by_path[f"mesh_{name}"] = got[0], got[1]
        if name == "step":
            wants = got[2]
            ranks = start_mesh_ranks(dev)  # after the timed steps
            children.extend(ranks)
        out[name]["seconds"] = time.perf_counter() - t0
    for name, key in (("step", "mesh_step"), ("burst", "mesh_burst")):
        if dev.type == "cuda" and (by_path[key]["gang"] < 1 or by_path[key]["score"] < 1):
            raise AssertionError(f"mesh {name}: K1 {by_path[key]['score']}, "
                                 f"K2 {by_path[key]['gang']}")
    t0 = time.perf_counter()
    out["distributed"], by_path["mesh_distributed"] = mesh_distributed_leg(dev, snap, wants,
                                                                           ranks)
    out["distributed"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cli"], cli_paths = mesh_cli_legs(dev)
    out["cli"]["seconds"] = time.perf_counter() - t0
    by_path.update(cli_paths)
    out["seconds"] = time.perf_counter() - t_phase
    log("mesh", tiles=MESH_TILES, launches=by_path, **out)
    return out, by_path


def build_host_library():
    """Start building the host library (``native/lib.py``: both libraries,
    one compiler each) on a thread; the returned call waits for it, raises
    what the build raised, and returns ``host_library_line()`` with the
    wall seconds."""
    import threading

    from crane_scheduler_tpu_torch.native import lib

    done = {}

    def build():
        t0 = time.perf_counter()
        try:
            pylist = threading.Thread(target=lambda: done.update(pylist=_try(lib.load_pylist)))
            pylist.start()
            done["native"] = _try(lib.load_native)
            pylist.join()
        finally:
            done["wall_s"] = time.perf_counter() - t0

    thread = threading.Thread(target=build)
    thread.start()

    def wait() -> dict:
        thread.join()
        for key in ("native", "pylist"):
            if isinstance(done.get(key), BaseException):
                raise done[key]
        return {**host_library_line(), "wall_s": done["wall_s"]}

    return wait


def _try(fn):
    try:
        return fn()
    except BaseException as e:  # re-raised by the waiter
        return e


# per kernel in the `kernels` line: `ms` is the kernel's own device time
KERNEL_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "device_us", "bound_us",
               "pct_of_bound", "host_launch_ms", "device_launches_seen")


def main() -> int:
    if sys.argv[1:] == [PROFILE_RENDERS_ARG]:
        return profile_renders_child()
    if sys.argv[1:2] == [SCHEDULER_TWIN_ARG]:
        return scheduler_twin_child(sys.argv[2:])
    if sys.argv[1:2] == [NUMA_TWIN_ARG]:
        return numa_twin_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == [KUBE_TWIN_ARG]:
        return kube_scheduler_twin_child(float(sys.argv[2]), sys.argv[3:])
    if sys.argv[1:2] == [SERVE_TWIN_ARG]:
        return serve_twin_child(float(sys.argv[2]))
    if sys.argv[1:2] == [CLI_CHILD_ARG]:
        return cli_child(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == [MESH_RANK_ARG]:
        return mesh_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                               int(sys.argv[5]), int(sys.argv[6]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = gpu_name_and_power()
    log("environment", gpu=card, torch=torch.__version__, cuda=torch.version.cuda,
        device_count=torch.cuda.device_count())

    t0 = time.perf_counter()
    host = build_host_library()  # the host C++ library, beside the nvcc builds
    build_all([score_kernel.KERNEL, gang_kernel.KERNEL, drip_step.KERNEL])
    host_line = host()
    ptxas = {k.source.name: [ln for ln in k.build_log.splitlines() if "registers" in ln]
             for k in (score_kernel.KERNEL, gang_kernel.KERNEL, drip_step.KERNEL)}
    log("build", seconds=time.perf_counter() - t0, ptxas=ptxas, host_library=host_line)

    rng = np.random.default_rng(SEED)
    k1 = phase_k1(dev, rng)
    k2 = phase_k2(dev, rng)
    k3 = phase_k3(dev, rng)
    launches, sched, clock, last_now, hit_prepare_ms = phase_main_path(rng)
    phase_profile(sched, clock, last_now)
    by_path = {"main_path": launches}
    # the delta path scores the main path's cluster over the main path's
    # clock range, where the unpatched rows' stamps are far from expiry
    # (the hit path's conditions); its own fresh scheduler starts at NOW
    by_path["delta_path"] = phase_delta_path(sched.cluster, rng, NOW, hit_prepare_ms)
    by_path["column_path"], store, column_now = phase_column_path(rng, last_now + 24.0)
    by_path["overlap"] = phase_overlap(sched, clock, last_now + 24.0)
    by_path["hybrid_scorer"] = phase_hybrid_scorer(store, column_now)
    # the drip path runs K3 (one launch per pod step), not K1 or K2
    k3_check = phase_drip_window(dev)
    drip_annos = cluster_annotations(compile_policy(DEFAULT_POLICY), np.random.default_rng(SEED))
    queue, queue_placed, by_path["drip_queue"] = phase_drip_queue(dev, drip_annos)
    _, by_path["drip_serve"] = phase_drip_serve(dev, drip_annos, queue_placed)
    by_path["drip_scalar"] = phase_drip_scalar(dev)
    _, by_path["telemetry"] = phase_telemetry_burst(drip_annos)
    phase_telemetry_drip(dev, drip_annos, queue_placed)
    _, by_path["drip_dirty"] = phase_drip_dirty(dev, drip_annos, queue_placed,
                                                queue["ms_per_pod"])
    _, gang_paths = phase_gang_queue(dev)
    by_path.update(gang_paths)
    _, numa_paths = phase_numa_gang(dev)
    by_path.update(numa_paths)
    _, service_paths = phase_service(dev, drip_annos)
    by_path.update(service_paths)
    _, replicated_paths = phase_replicated(dev)
    by_path.update(replicated_paths)
    _, by_path["desched_window"] = phase_desched(dev)
    _, front_door_paths = phase_front_doors(dev)
    by_path.update(front_door_paths)
    _, by_path["storm"] = phase_storm(dev)
    _, kube_paths = phase_kube(dev)
    by_path.update(kube_paths)
    _, control_paths, wire = phase_control(dev)
    by_path.update(control_paths)
    _, shard_paths = phase_shards(dev, wire)
    by_path.update(shard_paths)
    _, mesh_paths = phase_mesh(dev)
    by_path.update(mesh_paths)

    kernels = [
        {
            "name": "fused_filter_score", "route": "cuda",
            "source": "crane_scheduler_tpu_torch/csrc/score_kernel.cu",
            "replaces": "crane_scheduler_tpu/scorer/pallas_kernel.py:140",
            "launches": launches["score"], "max_abs_err": k1["max_abs_err"],
            "launches_by_path": {p: c["score"] for p, c in by_path.items()},
            **{k: k1[k] for k in KERNEL_KEYS}, "library_ms": None,
        },
        {
            "name": "gang_level_totals", "route": "cuda",
            "source": "crane_scheduler_tpu_torch/csrc/gang_totals.cu",
            "replaces": "crane_scheduler_tpu/scorer/pallas_gang.py:142",
            "launches": launches["gang"], "max_abs_err": k2["max_abs_err"],
            "launches_by_path": {p: c["gang"] for p, c in by_path.items()},
            **{k: k2[k] for k in KERNEL_KEYS}, "library_ms": None,
        },
        {
            "name": "drip_step", "route": "cuda",
            "source": "crane_scheduler_tpu_torch/csrc/drip_step.cu",
            "replaces": None,  # the reference's window is a lax.scan, no Pallas kernel
            "launches": by_path["drip_queue"]["drip"], "max_abs_err": k3_check["max_abs_err"],
            # a path counted by a child that reports K1 and K2 alone has None
            "launches_by_path": {p: c.get("drip") for p, c in by_path.items()},
            **{k: k3[k] for k in KERNEL_KEYS}, "zones_2": k3["zones_2"], "library_ms": None,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
