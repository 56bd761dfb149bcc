"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 3] [--shards 6]
    python3 chip_smoke.py --f3-probe 30

The second form only builds path 2's index and takes path 14c's busy
``bsi_compare`` trace that many times, each launch's duration and start
printed (ROADMAP C, F.3), and kept in ``build/f3_probe.json``.

Run it with ``PILOSA_TPU_COMPRESS`` unset: path 3 checks what the auto
compression rule, the one users run, makes resident.

Phases, each printed on its own line:

1. environment: torch version, the card's name and power limit
   (``nvidia-smi``), the ``nvcc --version`` line;
2. build: compiles the port's CUDA kernels from ``pilosa_tpu_torch/csrc``
   into ``build/``, and beside them the launch probe
   (``pilosa_tpu_torch/probes/launch_probe.cu``), prints the build time
   and ptxas's registers, stack frame and spills of the ``tape_count``,
   ``ctile_count`` and ``scatter_merge`` kernels (the one-op path of
   ``tape_count`` and both ``scatter_merge`` kernels must have no stack
   frame and no spills);
3. kernel parity: every kernel against its plain PyTorch version on the
   card, bit for bit (tolerance 0: every result is an integer or a
   bitmap), at edge shapes and at the main path's shapes, timed with CUDA
   events (the call, host enqueue included) and with ``torch.profiler``
   (the kernel alone) beside its bound; ``tape_count`` on both of its
   paths (one-op tapes over one and two leaves; 2-7 ops, 32 leaves and
   64 ops; misaligned row views, widths 1-7 and 2^20 + 3) with its
   device ops per call in a trace (exactly one)
   and the launch floor (an empty kernel, the launch probe's fastest
   count over the same bytes); ``ctile_count`` over stacks of 1 to 35
   blocks (one launch per 16) at T = 8, 64 and 512; ``scatter_merge``
   at edge shapes, at the old 32,768-word shape and at config 1's shape
   (a ``city`` batch on its packed tiles) with its device ops per call
   (exactly one) and its PCIe bound at the measured pinned copy rates;
4. main path 1: the SSB scale-factor-1 deployment (6 shards x 2^20
   lineorder columns, a 7-row mutex ``year`` and a 1000-row keyed mutex
   ``brand``) imported through ``API.import_bits`` and queried with
   ``GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)`` and a
   set of ``Count`` trees, every answer checked against a numpy oracle
   built from the generator, the launch count of every kernel this path
   runs checked above 0; the first query's time (it builds the stacks)
   and, on one dense brand block, the host time of the compress decision;
5. main path 2: the BSI deployment (``BASELINE.json`` config 2: 10 shards
   x 2^20 columns, one ``int`` field ``amount`` of depth 20, a value in
   every column) imported through ``API.import_values`` and queried with
   ``Sum(Row(amount > 524288), field=amount)`` plus Range counts, Min,
   Max, Percentile, ``Sort(Row(amount > 1048000), field=amount,
   limit=10)`` and ``FieldValue``, each against a numpy oracle, with all
   four kernels' launch counts checked above 0; then a small index with
   negative values, a base, a decimal field, a set field and GroupBy Sum
   aggregates over one, two and three fields (the last folds), Sort
   (ascending, descending, limited) over filtered ranges, Extract and
   FieldValue, whose stacks also hold bsi_compare and pair_counts against
   their plain versions at that index's shapes;
6. main path 3, SSB SF-1 by order date: 6 shards x 2^20 lineorder
   columns loaded sorted by order date (as public SSB setups load
   lineorder, e.g. ClickHouse's ``ORDER BY (LO_ORDERDATE, LO_ORDERKEY)``),
   a 2,406-row mutex ``orderdate`` (row id = the SSB ``d_datekey``), a
   mutex ``year`` and the keyed mutex ``brand``, imported through
   ``API.import_bits`` under the auto compression rule; ``orderdate``,
   ``year`` and ``_exists`` become resident compressed (``ops/ctiles.py``)
   while ``brand`` stays dense; TopN, GroupBy and Count queries against a
   numpy oracle, and ``GroupBy(Rows(year), Rows(brand), Rows(orderdate),
   filter=Row(brand="MFGR#1003"))``, a 3-field fold with one
   ``pair_counts`` launch per level and row block, against ``np.unique``
   of the triples, and ``pair_counts`` at the fold's shapes against its
   plain version, timed beside its bound; ``ctile_count`` among the
   kernels the path must launch
   and held against its plain version on each resident compressed block
   and stack, one ``ctile_count`` launch per ``TopN(orderdate)`` query,
   stored and dense bytes and the non-zero constant lists' bytes per
   stack, the budget's accounting, p50s and the compressed count step
   (call ms, device ms and device ops) against the dense one on the
   decoded blocks;
7. a sparse BSI index (one shard, an ``int`` field set only on the
   columns [0, 65536)), whose stack the auto rule compresses: Range
   counts, Sum, Min and Max against numpy, and the active-tile compare
   against the plain compare of the decoded stack for all seven ops;
8. main path 5, ``BASELINE.json`` config 1 at full size, as
   ``bench.py`` ``bench_config1`` builds it: 1,000,000 records in shard 0
   from seed 1, set fields ``city`` (1000 rows) and ``device`` (10 rows),
   existence on, imported through ``API.import_bits`` in 8 batches of
   131,072 records (``pilosa_tpu_torch/probes/import_probe.py``): every
   row's popcount and the changed counts against numpy, one
   ``scatter_merge`` launch per ``set_many`` call, then
   ``Count(Intersect(Row(city=7), Row(device=3)))`` and five other pairs;
   the import's seconds by field and by stage, a traced import's device
   ops per launch (no fill, pinned copies only) and PCIe bytes each way
   (at most 400 MB), the first query's time, the Count's p50 and card
   busy share, and the stacks' dense and stored bytes;
9. main path 6, writes between reads, on the indexes of paths 5, 3 and
   2: (6a) config 1 takes 64 rounds of ``Set(c, city=3)Set(c, device=7)``
   on new records, each followed by
   ``Count(Intersect(Row(city=3), Row(device=7)))``, 32 Clears, a
   new city row, 16 imports of 1,024 new records, 11 replays of a
   65,536-record batch, 11 reads after ``release_field_cache``, then
   ``Store``, ``ClearRow`` and ``Delete``; (6b) SSB by order date takes
   32 mutex writes of ``orderdate`` and ``brand`` (one new brand key),
   then TopN, GroupBy and a Count; (6c) config 2 takes 64 ``Set`` and 16
   ``Clear`` of ``amount``, each followed by a Sum and a Range Count, then
   a value that grows the depth. Every answer against numpy; the
   advances, builds and stack uploads of every segment exactly as the
   JAX package's write-delta rules predict (``_LogModel``); every
   advanced stack equal to a rebuild from the host planes; which
   ``orderdate`` blocks decayed to dense; the mask bytes a write moves;
   write->visible medians beside the forced and the 65,536-batch
   rebuilds; all five kernels launched, and each held against its plain
   version on the advanced stacks;
10. main path 7, ``BASELINE.json`` config 4 at full size, as
    ``bench.py`` ``bench_config4`` builds it: 256 shards, a ``time`` field
    ``cab`` of quantum YMD with 4 rows and 12 monthly views of random
    planes (seed 4, 1,610,612,736 B of view stacks once all are
    resident), written through ``Field.write_row_plane``; the ranged
    ``Count(Row(cab=1, from='2010-03-01T00:00', to='2010-07-01T00:00'))``
    (a zero leaf and 4 month views in one ``tape_count`` launch), a ranged
    TopN (the views merged per row, then ``pair_counts`` at 1 x 4), the
    full-year TopN (the year view), two half-years (all 12 views), ranged
    Rows, ``Count(UnionRows)``, ``Count(Shift)`` (no carry across shard
    boundaries) and IncludesColumn, each against numpy with its first
    time, p50 and device busy time, no stack built or evicted inside a
    timed loop; a small index for ConstRow, Limit/offset, Distinct (set,
    and BSI under a ``bsi_compare`` filter), ``Rows(column=, previous=,
    in=)``; 32 rounds of a timestamped ``Set`` each followed by the ranged
    Count (every round one advance and no upload, as the JAX package's
    log rules predict; every advanced stack equal to a rebuild), then a
    range from mid-March that builds the new day views and the year
    view's first read; ``tape_count`` at 5 and 13 leaves and
    ``pair_counts`` at 1 x 4 against their plain versions and bounds;
11. main path 8, ``BASELINE.json`` config 5 at full size, as ``bench.py``
    ``bench_config5`` builds it: 64 shards x 2^20 rows of float32
    ``fare`` and ``dist`` from seed 5, one ``API.import_dataframe`` per
    shard (603,979,776 B resident on the card once Apply stacks them);
    ``Apply("sum(fare + dist * 2)")`` against a float64 numpy sum (rel
    1e-4), its mean (rel 1e-4), min, max and count (exact), a filtered
    sum, a vector Apply and an ``Arrow`` over a 4,096-column ``ConstRow``,
    with the import seconds, the first query, p50s, and the Sum's device
    ops and busy time beside its bytes bound;
12. main path 9, the serving layer: (9a) ``bench.py`` config 6
    (1,000,000 records, seed 6, ``city`` 50 rows, ``device`` 10), 64
    Intersect Counts one after another, then from 64 threads through
    ``API.enable_scheduler(window_ms=2.0, max_batch=64)``: QPS, p50 and
    p99 of each, the fused batches and the host waits inside each
    (exactly one), and the implicit syncs ``torch.cuda.set_sync_debug_mode``
    reports in one fused batch; (9b) config 7 (seed 7) with the result
    cache off, cold, warm (no kernel launches) and write-invalidated (each
    read a miss that launches ``tape_count``); (9c) config 8 (8 shards x
    200,000 records, seed 8), 32 Counts over random 4-of-8 shard subsets
    unfused and fused, and the fusion battery's families through
    ``execute_many(per_query_shards=...)`` against solo runs; (9d) fused
    masked waves on the indexes of paths 7, 1 and 3 (32 ranged Counts over
    complementary 128-of-256 shard subsets; Count / TopN / GroupBy over
    3-of-6 subsets; TopN(orderdate), half of them filtered), each with its
    dispatches, the mask planes built and found, the mask LRU's bytes, p50
    and p99, the fused batch's device time and busy share; no fused batch
    may fall back to solo runs; the masked ``tape_count`` and the
    mask-filtered ``pair_counts`` and ``ctile_count`` against their plain
    versions on those stacks, timed beside their bounds;
13. main path 10, the API's read calls: ``bench.py`` config 13 as it
    builds it (seed 13, 2 shards x 120,000 records, set fields ``f`` of
    64 rows and ``g`` of 32, an ``int`` field ``v`` with 4,000 values a
    shard), its seven queries through ``API.query_json`` cold (every
    stack released before every query) and warm (after
    ``Holder.prewarm``), each answer against numpy; every cold trace
    must hold ``stack.build`` and ``device.h2d_copy`` and no warm trace
    either; the cold and warm p50s, ``residency_stats`` and
    ``program_cache_len``, each warm query's p50 beside its device time
    and its host time split by stage (parse, ``_lower_root``, the stack
    lookup, each kernel wrapper, the copies back; the functions wrapped
    here, not switched in the package); then config 12 (seed 12, 2 x
    40,000 records): untraced, tracing off (no span allocated), 10%
    sampled and always on (traces stored), the same answers in all four,
    with each mode's p50;
14. main path 11, durability at full size in one data directory under
    ``build/`` (``wal_sync="batch"``): (11a) ``bench.py`` config 11 as it
    builds it (seed 11; 64, 256 and 1,024 commits of 32 bits after a
    save; an unflushed crash with ``abandon_holder``, a reopen, the
    checksum equal; recovery ms split into schema, npz load, replay and
    repair, WAL KB, replay MB/s, re-ingest ms), then
    ``CrashPlan.seeded(11)`` over ``crash_workload(8, seed=11)`` with a
    checkpoint per commit, recovered to an oracle prefix covering every
    acknowledged batch; (11b) ``BASELINE.json`` config 1 as path 5 builds
    it, into ``API(path)`` (the checkpoints the import fires, printed),
    six Intersect Counts and ``TopN(city, n=10)`` against numpy, crash 1
    and recovery (the first answer after the restart), a checkpoint's
    seconds and bytes on disk, 64 rounds of writes each read back
    (write->visible with the WAL beside path 6a's), an import of 131,072
    new records, crash 2 over the checkpoint and its tail; (11c) config
    2's ``amount`` (10 shards, a shard a request) in a second index,
    crash, then Sum, a Range Count, Min and Max against numpy; (11d)
    ``backup_tar`` and ``restore_tar`` into a fresh ``API(path)``; (11e)
    one shard of ``city`` as a roaring blob through ``import_roaring``;
    every recovered checksum equal to the one before its crash;
    ``tape_count``, ``pair_counts``, ``bsi_compare`` and
    ``scatter_merge`` launched, the first two against their plain
    versions on the recovered stacks;
15. main path 12, ingest and streams, each ``bench.py`` config at its
    full size: (12a) config 1 as ``bench_config1`` runs it, 1,000,000
    CSV rows from seed 1 (``city`` 1000 rows, ``device`` 10) through
    ``Ingester(api, "taxi", CSVSource(csv_text, inline=True),
    batch_size=131072)``: rows/s beside the raw ``csv.reader`` parse,
    its ``scatter_merge`` launches, the checksum equal to the same
    records loaded with ``API.import_bits`` (path 5's loader) and the
    Counts equal to numpy; (12b) config 17 as ``bench_config17`` runs it,
    2,000,000 rows from seed 17 in two shards (``city`` 100 rows,
    ``device`` 10): the classic CSV Ingester best of 2, the stream as
    8,192-row chunks, the classic oracle draining it, the pipelined
    ingester best of 3 at ``batch_rows=32`` (each checksum equal to the
    oracle's), then with the scheduler on the GroupBy p50 / p99 alone and
    under a churn of pipelined re-ingests at ``batch_rows=8``, the reads
    paced at twice the scheduler's batch holdoff (a churn batch must
    start and land between the first read and the last, the churn must
    re-apply at least 2,000,000 rows, the checksum must not change, the
    Count must equal numpy and the GroupBy's 100 groups numpy's pair
    counts; the batches, rows and shed admits inside the reads and the
    reads an apply overlapped are printed); ``bench.py``'s speed bars
    (pipelined >= 2x classic, busy p50 / p99 <= 1.5x alone) are printed
    met or missed, not asserted; (12c) datagen's ``kitchen-sink``, 200,000
    records from seed 1 through the per-record ``Batch``, its Counts
    (one for each ``an_idset`` row), a Range Count, a Sum and a bool
    Count against an oracle of the generated records; (12d)
    ``API(path)`` under ``build/`` with ``enable_stream(batch_rows=64)``:
    64 pushes of 1,024 records each drained by ``step``, then the same
    with a kill at ``stream.apply`` hit 2, ``abandon_holder``, a reopen
    and a resume from the replayed source: the checksum equal to the
    clean run's and the offsets summing to the records pushed;
    ``scatter_merge``, ``tape_count``, ``pair_counts`` and
    ``bsi_compare`` launched, ``scatter_merge`` and ``pair_counts``
    against their plain versions on path 12's planes and stacks;
16. main path 13, SQL on ``bench.py`` config 23's single node as
    ``bench_config23`` builds it, from the port's ``loadgen/ssb.py``:
    (13a) ``ssb.generate(120_000, seed=7)`` loaded by ``ssb.load`` in
    500-row INSERTs through ``API.sql`` (the seconds split by host stage:
    the SQL parse, the records, ``_batch_upsert``'s own work, the
    imports, ``set_mutex_many``, the BSI writes and the bulk scatter with
    its ``scatter_merge`` launches); all 13 queries against ``ssb.oracle``
    under ``ssb.verify`` (row multisets and ORDER BY keys); the two
    no-join queries must leave ``sql_join_queries_total`` /
    ``sql_join_fallback_total`` still; each query's first (cold) time and
    warm p50 (20 runs); the Q2/Q3 flights' hash-fallback p50s
    (``PILOSA_TPU_SEMIJOIN=0``, one run, its answer checked) and the worst
    speedup against ``bench.py``'s 2x bar, printed met or missed, not
    asserted; Q1.1, Q2.1, Q3.1 and Q4.1's card busy ms, launches per
    kernel, executor waits and implicit syncs, and one warm run's host
    ms by layer (the SQL parse, planning, the executor's calls, the host
    operators and the API's own work); ``lineorder``'s resident
    stacks, stored and dense bytes; (13b) ``fb_exec_requests`` lists the path's
    last statements with their language and status, a ``QueryLogger``
    under ``build/`` holds one line per statement, and
    ``fb_performance_counters`` shows ``sql_queries_total``;
    ``scatter_merge``, ``bsi_compare`` and ``pair_counts`` (and
    ``tape_count`` / ``ctile_count`` when the path launched them)
    launched, and the first four against their plain versions on path
    13's planes; (13c) config 23's 3-node phase: ``LocalCluster(3,
    replica_n=2)`` under its ``FaultPlan`` (seed ``PILOSA_TPU_FAULT_SEED``,
    default 23), the same load through the coordinator's ``sql``, the
    13 queries from two nodes, a fan-out battery, a routed DELETE, warm
    p50s, and a faulted pass: resilience on, lineorder's shard-0 owner's
    query and SQL-subtree legs delayed 1 s, every answer against the
    oracle, the hedged and won waves of each kind counted;
17. main path 14, observability (run right after path 9, on the
    indexes paths 1, 2, 3 and 5 built): (14a) ``bench.py`` config 16 at
    its own sizes (seed 16, 2 shards x 80,000 columns, ``f`` 32 rows,
    ``g`` 16): with ``obs/devprof.py`` off no cost evaluation, no profile
    and no profiler event; on, the same results and a profile with
    positive MFU and GB/s for each of the four query families; 24 paired
    off/on rounds, their p50s and the overhead against the JAX package's
    3% reading (printed met or missed); a ``tape_count`` call's host time
    off and on and its kernel clock's time; (14b) config 15 (seed
    15, 2 x 40,000, 8 rows): no timeline sample while the health plane is
    off, ``enable_health(interval_ms=10.0)`` samples, counts query SLO
    events and keeps results, p50s both ways, then ``start=True`` and a
    ``disable_health`` that joins the sampler thread; (14c) the profiler
    over path 1's Count and GroupBy+TopN, path 2's filtered Sum, path 3's
    ``TopN(orderdate)`` and one config-1 import batch on path 5's index:
    each of the five kernels' devprof time per launch (the kernel's own
    clock) against the ``torch.profiler`` kernel time of the same calls
    (L2 flushed first), on an idle card and behind a 2 ms spin kernel,
    within max(3 us, 30%) in both, and no share above 105% of the named
    card's peaks;
    (14d) under a ``ManualClock``, path 1's brand stack rebuilt through a
    64 MiB budget: evictions above 10/s fire ``eviction_storm``, whose
    bundle holds the ``residency`` and ``kernels`` probes; the
    resident-bytes gauges equal ``BUDGET.used`` after every charge and
    release; the budget is restored; all five kernels launched;
18. main path 15, the front ends (run last, data dirs under
    ``build/chip_smoke_frontend``, removed at the end): (15a) ``python -m
    pilosa_tpu_torch server --config <toml>`` in a process of its own on
    a free port (``wal-sync = "batch"``, ``PILOSA_TPU_DEVPROF=1``),
    waited for on ``GET /health``; ``GET /info`` must name the H100;
    through the port's ``Client``, ``bench.py`` config 1 at full size
    (1,000,000 records from seed 1, ``city`` 1000 rows, ``device`` 10;
    ``sync_schema``, ``import_bits``: one roaring blob per shard and
    field) and config 2's ``amount`` (10 x 2^20 values from seed 2,
    ``import_values``, a shard a request); ``Count(Row(city=3))``,
    ``TopN(city, n=10)``, ``GroupBy(Rows(city), Rows(device),
    limit=100)``, a Count tree and ``Sum(Row(amount > 524288),
    field=amount)`` over HTTP, the counts as ``POST /sql``
    (``SETCONTAINS``, ``SUM``) and as framed gRPC (``QueryPQLUnary``,
    ``QuerySQL``), each against numpy, before and after 64 ``Set`` writes
    and a 4,096-bit JSON import; (15b) the CLI against it: a CSV field's
    ``import`` / ``export`` round trip, ``SELECT COUNT(*)`` piped into
    ``fbsql``, ``chksum`` equal to ``GET /internal/chksum``, ``backup``;
    (15d) keep-alive p50s of the warm Count, the GroupBy and ``GET
    /status``, the profiled Count split into its ``query.pql`` span and the front
    end's own time, the QPS of 16 concurrent clients (every answer
    against numpy), and each kernel's dispatches from ``GET
    /internal/stats/kernels`` (``tape_count``, ``pair_counts``,
    ``scatter_merge``, ``bsi_compare`` and ``ctile_count`` above 0); (15c) SIGKILL, a restart
    on the same directory with ``[auth]`` on (JWTs signed here, a
    permissions file with reader, writer and admin groups): every
    acknowledged write and every 15a answer read back, the checksum
    unchanged, restart-to-first-answer seconds, 401 / 403 / 200 as the
    JAX package gives them; ``restore --source`` of the backup into a
    third server on an empty directory, its ``chksum`` equal; (15e) the
    first server's directory opened in-process with ``API(path)``:
    ``tape_count``, ``pair_counts`` (every city block against every
    device block, as the server's dense GroupBy launches it; the whole
    1,000 x 10 count matrix also against numpy), ``bsi_compare``,
    ``scatter_merge`` and ``ctile_count`` (the CSV field's compressed
    blocks, counted as ``Rows`` counted them in the server) against their
    plain versions on its planes;
19. main path 16, the cluster core (run after path 15): three
    ``ClusterNode`` objects in this process, ``LocalCluster(3, replica_n=1,
    device="cuda:0")``, every node on the card and served over loopback
    HTTP; (16a) ``bench.py`` config 3 (6 x 2^20 columns, seed 3, ``year``
    and the keyed ``brand``, whose keys the coordinator's translator
    creates first in sorted order, the ids path 1's bulk import gives
    them, timed on their own) loaded through ``co.import_bits``, one
    shard's columns a call, which looks the brand keys up: the load's
    seconds, the shards each node holds (two nodes at least)
    and the brand keys each node's primaries created; Count, a keyed
    Count(Intersect), TopN, GroupBy and path 1's GroupBy+TopN from every
    node, each against numpy and against path 1's single-node answer,
    then 8 concurrent clients asking the Counts, the TopN and the
    GroupBy of every node, each answer equal to the serial one;
    (16b) config 2's ``amount`` (10 x 2^20 values from seed 2, as path
    15 draws them) through ``co.import_values``, a shard a call: Count,
    Sum, Min, Max and Percentile nth=50 and 99 against numpy, with each
    query's fan-outs; (16c) 64 ``Set`` calls and one 4,096-bit import
    through node 1, read back from every node (node 2 among them) against
    the oracle with the writes applied, ``scatter_merge`` launched on the
    owners; the path's launches (``tape_count``, ``pair_counts``, ``scatter_merge``,
    ``bsi_compare`` above 0, ``ctile_count`` printed); (16e) each query's
    warm p50 from the coordinator (5 runs of a GroupBy or a Percentile,
    11 of the others), its RPCs (``InternalClient.op_counts``)
    and its host waits and implicit syncs over all legs and per leg, the
    profiled GroupBy's ``cluster.leg`` and ``rpc.post_internal_query``
    spans beside its wall time, one GroupBy leg taken apart on the host
    (the serving node's execute, the JSON bytes, encode and decode, the
    leg over HTTP, the coordinator's merge), and path 1's single-node
    p50 of the same query;
    (16f) ``tape_count``, ``pair_counts`` (a node's year block against
    each of its brand blocks), ``bsi_compare`` (a node's ``amount`` stack)
    and ``scatter_merge`` (16c's batch on its owner) against their plain
    versions on the nodes' planes; (16d) ``LocalCluster(3, replica_n=2)``
    over 4 x 2^20 columns: ``pause(1)`` leaves the coordinator DEGRADED,
    reads equal numpy through the replicas, a write raises
    ``ClusterStateError``; after ``unpause(1)`` NORMAL and the write is
    read back from every node; its nodes share an unarmed ``FaultPlan``
    and it stays open for path 17;
20. main path 17, fan-out resilience and leg batching: (17c) on 16d's
    cluster, an owner delayed with hedging on (reads equal numpy,
    hedges win); an owner dropped (``plan.drop``): the reads fail over,
    its breaker opens, later reads are vetoed to the replicas with no
    RPC to it, the coordinator's flight recorder holds the breaker
    event and one ``breaker_open`` bundle, ``GET
    /internal/stats/cluster`` returns every node's window (the open one
    as "breaker open"); after ``plan.clear()`` and 2 s one half-open
    probe closes the breaker and marks the node up; a 64-way batched
    wave of mixed-shard Counts equal to numpy; ``pair_counts`` against
    its plain version on a node's block; (17a) ``bench.py`` config 9 as
    ``bench_config9`` builds it (6 x 50,000 records, seed 9,
    ``Count(Row(f=3))`` 20 times healthy, unhedged under a delay,
    warm and hedged), every answer equal, a hedge won, each phase's
    p50 and p99, ``scatter_merge`` against its plain version on an
    owner's planes; (17b) config 14 as ``bench_config14`` builds it (64
    mixed-shard Counts, 3 waves unbatched and 3 batched through a
    barrier, every answer against the bincount oracle, at least 8x fewer
    node RPCs batched and none on ``/internal/query``, the chaos wave),
    and on a serving node one batch through ``query_remote_batch``, each
    of its ``tape_count`` launches against its plain version with its
    ``ShardMask``; ``tape_count`` and ``scatter_merge`` launched, each
    step's seconds;
21. main path 18, gossip, SWIM membership and replica catch-up: (18a)
    ``bench.py`` config 10 as ``bench_config10`` builds it (a 2-node
    cluster, 4 x 20,000 records of an 8-row field, seed 10; 8 trials of
    a remote shard's ``Count(Row(f=3))`` cached on the coordinator while
    its owner is written directly, with a 300 ms TTL-only leg cache,
    then 8 with gossip-keyed caching at ``ttl_ms=0`` and 10 ms rounds):
    each phase's stale-read window p50 and p99 (the gossip p50 below
    the TTL p50, no window at the 5 s bail), every read at least the
    count before its write, the rounds, deltas and piggybacks; (18b) a
    3-node, 2-replica cluster with data directories
    (``build/chip_smoke_gossip``, removed at the end) over 16d's width
    (index ``rc``, a 7-row mutex field over 4 x 2^20 columns, seed 18),
    gossip, membership, resilience and the health plane on every node:
    node 2 paused and silent until the coordinator's ``live_ids`` drops
    it (reads equal numpy throughout, its breaker prewarms node 1),
    100,000 row changes on its shards' other owners, node 2 back until
    it is alive again, ``lagging`` naming its shards and ``catch_up``
    (4,096 more changes land at the peer after its snapshot and reach
    node 2 in the WAL tail): shards, records, tail and snapshot bytes,
    ``lag_ms`` (the script's own late write, inside it, timed beside
    it), the replay's ``scatter_merge`` launches; node 2's planes equal
    its peer's, reads from node 2 and the coordinator equal numpy with
    the ``tape_count`` and ``pair_counts`` launches of node 2's reads
    (on every node) against their plain versions,
    its breaker gossiped open then closed, a second catch-up empty,
    ``scatter_merge`` against its plain version on the replayed tiles;
    (18c) on that cluster, the coordinator's Count p50 with the gossip
    envelope on its requests and off, the envelope's bytes, the round's
    ms, the entries and origins; ``tape_count`` and ``scatter_merge``
    launched, each step's seconds;
22. main path 19, tenants and graceful degradation (data dirs under
    ``build/chip_smoke_tenants``, removed at the end): (19a) ``bench.py``
    config 18 as ``bench_config18`` builds it (a 3-node, 2-replica
    cluster under ``FaultPlan(seed=18)``'s 2 ms query delays on node1 /
    node2, 400,000 records of ``city`` x 50 and ``device`` x 8, seed 18;
    the three-query suite over HTTP with ``X-Tenant``, 40 timed runs a
    query, with the plane off (the oracle, numpy's answers, no tenant
    scope entered), on for ``alpha`` / ``bravo`` / ``charlie``, and
    under ``mallory``, capped at 5 qps and 400 rows/s, flooding another
    index): every answer the oracle's, ``mallory`` rejected with
    ``Retry-After`` and alone burning its SLO budget,
    ``/internal/tenants`` listing all four, the burn gauge in
    ``/metrics``, a ``tenant_burn`` bundle; each tenant's p99 against
    its 1.5x no-abuser bar (met / missed), each tenant's device seconds
    beside devprof's device time of the same window; (19b) ``bench.py``
    config 22 as ``bench_config22`` builds it (3 nodes, 2 replicas,
    gossip, tenants, schedulers with ``max_queue=32``, caches, the
    health plane at 100 ms with a 5 s fast window, 200,000 records of
    ``f`` x 40 and ``g`` x 200 below 2^22, seed 22, a stream index):
    off is free; a 6 s open-loop soak of 100,000 synthetic tenants
    under a ``ChaosSchedule`` (ladder below 2, fast burn below 60,
    ``ok_frac`` at least 0.5); every acknowledged write read back; the
    0.7x / 1.3x / 2.4x ramp off the measured capacity (batch shed before
    interactive, an intermediate level before SATURATED, a stale read
    in brownout, every 429 with ``Retry-After``), recovery to NORMAL,
    the bounded tables; the saturated good-put against its 50% bar (met
    / missed). Every kernel each step launched held against its plain
    version at the step's shapes;
23. main path 20, the DAX serverless plane (shared directory under
    ``build/chip_smoke_dax``, removed at the end): (20a) ``bench.py``
    config 19 as ``bench_config19`` builds it (a 3-computer
    ``DaxCluster`` on the card with ``dead_after_s=1.0``,
    ``snapshot_every=64`` and the serving queryer; table ``e`` with a
    16-row set field ``f`` and an int field ``v`` over 12 shards, seed
    19; 4,800 ``Set``s in batches of 8, each retried until acked and then
    mirrored to an oracle ``API``, ``import_values`` every 12th batch, a
    read against the oracle every 10th; computer 0 killed at 30%,
    computer 1 silenced at 50% (the checkin poller buries it), a
    scale-up at 70%): every read the oracle's; a RESET behind the
    controller's back rebuilt by a FULL resync; a warm handoff whose new
    owner prewarms before its ack; the fresh owner's p99 against 2x the
    warm p99 and the 5 s window (host-speed bars, printed met / missed);
    a fresh computer replaying all 12 shards to the oracle's checksum,
    then ``Count(Row(v > 0))`` and ``Sum(field=v)`` on it against the
    oracle. (20b) the same plane at SSB SF-1 width (``bench.py`` config
    3's lineorder cut to its first 3 of 6 shards x 2^20 columns, a 7-row
    mutex ``year`` and a 1,000-row mutex ``brand`` by row id, seed 3) with
    ``snapshot_every=8``, loaded through ``Queryer.import_bits`` in 8
    batches a shard a field (every shard snapshots), 64 ``Set``s as the
    log tail, then GroupBy, TopN and ``Count`` trees through the queryer
    against numpy; the computer holding the most shards killed (the
    seconds to the first correct answer over its shards, and the new
    owner's snapshot install, tail replay and prewarm); a scale-up (its
    directive-to-ack seconds, prewarmed stacks and bytes, the p99 of 60
    distinct reads on a fresh shard and on a warm one); every shard
    replayed into a fresh computer to the oracle ``API``'s checksum; the
    snapshot bytes on disk, each computer's resident bytes and the
    prewarm's PCIe bytes. Every kernel each step launched held against
    its plain version at the step's shapes;
24. main path 21, the mesh reduces (run right after path 14, on paths
    1 and 2's indexes): the five reduces of ``parallel/mesh.py`` at 8
    shards x 512 words over 8 virtual devices at ``col_parallel`` 1, 2
    and 4 against numpy; then ``year`` and ``brand`` as host planes
    ``[6, R, 32768]`` and config 2's ``amount`` (with the filter
    ``amount > 524288`` decoded in numpy) placed on a one-device mesh
    and on a virtual 2 x 2 mesh over ``cuda:0``: ``count`` of one year
    row, ``intersect_count`` of a year and a brand row,
    ``row_counts(brand)``, the 7 x 1000 ``groupby_counts`` and the
    filtered ``bsi_sum_counts``, each bit for bit against numpy and the
    executor's own Count, TopN, GroupBy and Sum; each reduce's p50, its
    launches a call (blocks x kernels, from the counters, exact), its
    kernels and device ops a call in a trace, and the bytes placed;
25. the empty traces of counted launches that ``_device_ops`` took
    again, then one ``{"kernels": [...]}`` JSON line;
26. the last line: ``{"ok": true, "device": {...}}``.

Each phase's seconds are printed as it ends.

Exits non-zero, without the last line, when there is no CUDA device, when
the port is not importable, or when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time


def _smi(query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""


def _mem_rate(name: str) -> float:
    """Published device-memory bandwidth, bytes/s (H100 data sheet)."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


#: 32-bit __popc results per clock per SM, compute capability 9.0
#: (NVIDIA's arithmetic instruction throughput table)
POPC_PER_CLOCK_PER_SM = 16
#: 32-bit bitwise AND/OR/XOR results per clock per SM, same table
LOP_PER_CLOCK_PER_SM = 64
#: dense int8 tensor-core operations per second of an H100 SXM (NVIDIA's
#: data sheet); pair_counts' bound counts 2 per bit pair
INT8_OPS_PER_S = 1979e12


def _time_ms(fn, reps: int = 10, trials: int = 9) -> float:
    """Median per-call milliseconds over ``trials`` batches of ``reps``
    calls, after warm-up, timed with CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)


def _device_ms(fn, kernel: str = "", calls: int = 20, flush=None):
    """Mean device milliseconds per call of ``fn`` spent in kernels whose
    name contains ``kernel`` ("" = every device activity, copies
    included), from a ``torch.profiler`` trace of ``calls`` calls; None
    when the trace holds no device time for them. Unlike ``_time_ms``,
    this excludes the host's time to enqueue each launch. With
    ``flush`` (a tensor larger than L2, zeroed before every call) the
    operands come from device memory, not L2; name a kernel then, or the
    zeroing counts too. Flushed traces of an H100 have held 18 or 19 of
    20 launches, so with ``flush`` the time is the mean of the events the
    trace holds times the whole number of them a call launches; a trace
    that holds none (seen once) is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    if flush is not None:
                        flush.zero_()
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as e:  # no CUPTI tracing on this machine
            print(f"profiler: {e}")
            return None
        hits = [e for e in prof.key_averages() if kernel in e.key]
        us = sum(e.self_device_time_total for e in hits)
        if us > 0:
            break
    else:
        return None
    if flush is None:
        return us / calls / 1e3
    events = sum(e.count for e in hits)
    if events % calls:
        print(f"profiler: a trace of {calls} calls held {events} events "
              f"of {kernel!r}")
    return us / events * max(1, round(events / calls)) / 1e3


#: empty traces of windows whose launch counters rose (``_device_ops``)
PROFILER_MISSES = []


def _device_ops(fn, calls: int = 50):
    """{device operation name: (events, mean ms per event)} over ``calls``
    calls of ``fn`` in a ``torch.profiler`` trace (kernels, fills and
    copies alike), taken after a discarded warm-up trace. A trace can
    miss an event (99 of 100 launches seen on an H100), so an operation's
    mean is taken over the events it holds, and :func:`_once_per_call`
    checks the count against bounds, not for equality.

    The events are read only after the profiler has stopped: the card is
    synchronized inside the ``profile`` block, and leaving it stops the
    trace, flushes CUPTI's activity buffers and parses them, all before
    ``prof.events()`` returns. A trace of real launches has once come
    back with no device event at all (100 ``scatter_merge`` calls on an
    H100, in one run of nine; the cause is not known). An empty trace is
    taken again only when the kernels' own launch counters
    (``kernel_util.launches``) rose by at least ``calls`` in its window,
    which shows that the launches were made and the trace lost them; each
    such trace is printed and kept in ``PROFILER_MISSES`` for the report,
    and at most three are taken. An empty trace whose window the counters
    do not show launching, or a third one, returns ``{}``, which fails
    the caller's check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pilosa_tpu_torch.ops import kernel_util as KU

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):  # warm-up, discarded
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for attempt in range(3):
        before = sum(KU.launches().values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = sum(KU.launches().values()) - before
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.split("(")[0]
                k, us = seen.get(name, (0, 0.0))
                seen[name] = (k + 1, us + e.time_range.elapsed_us())
        if seen:
            break
        print(f"profiler: a trace of {calls} calls held no device event; "
              f"the launch counters rose by {launched} in its window "
              f"(attempt {attempt + 1} of 3)")
        if launched < calls:
            break
        PROFILER_MISSES.append({"calls": calls, "launches": launched})
    return {name: (k, us / k / 1e3) for name, (k, us) in sorted(seen.items())}


def _once_per_call(traced: dict, calls: int, names: int) -> None:
    """Each of ``names`` device operations ran at most once a call: no
    other operation appears in the trace (one that runs every call cannot
    lose all its events), and none has more events than calls. Half the
    calls' events is the least a trace is allowed to hold."""
    assert len(traced) == names, f"{len(traced)} device ops: {traced}"
    for name, (k, _) in traced.items():
        assert calls // 2 <= k <= calls, f"{name}: {k} events, {calls} calls"


def _random_tape(rng, n_leaves: int, n_ops: int):
    """A seeded tape of ``n_ops`` ops over ``n_leaves`` leaves whose first
    ops fold in every leaf."""
    ops = ("and", "or", "xor", "andnot")
    tape = []
    for k in range(n_ops):
        regs = n_leaves + k
        if k < n_leaves - 1:
            i, j = (0 if k == 0 else regs - 1), k + 1
        else:
            i, j = (int(x) for x in rng.integers(0, regs, 2))
        tape.append((ops[int(rng.integers(0, 4))], i, j))
    return tuple(tape)


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _rand_words(rng, shape, device):
    import numpy as np
    import torch

    host = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(host.view(np.int32)).to(device)


class Report:
    def __init__(self, gpu_name: str, power_limit: str):
        self.label = f"({gpu_name}, power limit {power_limit})"
        self.kernels = {}
        #: figures a later path prints beside its own
        self.notes = {}

    def launched(self, path: str, counts: dict, expected) -> None:
        """Record one main path's launch counts; every kernel of
        ``expected`` must have launched on it."""
        for name in expected:
            assert counts.get(name, 0) > 0, \
                f"kernel {name} was not launched on the {path} path"
        for name, c in counts.items():
            k = self.kernels.setdefault(name, {"name": name, "route": "cuda",
                                               "max_abs_err": 0})
            k["launches"] = k.get("launches", 0) + c
            k.setdefault("launches_by_path", {})[path] = c

    def kernel(self, name: str, **kw) -> None:
        self.kernels.setdefault(name, {"name": name, "route": "cuda",
                                       "max_abs_err": 0})
        self.kernels[name].update(kw)

    def err(self, name: str, got, want) -> None:
        import torch

        e = int((got.long() - want.long()).abs().max().item()) \
            if got.numel() else 0
        k = self.kernels.setdefault(name, {"name": name, "route": "cuda",
                                           "max_abs_err": 0})
        k["max_abs_err"] = max(k["max_abs_err"], e)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {e})")


def phase_kernels(report: Report, rng, device, popc_rate: float,
                  mem_rate: float, lop_rate: float,
                  int8_rate: float, probe_lib) -> None:
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.probes import launch_probe as LP
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import scatter as SC
    from pilosa_tpu_torch.probes import import_probe as IP
    from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

    main_w = 6 * WORDS_PER_SHARD  # the SSB path's stacked width
    bsi_w = 10 * WORDS_PER_SHARD  # the BSI path's stacked width

    # -- tape_count ---------------------------------------------------------
    tapes = [
        ((("or", 0, 0),), 1),  # the BSI aggregates' one-plane count
        ((("and", 0, 1),), 2),
        ((("andnot", 0, 1),), 2),  # the Percentile walk's low half
        ((("andnot", 1, 0),), 2),  # operands passed in tape order
        ((("xor", 1, 1),), 2),  # one leaf read twice
        ((("or", 0, 1), ("xor", 2, 0)), 2),
        ((("and", 0, 1), ("andnot", 3, 2)), 3),
        ((("and", 0, 1), ("or", 4, 2), ("andnot", 5, 3)), 4),
    ]
    # the edge-case index's one shard, and both main paths' widths
    for w in (1, 7, 512, WORDS_PER_SHARD, main_w, bsi_w):
        for tape, n_leaves in tapes:
            leaves = [_rand_words(rng, (w,), device) for _ in range(n_leaves)]
            mask = _rand_words(rng, (w,), device)
            for m in (None, mask):
                report.err("tape_count", B.tape_count(tape, leaves, m),
                           B.tape_count_plain(tape, leaves, m))
    # every path of the kernel: one-op tapes over one and two leaves (the
    # one-op path), 2-7 ops over 2 and 4 leaves and 32 leaves with 64 ops
    # (the general path); aligned leaves, row views of one 2-D tensor
    # (other offsets modulo 16 bytes at odd widths: 32-bit loads) and
    # leaves one word into their tensors (a peeled head); one launch a
    # count
    n_paths = 0
    for w in (1, 3, 4, 5, 7, (1 << 20) + 3):
        for n_leaves, n_ops in ((1, 1), (2, 1), (2, 2), (4, 4), (2, 7),
                                (32, 64)):
            tape = _random_tape(rng, n_leaves, n_ops)
            for layout in ("separate", "rows", "shifted"):
                if layout == "rows":
                    planes = list(_rand_words(rng, (n_leaves + 1, w), device))
                elif layout == "shifted":
                    planes = [_rand_words(rng, (w + 1,), device)[1:]
                              for _ in range(n_leaves + 1)]
                else:
                    planes = [_rand_words(rng, (w,), device)
                              for _ in range(n_leaves + 1)]
                for m in (None, planes[-1]):
                    before = B.tape_count_launches.n
                    got = B.tape_count(tape, planes[:n_leaves], m)
                    assert B.tape_count_launches.n == before + 1
                    report.err("tape_count", got, B.tape_count_plain(
                        tape, planes[:n_leaves], m))
                    n_paths += 1
    leaves = [_rand_words(rng, (main_w,), device) for _ in range(2)]
    tape = (("and", 0, 1),)  # Count(Intersect(Row, Row)) on the main path
    ms = _time_ms(lambda: B.tape_count(tape, leaves))
    plain_ms = _time_ms(lambda: B.tape_count_plain(tape, leaves))
    kern_ms = _device_ms(lambda: B.tape_count(tape, leaves), "tape_")
    traced = _device_ops(lambda: B.tape_count(tape, leaves), calls=100)
    _once_per_call(traced, 100, 1)
    ops = 1
    (op_name, (op_events, _)), = traced.items()
    flush = torch.empty(128 << 20, dtype=torch.int32, device=device)
    cold_ms = _device_ms(lambda: B.tape_count(tape, leaves), "tape_",
                         flush=flush)
    fl = LP.floor(probe_lib, leaves[0], leaves[1], flush=flush)
    del flush
    by_bytes = (2 * main_w * 4 + 4) / mem_rate * 1e3
    by_ops = main_w / popc_rate * 1e3
    report.kernel("tape_count", source="pilosa_tpu_torch/csrc/tape_count.cu",
                  replaces="pilosa_tpu/ops/bitmap.py:209", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None, shape=f"2 leaves x {main_w} words",
                  kernel_ms=kern_ms, kernel_ms_l2_flushed=cold_ms,
                  device_ops_per_call=ops, trace_events_of_100=op_events,
                  floor=fl)
    print(f"floor: an empty kernel {_fmt_ms(fl['empty_kernel_ms'])} of "
          f"device time; the launch probe's fastest count of popcount(a & b)"
          f" over the same 2x{main_w} words ({fl['threads']} threads, "
          f"{fl['vectors_per_thread']} vectors each, {fl['blocks']} blocks,"
          f" {fl['finish']}) {_fmt_ms(fl['read_kernel_ms'])}, "
          f"{_fmt_ms(fl['read_kernel_ms_l2_flushed'])} with L2 flushed "
          f"{report.label}")
    print(f"kernel tape_count: {n_paths} counts over the one-op path (16-byte"
          f" and 32-bit) and the general path equal their plain versions, "
          f"one launch each; {ops} device op per call ({op_name}: "
          f"{op_events} events in a trace of 100 calls)")
    print(f"kernel tape_count: 2x{main_w} words {ms:.4f} ms "
          f"(kernel alone {_fmt_ms(kern_ms)}, "
          f"{_fmt_ms(cold_ms)} with L2 flushed; plain {plain_ms:.4f} ms, "
          f"bound {max(by_bytes, by_ops):.4f} ms) {report.label}")

    # -- pair_counts --------------------------------------------------------
    # every regime of the plan (one row of A; both sides of at most 32
    # rows; more), each swapped, at every edge: widths below one 16-byte
    # load, odd widths (scalar loads), a slice past 32,768 words and the
    # main width
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else 132
    variants = set()
    for w in (1, 7, 1000, 32768 + 3, main_w):
        for r1 in (1, 2, 3, 8, 9, 16, 130):
            for r2 in (1, 20, 40, 127, 128, 129, 300):
                a = _rand_words(rng, (r1, w), device)
                b = _rand_words(rng, (r2, w), device)
                variants.add(G._plan(r1, r2, w, True, sms).variant)
                report.err("pair_counts", G.pair_counts(a, b),
                           G.pair_counts_plain(a, b))
    assert variants == {"row", "narrow", "wide"}, variants
    # views 1-3 rows into a stack at odd widths: not 16-byte aligned
    for off in (1, 2, 3):
        for r1, r2, w in ((2, 20, 1001), (1, 129, 32768 + 3), (8, 40, 7),
                          (40, 8, 1003), (2, 20, bsi_w + 1)):
            sa = _rand_words(rng, (r1 + off, w), device)
            sb = _rand_words(rng, (r2 + off, w), device)
            report.err("pair_counts", G.pair_counts(sa[off:], sb[off:]),
                       G.pair_counts_plain(sa[off:], sb[off:]))
    # saturation: all-ones rows at the BSI path's width, 32 * w per count
    for r1, r2 in ((2, 20), (1, 256), (8, 40), (40, 8)):
        ones = torch.full((max(r1, r2), bsi_w), -1, dtype=torch.int32,
                          device=device)
        report.err("pair_counts", G.pair_counts(ones[:r1], ones[:r2]),
                   torch.full((r1, r2), 32 * bsi_w, dtype=torch.int32,
                              device=device))
        del ones
    zeros = torch.zeros((4, 512), dtype=torch.int32, device=device)
    report.err("pair_counts", G.pair_counts(
        torch.full((4, 512), -1, dtype=torch.int32, device=device), zeros),
        torch.zeros((4, 4), dtype=torch.int32, device=device))
    # the four main-path shapes: the kernel alone (profiler) and the call
    # (wrapper included), beside the bound: the larger of the bytes at the
    # memory rate and 2 ops per bit pair at the int8 tensor-core peak
    shapes = {"GroupBy": (8, 256, main_w), "TopN": (1, 256, main_w),
              "Sum": (2, 20, bsi_w), "GroupBy-Sum": (256, 40, main_w)}
    pc = {}
    for name, (r1, r2, w) in shapes.items():
        a = _rand_words(rng, (r1, w), device)
        b = _rand_words(rng, (r2, w), device)
        if name == "Sum":  # the magnitude planes are a view of the stack
            b = _rand_words(rng, (r2 + 2, w), device)[2:]
        plan = G._plan(r1, r2, w, a.data_ptr() % 16 == 0
                       and b.data_ptr() % 16 == 0, sms)
        report.err("pair_counts", G.pair_counts(a, b),
                   G.pair_counts_plain(a, b))
        ms = _time_ms(lambda: G.pair_counts(a, b))
        kern_ms = _device_ms(lambda: G.pair_counts(a, b), "pc_")
        plain_ms = _time_ms(lambda: G.pair_counts_plain(a, b), reps=2,
                            trials=5) if name == "GroupBy" else None
        by_bytes = ((r1 + r2) * w * 4 + r1 * r2 * 4) / mem_rate * 1e3
        by_ops = 2 * r1 * r2 * w * 32 / int8_rate * 1e3
        pc[name] = {"shape": f"{r1}x{r2}x{w}", "variant": plan.variant,
                    "swap": plan.swap, "tile": f"{plan.ta}x{plan.tb}",
                    "blocks": plan.blocks, "ms": ms, "kernel_ms": kern_ms,
                    "bound_ms": max(by_bytes, by_ops),
                    "bound_by": "bytes" if by_bytes >= by_ops
                    else "operations"}
        print(f"kernel pair_counts: {name} {r1}x{r2}x{w} words, variant "
              f"{plan.variant}{' (swapped)' if plan.swap else ''}, tile "
              f"{plan.ta}x{plan.tb}, {plan.blocks} blocks: call "
              f"{ms:.4f} ms, kernel alone {_fmt_ms(kern_ms)}"
              + (f", plain {plain_ms:.4f} ms" if plain_ms else "")
              + f", bytes bound {by_bytes:.4f} ms, int8 bound "
              f"{by_ops:.4f} ms {report.label}")
        if plain_ms:
            pc[name]["plain_ms"] = plain_ms
    main = pc["GroupBy"]
    report.kernel("pair_counts",
                  source="pilosa_tpu_torch/csrc/pair_counts.cu",
                  replaces="pilosa_tpu/ops/groupby.py:98", ms=main["ms"],
                  plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                  bound_by=main["bound_by"], library_ms=None,
                  shape=main["shape"], kernel_ms=main["kernel_ms"],
                  variant=main["variant"], shapes=pc)

    # -- scatter_merge ------------------------------------------------------
    # edges: one update, ragged heads and tails (views 1-3 updates into
    # their tensors), addresses and masks at different offsets modulo 16
    # bytes (32-bit loads), addresses outside the flat (dropped)
    for n, m in ((512, 1), (1024, 300), (32768, 5000), (32768, 32768)):
        for off_a, off_k in ((0, 0), (1, 1), (3, 3), (1, 2)):
            flat = _rand_words(rng, (n,), device)
            addr_np = np.sort(rng.choice(n, size=m, replace=False)).astype(
                np.int32)
            if m > 8:
                addr_np[-2:] = (n, -5)  # dropped
            addr = torch.from_numpy(np.r_[np.zeros(off_a, np.int32),
                                          addr_np]).to(device)[off_a:]
            masks = _rand_words(rng, (m + off_k,), device)[off_k:]
            f_k, f_p = flat.clone(), flat.clone()
            before = SC.scatter_merge_launches.n
            report.err("scatter_merge", SC.scatter_merge_(f_k, addr, masks),
                       SC.scatter_merge_plain(f_p, addr, masks))
            assert SC.scatter_merge_launches.n == before + 1
            report.err("scatter_merge", f_k, f_p)
    # the old shape: one shard's _exists row, every word touched
    n = m = WORDS_PER_SHARD
    flat = torch.zeros(n, dtype=torch.int32, device=device)
    addr = torch.arange(n, dtype=torch.int32, device=device)
    masks = torch.full((n,), -1, dtype=torch.int32, device=device)
    old_ms = _time_ms(lambda: SC.scatter_merge_(flat, addr, masks))
    old_kern = _device_ms(lambda: SC.scatter_merge_(flat, addr, masks),
                          "scatter_merge")
    old_bound = (16 * m + 4) / mem_rate * 1e3
    old = {"shape": f"{m} updates into {n} words", "ms": old_ms,
           "kernel_ms": old_kern, "bound_ms": old_bound}
    print(f"kernel scatter_merge: the old shape, {m} updates into {n} words "
          f"{old_ms:.4f} ms (kernel alone {_fmt_ms(old_kern)}, bytes bound "
          f"{old_bound:.4f} ms) {report.label}")
    # config 1's shape: the first city batch of BASELINE.json config 1 on
    # its packed flat of touched tiles, as ops/scatter.py stages it
    city, _ = IP.config1_data()
    rows, cols = city[:IP.C1_BATCH], np.arange(IP.C1_BATCH)
    a64, masks_np = SC.sort_updates(rows, cols, WORDS_PER_SHARD)
    t = SC._tile_words(1024 * WORDS_PER_SHARD)
    which, packed, _ = SC.pack_tiles(a64, t)
    n, m = which.size * t, a64.size
    flat = _rand_words(rng, (n,), device)
    addr = torch.from_numpy(packed.astype(np.int32)).to(device)
    masks = torch.from_numpy(masks_np.view(np.int32)).to(device)
    f_k, f_p = flat.clone(), flat.clone()
    report.err("scatter_merge", SC.scatter_merge_(f_k, addr, masks),
               SC.scatter_merge_plain(f_p, addr, masks))
    report.err("scatter_merge", f_k, f_p)
    ms = _time_ms(lambda: SC.scatter_merge_(flat, addr, masks))
    plain_ms = _time_ms(lambda: SC.scatter_merge_plain(flat, addr, masks))
    kern_ms = _device_ms(lambda: SC.scatter_merge_(flat, addr, masks),
                         "scatter_merge")
    traced = _device_ops(lambda: SC.scatter_merge_(flat, addr, masks),
                         calls=100)
    _once_per_call(traced, 100, 1)
    (op_name, (op_events, op_ms)), = traced.items()
    if kern_ms is None:  # the summary lost it: the trace's own events
        kern_ms = op_ms
    rates = IP.copy_rates(device)
    up = (n + 4 + 2 * (-(-m // 4) * 4)) * 4  # the staged tiles and updates
    down = (n + 1) * 4  # the merged tiles and the count
    pcie_ms = up / rates[f"h2d pinned {16 << 20}"]["GB_per_s"] / 1e6 \
        + down / rates[f"d2h pinned {16 << 20}"]["GB_per_s"] / 1e6
    by_bytes = (16 * m + 4) / mem_rate * 1e3
    by_ops = m / popc_rate * 1e3
    report.kernel("scatter_merge",
                  source="pilosa_tpu_torch/csrc/scatter_merge.cu",
                  replaces="pilosa_tpu/ops/scatter.py:91", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None,
                  shape=f"config-1 city batch: {m} updates into {which.size} "
                        f"packed tiles of {t} words",
                  kernel_ms=kern_ms, device_ops_per_call=1,
                  trace_events_of_100=op_events, pcie_bytes_up=up,
                  pcie_bytes_down=down, pcie_bound_ms=pcie_ms,
                  pinned_rates_gb_s={k: v["GB_per_s"]
                                     for k, v in rates.items()},
                  old_shape=old)
    print(f"kernel scatter_merge: config-1 city batch, {m} updates into "
          f"{which.size} packed tiles of {t} words ({n} words): {ms:.4f} ms "
          f"(kernel alone {_fmt_ms(kern_ms)}, one device op per call: "
          f"{op_name} {op_events} events in a trace of 100 calls; plain "
          f"{plain_ms:.4f} ms); bound on the card {max(by_bytes, by_ops):.4f}"
          f" ms ({16 * m + 4} B at {mem_rate / 1e12:.2f} TB/s); over PCIe "
          f"{up} B up and {down} B down at the measured pinned rates "
          f"{pcie_ms:.4f} ms {report.label}")

    # -- bsi_compare --------------------------------------------------------
    for depth in (1, 20, 64):
        top = 1 << depth
        mid = int(rng.integers(1, min(top, 1 << 62)))
        consts = [(-mid, None), (-1, None), (0, None), (mid, None),
                  (top, None), (-top - 5, None)]
        pairs = [(-mid, mid), (mid, -mid), (0, 0), (-top, top), (5, 4)]
        for w in (1, 7, 512, 1000, bsi_w):
            planes = _rand_words(rng, (S.OFFSET + depth, w), device)
            for op in (S.EQ, S.NE, S.LT, S.LE, S.GT, S.GE, S.BETWEEN):
                for c, c2 in (pairs if op == S.BETWEEN else consts):
                    report.err("bsi_compare",
                               S.bsi_compare(planes, op, c, c2),
                               S.bsi_compare_plain(planes, op, c, c2))
    planes = _rand_words(rng, (S.OFFSET + 20, bsi_w), device)
    ms = _time_ms(lambda: S.bsi_compare(planes, S.GT, 524288))
    plain_ms = _time_ms(lambda: S.bsi_compare_plain(planes, S.GT, 524288),
                        reps=3, trials=5)
    kern_ms = _device_ms(lambda: S.bsi_compare(planes, S.GT, 524288),
                         "bsi_compare")
    by_bytes = (22 + 1) * bsi_w * 4 / mem_rate * 1e3
    # per word: two sign-class masks, six logic ops per plane (3 per
    # class), the overflow/sign selection and the op
    by_ops = (2 + 6 * 20 + 4) * bsi_w / lop_rate * 1e3
    report.kernel("bsi_compare", source="pilosa_tpu_torch/csrc/bsi_compare.cu",
                  replaces="pilosa_tpu/ops/bsi.py:138", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None, shape=f"GT over 22 x {bsi_w} words",
                  ops_bound_ms=by_ops, kernel_ms=kern_ms)
    print(f"kernel bsi_compare: GT over 22x{bsi_w} words {ms:.4f} ms "
          f"(kernel alone {_fmt_ms(kern_ms)}, plain {plain_ms:.4f} ms, bytes "
          f"bound {by_bytes:.4f} ms, logic bound {by_ops:.4f} ms) "
          f"{report.label}")

    # -- ctile_count --------------------------------------------------------
    def entries(p, t, rows, n_tiles):
        payload = _rand_words(rng, (p, t), device)
        payload[0] = -1  # an all-ones tile
        if p > 1:
            payload[1] = 0  # an all-zero tile
        prow_np = rng.integers(0, rows + 3, p).astype(np.int32)
        prow_np[-1] = rows  # a padded entry points one past the last row
        prow = torch.from_numpy(prow_np).to(device)
        ptile = torch.from_numpy(
            rng.integers(0, n_tiles, p).astype(np.int32)).to(device)
        filt = _rand_words(rng, (n_tiles, t), device)
        filt[0], filt[1] = -1, 0
        pick = rng.integers(0, 4, (rows, n_tiles))
        const = np.where(pick == 0, rng.integers(0, 1 << 32, pick.shape,
                                                 dtype=np.uint32),
                         np.where(pick == 1, 0xFFFFFFFF, 0)).astype(np.uint32)
        const = torch.from_numpy(const.view(np.int32)).to(device)
        return payload, prow, ptile, filt, const

    for t in (8, 64, 512):
        for p in (8, 1000, 4096):
            payload, prow, ptile, filt, const = entries(p, t, 37, 11)
            for f in (None, filt):
                for k in (torch.zeros_like(const), const):
                    report.err("ctile_count",
                               C.ctile_count(payload, prow, ptile, k, f),
                               C.ctile_count_plain(payload, prow, ptile, k, f))
    # the stack route: 1, 10 and more blocks than one launch takes, at
    # T = 8, 64 and 512 (a ragged last tile), zero, all-ones and
    # non-uniform constants, one launch per MAX_BLOCKS blocks
    n_stacks = 0
    for width in (8, 64, 3 * 512 + 100):
        for n in (1, 10, C.MAX_BLOCKS + 1, 2 * C.MAX_BLOCKS + 3):
            blocks = _compressed_blocks(rng, n, width, device)
            filt = _rand_words(rng, (width,), device)
            for f in (None, filt):
                before = C.ctile_count_launches.n
                got = C.ctile_count_blocks(blocks, f)
                assert C.ctile_count_launches.n == before + -(
                    -n // C.MAX_BLOCKS)
                report.err("ctile_count", got,
                           C.ctile_count_blocks_plain(blocks, f))
                n_stacks += 1
    # filter tiles one word into their tensor: the scalar loop
    big = _rand_words(rng, (4 * 512 + 1,), device)
    blocks = _compressed_blocks(rng, 3, 4 * 512, device)
    report.err("ctile_count", C.ctile_count_blocks(blocks, big[1:]),
               C.ctile_count_blocks_plain(blocks, big[1:]))
    print(f"kernel ctile_count: {n_stacks + 1} stacks of 1 to "
          f"{2 * C.MAX_BLOCKS + 3} compressed blocks equal their plain "
          f"versions, one launch per {C.MAX_BLOCKS} blocks")
    # path 3's blocks: 256 rows x 384 tiles of 512 words, 512 payload
    # entries, constants mostly zero with a few all-ones runs, filtered
    # TopN, through the stack route (the block's own list of non-zero
    # constants)
    rows, n_tiles, t, p = 256, 384, 512, 512
    payload = _rand_words(rng, (p, t), device)
    prow = torch.from_numpy(np.sort(rng.integers(0, rows, p)).astype(
        np.int32)).to(device)
    ptile_np = rng.integers(0, n_tiles, p).astype(np.int32)
    ptile = torch.from_numpy(ptile_np).to(device)
    filt = _rand_words(rng, (n_tiles, t), device)
    runs = rng.random((rows, n_tiles)) < 0.01
    const = torch.from_numpy(np.where(runs, -1, 0).astype(np.int32)).to(device)
    for f in (None, filt):
        report.err("ctile_count",
                   C.ctile_count(payload, prow, ptile, const, f),
                   C.ctile_count_plain(payload, prow, ptile, const, f))
    blk = C.CompressedBlock.from_parts(payload, prow, ptile, const)
    for f in (None, filt):
        report.err("ctile_count", C.ctile_count_blocks([blk], f),
                   C.ctile_count_plain(payload, prow, ptile, const, f))
    ms = _time_ms(lambda: C.ctile_count_blocks([blk], filt))
    plain_ms = _time_ms(
        lambda: C.ctile_count_plain(payload, prow, ptile, const, filt))
    kern_ms = _device_ms(lambda: C.ctile_count_blocks([blk], filt),
                         "ctile_count")
    unf_ms = _time_ms(lambda: C.ctile_count_blocks([blk]))
    # each input read once: the payload, the filter tiles that entries or
    # runs name, the index arrays and the list of non-zero constants; the
    # output written once. One __popc per payload word and per run-tile
    # word.
    n_runs = int(runs.sum())
    used_tiles = np.unique(np.r_[ptile_np, np.nonzero(runs)[1]]).size
    fixed = 8 * p + 12 * n_runs + 4 * rows
    by_bytes = ((p + used_tiles) * t * 4 + fixed) / mem_rate * 1e3
    by_ops = (p + n_runs) * t / popc_rate * 1e3
    unf_bound = max((p * t * 4 + fixed) / mem_rate * 1e3,
                    p * t / popc_rate * 1e3)
    report.kernel("ctile_count", source="pilosa_tpu_torch/csrc/ctile_count.cu",
                  replaces="pilosa_tpu/ops/ctiles.py:291", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None,
                  shape=f"{p} entries x {t} words + {n_runs} non-zero of "
                        f"{rows} x {n_tiles} constants, filtered, {rows} rows",
                  kernel_ms=kern_ms, unfiltered_ms=unf_ms,
                  unfiltered_bound_ms=unf_bound)
    print(f"kernel ctile_count: {p}x{t} words + {n_runs} non-zero of "
          f"{rows}x{n_tiles} constants filtered into {rows} rows {ms:.4f} ms "
          f"(kernel alone {_fmt_ms(kern_ms)}, plain "
          f"{plain_ms:.4f} ms, bytes bound {by_bytes:.4f} ms, popc bound "
          f"{by_ops:.4f} ms; unfiltered {unf_ms:.4f} ms, bound "
          f"{unf_bound:.4f} ms) {report.label}")
    torch.cuda.synchronize()
    print("library_ms: null for every kernel: PyTorch has no popcount op, "
          "no bit-sliced compare and no scatter that ORs (scatter_reduce "
          "takes sum, prod, mean, amax or amin), so no single PyTorch call "
          "computes any of these functions")


def _compressed_blocks(rng, n: int, width: int, device, rows: int = 16):
    """``n`` compressed blocks of ``width`` words, built as
    ``ops/ctiles.py`` builds them under the auto rule: ``rows`` rows of
    zero, all-ones and non-uniform constant tiles and a few dense tiles
    of random bits, then zero rows up to the rule's least block size
    (``MIN_BYTES``); the last block empty."""
    import numpy as np

    from pilosa_tpu_torch.ops import ctiles as C

    t = C.tile_words(width)
    n_tiles = -(-width // t)
    scale = max(1, -(-C.MIN_BYTES // (rows * width * 4)))
    out = []
    for k in range(n):
        host = np.zeros((rows * scale, n_tiles * t), dtype=np.uint32)
        pick = rng.integers(0, 12, (rows, n_tiles))
        for r, j in zip(*np.nonzero(pick < 3)):
            tile = host[r, j * t:(j + 1) * t]
            if pick[r, j] == 0:
                tile[:] = 0xFFFFFFFF
            elif pick[r, j] == 1:
                tile[:] = rng.integers(1, 1 << 32, dtype=np.uint32)
            else:
                tile[:] = rng.integers(0, 1 << 32, t, dtype=np.uint32)
        if k == n - 1:
            host[:] = 0
        cb = C.maybe_compress(np.ascontiguousarray(host[:, :width]), device)
        assert cb is not None, "a test block stayed dense"
        out.append(cb)
    return out


def phase_main_path(report: Report, args) -> dict:
    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core.stacked import stacked_set
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.ops import topk as T
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(args.seed)
    shards, years, brands = args.shards, 7, 1000
    if shards != 6:
        print(f"reduced: {shards} shards instead of 6")
    n = shards * SHARD_WIDTH
    year_of = rng.integers(0, years, n)
    brand_of = rng.integers(0, brands, n)
    names = np.array([f"MFGR#{1000 + b}" for b in range(brands)])
    cols = np.arange(n, dtype=np.int64)

    KU.reset_launches()
    t0 = time.perf_counter()
    api = API()
    api.create_index("ssb")
    api.create_field("ssb", "year", {"type": "mutex"})
    api.create_field("ssb", "brand", {"type": "mutex", "keys": True})
    api.import_bits("ssb", "year", rows=year_of, cols=cols)
    api.import_bits("ssb", "brand", cols=cols, row_keys=names[brand_of])
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0

    q = "GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)"
    counts_q = {
        'Count(Intersect(Row(year=1), Row(brand="MFGR#1003")))':
            (year_of == 1) & (brand_of == 3),
        'Count(Union(Row(year=2), Row(brand="MFGR#1500")))':
            (year_of == 2) | (brand_of == 500),
        'Count(Difference(Row(year=3), Row(brand="MFGR#1007")))':
            (year_of == 3) & (brand_of != 7),
        "Count(Xor(Row(year=4), Row(year=5)))":
            (year_of == 4) ^ (year_of == 5),
        "Count(Not(Row(year=0)))": year_of != 0,
        "Count(All())": np.ones(n, dtype=bool),
        # 40 leaves: over the kernel's 32, so the plane terminal reduces
        # sub-trees first and one tape_count launch counts
        "Count(Union(" + ", ".join(f'Row(brand="MFGR#{1000 + b}")'
                                   for b in range(40)) + "))":
            brand_of < 40,
    }
    t0 = time.perf_counter()
    groups, top = api.query("ssb", q)  # builds the year and brand stacks
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got_counts = {cq: api.query("ssb", cq)[0] for cq in counts_q}
    filtered_top = api.query("ssb", "TopN(brand, Row(year=3), n=5)")[0]
    torch.cuda.synchronize()
    launched = KU.launches()

    # -- oracle ---------------------------------------------------------------
    fb = api.holder.index("ssb").field("brand")
    table = np.bincount(year_of * brands + brand_of,
                        minlength=years * brands).reshape(years, brands)
    bid = {b: fb.translate.key_to_id[names[b]] for b in range(brands)}
    want_groups = sorted(((y, bid[b], int(table[y, b]))
                          for y in range(years) for b in range(brands)
                          if table[y, b]))[:100]
    got_groups = [(g.group[0].row_id, bid[int(g.group[1].row_key[5:]) - 1000],
                   g.count) for g in groups]
    assert got_groups == want_groups, "GroupBy disagrees with the oracle"

    def want_top(counts, k):
        ranked = sorted(((-int(c), bid[b], names[b])
                         for b, c in enumerate(counts) if c))[:k]
        return [(key, -c) for c, _, key in ranked]

    assert [(p.key, p.count) for p in top.pairs] == want_top(
        np.bincount(brand_of, minlength=brands), 10), "TopN disagrees"
    assert [(p.key, p.count) for p in filtered_top.pairs] == want_top(
        np.bincount(brand_of[year_of == 3], minlength=brands), 5), \
        "filtered TopN disagrees"
    for cq, sel in counts_q.items():
        assert got_counts[cq] == int(sel.sum()), f"{cq} disagrees"

    idx = api.holder.index("ssb")
    for fname in ("year", "brand", "_exists"):
        s = stacked_set(idx.field(fname), list(range(shards)), "standard")
        assert all(b.is_cuda for _, b in s.iter_blocks()), \
            f"{fname} stack is not on the card"
    st = stacked_set(fb, list(range(shards)), "standard")
    if shards == 6:
        assert st.n_blocks == 4, f"brand stack has {st.n_blocks} blocks"
    report.launched("ssb", launched,
                    ("tape_count", "pair_counts", "scatter_merge"))

    p50 = statistics.median(_wall_ms(lambda: api.query("ssb", q))
                            for _ in range(11))
    count_p50 = statistics.median(
        _wall_ms(lambda: api.query("ssb", next(iter(counts_q))))
        for _ in range(11))
    # device time of the GroupBy+TopN query's own launches, on its own
    # resident blocks: the rest of the p50 is host work and copies
    year_blk = stacked_set(idx.field("year"), list(range(shards)),
                           "standard").planes

    def query_kernels():
        for _, b in st.iter_blocks():
            G.pair_counts(year_blk, b)
        for _, b in st.iter_blocks():
            T.row_counts(b)

    kern_ms = _time_ms(query_kernels, reps=3, trials=5)
    pc_ms = _device_ms(query_kernels, "pc_", calls=5)
    busy_ms = _device_ms(lambda: api.query("ssb", q), calls=11)
    decide_s, classify_s = _compress_decision_s(st._ensure_block(0))
    print(f"main path: first query (builds the year and brand stacks) "
          f"{first_s:.3f} s; on one {st.block_rows}-row brand block the "
          f"compress decision (stays dense) takes {decide_s:.3f} s, a full "
          f"classify with the payload gathered {classify_s:.3f} s "
          f"{report.label}")
    print(f"main path: the GroupBy+TopN query's {2 * st.n_blocks} "
          f"pair_counts launches take {kern_ms:.3f} ms back to back "
          f"({100 * kern_ms / p50:.1f}% of its p50), "
          f"{_fmt_ms(pc_ms)} of kernel time in a profiler trace; the query "
          f"keeps the card busy {_fmt_ms(busy_ms)} {report.label}")
    print(f"main path: {n} columns, {years} years x {brands} brands; "
          f"import {import_s:.3f} s; brand blocks {st.n_blocks} of "
          f"{st.block_rows} rows; device bytes allocated "
          f"{torch.cuda.memory_allocated()}; launches {launched} "
          f"{report.label}")
    print(f"main path: p50 of the GroupBy+TopN query {p50:.3f} ms; p50 of "
          f"Count(Intersect) {count_p50:.3f} ms {report.label}")
    print("main path: every answer matches the numpy oracle")
    # path 16 holds its cluster to these single-node answers and p50
    report.notes["ssb_p50_ms"] = p50
    report.notes["ssb_single"] = {cq: api.query("ssb", cq)
                                  for cq in CL_SSB_QUERIES}
    return {"api": api, "year_of": year_of, "brand_of": brand_of,
            "names": names, "bid": bid}


def _compress_decision_s(blk):
    """Host seconds of the auto rule's decision on a dense resident
    block (classification up to the ratio rule, which keeps it dense),
    and of a full ``classify`` of it, payload gathered, for scale."""
    from pilosa_tpu_torch import platform
    from pilosa_tpu_torch.ops import ctiles as C

    host = platform.d2h(blk)
    t0 = time.perf_counter()
    assert C.maybe_compress(host, blk.device) is None, \
        "a dense resident block compresses under the auto rule"
    decide_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    C.classify(host)
    return decide_s, time.perf_counter() - t0


def _percentile_oracle(sorted_vals, nth: float):
    """(value, count) at percentile ``nth`` by the JAX package's rank rule
    (pilosa_tpu/ops/bsi.py:491-496): rank = ceil(nth/100 * total) in
    integers, clipped to [1, total], counted from the smallest value."""
    total = sorted_vals.size
    x100 = round(nth * 100)
    q, rem = divmod(total, 10000)
    rank = min(max(x100 * q + (x100 * rem + 9999) // 10000, 1), total)
    v = int(sorted_vals[rank - 1])
    return v, int((sorted_vals == v).sum())


def phase_bsi_path(report: Report, args, shards: int = 10) -> dict:
    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core.stacked import stacked_bsi
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(args.seed)
    n = shards * SHARD_WIDTH
    amount = rng.integers(0, 1 << 20, n)
    cols = np.arange(n, dtype=np.int64)

    KU.reset_launches()
    t0 = time.perf_counter()
    api = API()
    api.create_index("b")
    api.create_field("b", "amount", {"type": "int"})
    api.import_values("b", "amount", cols=cols, values=amount)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0

    half = 524288
    v = int(amount[12345])
    sum_q = f"Sum(Row(amount > {half}), field=amount)"
    counts_q = {
        f"Count(Row(amount > {half}))": amount > half,
        "Count(Row(1000 <= amount <= 2000))":
            (amount >= 1000) & (amount <= 2000),
        f"Count(Row(amount == {v}))": amount == v,
        f"Count(Row(amount != {v}))": amount != v,
        "Count(Row(amount < 100))": amount < 100,
    }
    t0 = time.perf_counter()
    got_sum = api.query("b", sum_q)[0]  # builds the BSI stack
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got_counts = {q: api.query("b", q)[0] for q in counts_q}
    got_min = api.query("b", "Min(field=amount)")[0]
    got_max = api.query("b", f"Max(Row(amount < {half}), field=amount)")[0]
    got_pct = {nth: api.query("b", f"Percentile(field=amount, nth={nth})")[0]
               for nth in (50, 99)}
    sort_q = "Sort(Row(amount > 1048000), field=amount, limit=10)"
    got_sort = api.query("b", sort_q)[0]
    probe = [12345, n - 1, n + 5]  # the last is past every shard
    got_fv = [api.query("b", f"FieldValue(field=amount, column={c})")[0]
              for c in probe]
    torch.cuda.synchronize()
    launched = KU.launches()

    # -- oracle ---------------------------------------------------------------
    big = amount[amount > half]
    assert (got_sum.val, got_sum.count) == (int(big.sum()), big.size), \
        f"{sum_q} disagrees: {got_sum}"
    for q, sel in counts_q.items():
        assert got_counts[q] == int(sel.sum()), f"{q} disagrees"
    lo = int(amount.min())
    assert (got_min.val, got_min.count) == (lo, int((amount == lo).sum())), \
        "Min disagrees"
    below = amount[amount < half]
    hi = int(below.max())
    assert (got_max.val, got_max.count) == (hi, int((below == hi).sum())), \
        "filtered Max disagrees"
    ordered = np.sort(amount)
    for nth, got in got_pct.items():
        assert (got.val, got.count) == _percentile_oracle(ordered, nth), \
            f"Percentile nth={nth} disagrees"
    top = np.nonzero(amount > 1048000)[0]
    top = top[np.lexsort((top, amount[top]))][:10]
    assert (got_sort.columns, got_sort.values) == (
        top.tolist(), amount[top].tolist()), f"{sort_q} disagrees"
    assert [(r.val, r.count) for r in got_fv] == [
        (int(amount[12345]), 1), (int(amount[n - 1]), 1), (None, 0)], \
        "FieldValue disagrees"

    field = api.holder.index("b").field("amount")
    st = stacked_bsi(field, list(range(shards)))
    assert st.depth == 20, f"stack depth {st.depth}"
    assert st.planes.is_cuda and st.planes.shape == (22, n // 32)
    report.launched("bsi", launched, ("tape_count", "pair_counts",
                                      "scatter_merge", "bsi_compare"))

    p50 = statistics.median(_wall_ms(lambda: api.query("b", sum_q))
                            for _ in range(11))

    def sum_kernels():  # the Sum query's device work on its resident stack
        filt = st.compare(S.GT, half)
        S.bsi_plane_popcounts(st.planes, filt)

    kern_ms = _time_ms(sum_kernels, reps=5, trials=7)
    busy_ms = _device_ms(lambda: api.query("b", sum_q), calls=11)
    decide_s, classify_s = _compress_decision_s(st.planes)
    print(f"bsi path: first query (builds the BSI stack) {first_s:.3f} s; "
          f"the stack's compress decision (stays dense) takes "
          f"{decide_s:.3f} s, a full classify with the payload gathered "
          f"{classify_s:.3f} s {report.label}")
    print(f"bsi path: {n} columns, depth {st.depth}; import {import_s:.3f} s; "
          f"BSI stack bytes {st.planes.numel() * 4}; device bytes allocated "
          f"{torch.cuda.memory_allocated()} (earlier paths' stacks "
          f"included); launches {launched} {report.label}")
    print(f"bsi path: p50 of {sum_q} {p50:.3f} ms; its device work "
          f"(bsi_compare, sign masks, pair_counts, tape_count) {kern_ms:.4f} "
          f"ms, {100 * kern_ms / p50:.1f}% of the p50; device busy per query "
          f"in a profiler trace {_fmt_ms(busy_ms)} {report.label}")
    _bsi_edge_cases(report, API)
    print("bsi path: every answer matches the numpy oracle")
    return {"api": api, "amount": amount, "shards": shards}


def _bsi_edge_cases(report: Report, API) -> None:
    """One shard: negative values with a base, a decimal field, GroupBy
    Sum aggregates over one, two and three fields (the last folds),
    Sort, Extract and FieldValue, against numpy; then the kernels at this
    index's shapes against their plain versions."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.core.stacked import stacked_bsi, stacked_set
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    KU.reset_launches()
    rng = np.random.default_rng(17)
    n = SHARD_WIDTH
    cols = np.arange(n, dtype=np.int64)
    m = rng.integers(0, 5, n)
    g = rng.integers(0, 3, n)
    base = -250
    v = rng.integers(-30000, 30000, n)
    d_stored = rng.integers(-10 ** 6, 10 ** 6, n)
    api = API()
    api.create_index("e")
    api.create_field("e", "m", {"type": "mutex"})
    api.create_field("e", "g", {"type": "mutex"})
    api.create_field("e", "v", {"type": "int", "base": base})
    api.create_field("e", "d", {"type": "decimal", "scale": 2})
    api.import_bits("e", "m", rows=m, cols=cols)
    api.import_bits("e", "g", rows=g, cols=cols)
    api.import_values("e", "v", cols=cols, values=v)
    api.import_values("e", "d", cols=cols, values=d_stored / 100)
    # a set field: one of 4 rows on most columns, a second on some
    t_rows = np.zeros((4, n), dtype=bool)
    first = rng.random(n) < 0.9
    t_rows[rng.integers(0, 4, n)[first], cols[first]] = True
    second = rng.random(n) < 0.2
    t_rows[rng.integers(0, 4, n)[second], cols[second]] = True
    tr, tc = np.nonzero(t_rows)
    api.create_field("e", "t")
    api.import_bits("e", "t", rows=tr, cols=tc)

    stored = v - base  # GroupBy's agg is the raw stored sum
    got = api.query("e", "GroupBy(Rows(m), aggregate=Sum(field=v))")[0]
    want = [(r, int((m == r).sum()), int(stored[m == r].sum()))
            for r in range(5)]
    assert [(x.group[0].row_id, x.count, x.agg) for x in got] == want, \
        "1-field GroupBy Sum disagrees"
    got = api.query("e", "GroupBy(Rows(m), Rows(g), aggregate=Sum(field=v))")[0]
    want = [(a, b, int(((m == a) & (g == b)).sum()),
             int(stored[(m == a) & (g == b)].sum()))
            for a in range(5) for b in range(3)]
    assert [(x.group[0].row_id, x.group[1].row_id, x.count, x.agg)
            for x in got] == want, "2-field GroupBy Sum disagrees"
    before = KU.launches()["pair_counts"]
    got = api.query("e", "GroupBy(Rows(m), Rows(g), Rows(t), "
                         "aggregate=Sum(field=v))")[0]
    assert KU.launches()["pair_counts"] - before >= 3, "the fold's launches"
    want = []
    for a in range(5):
        for b in range(3):
            for r in range(4):
                sel = (m == a) & (g == b) & t_rows[r]
                if sel.any():
                    want.append((a, b, r, int(sel.sum()),
                                 int(stored[sel].sum())))
    assert [(x.group[0].row_id, x.group[1].row_id, x.group[2].row_id,
             x.count, x.agg) for x in got] == want, "3-field GroupBy Sum"
    assert any(w[4] < 0 for w in want), "no negative group sum"

    def order(sel, key, desc=False, limit=None):
        ids = np.nonzero(sel)[0]
        ids = ids[np.lexsort((ids, key[ids]))]
        return (ids[::-1] if desc else ids)[:limit]

    d_val = d_stored / 100
    for q, ids, vals in (
            ("Sort(Row(v > 29000), field=v)", order(v > 29000, v), v),
            ("Sort(Row(v > 29000), field=v, sort-desc=true, limit=100)",
             order(v > 29000, v, desc=True, limit=100), v),
            ("Sort(Row(-100 <= v <= 100), field=d, limit=50)",
             order((v >= -100) & (v <= 100), d_stored, limit=50), d_val)):
        r = api.query("e", q)[0]
        assert (r.columns, r.values) == (ids.tolist(),
                                         vals[ids].tolist()), q
    ext = api.query("e", "Extract(Row(v > 29900), Rows(v), Rows(d), "
                         "Rows(t), Rows(m))")[0]
    ids = np.nonzero(v > 29900)[0]
    assert [(c.column, c.rows) for c in ext.columns] == [
        (int(c), [int(v[c]), float(d_val[c]),
                  np.nonzero(t_rows[:, c])[0].tolist(), [int(m[c])]])
        for c in ids], "Extract disagrees"
    for c, want in ((77, (int(v[77]), 1)), (n + 3, (None, 0))):
        r = api.query("e", f"FieldValue(field=v, column={c})")[0]
        assert (r.val, r.count) == want, f"FieldValue column {c}"
    r = api.query("e", "FieldValue(field=d, column=5)")[0]
    assert (r.val, r.count) == (float(d_val[5]), 1), "FieldValue of d"

    neg = v[v < 0]
    checks = {
        "Min(field=v)": (int(v.min()), int((v == v.min()).sum())),
        "Max(Row(v < 0), field=v)": (int(neg.max()),
                                     int((neg == neg.max()).sum())),
        "Percentile(field=v, nth=10)": _percentile_oracle(np.sort(v), 10),
        "Sum(Row(m=2), field=v)": (int(v[m == 2].sum()), int((m == 2).sum())),
        "Sum(field=d)": (int(d_stored.sum()) / 100, n),
    }
    for q, want in checks.items():
        r = api.query("e", q)[0]
        assert (r.val, r.count) == want, f"{q}: {r} != {want}"
    torch.cuda.synchronize()
    report.launched("bsi_small", KU.launches(),
                    ("pair_counts", "bsi_compare", "tape_count",
                     "scatter_merge"))

    # the kernels on this index's own stacks, at the shapes its queries
    # give them, against their plain versions
    idx = api.holder.index("e")
    for fname in ("v", "d"):
        planes = stacked_bsi(idx.field(fname), [0]).planes
        for op, c, c2 in ((S.GT, 0, None), (S.LT, -7000, None),
                          (S.EQ, 250, None), (S.NE, 250, None),
                          (S.BETWEEN, -30000, 12345)):
            report.err("bsi_compare", S.bsi_compare(planes, op, c, c2),
                       S.bsi_compare_plain(planes, op, c, c2))
    planes = stacked_bsi(idx.field("v"), [0]).planes
    mags = planes[S.OFFSET:]
    pos_m = planes[S.EXISTS] & ~planes[S.SIGN]
    neg_m = planes[S.EXISTS] & planes[S.SIGN]
    # 1-field GroupBy Sum: a row block x the 2 * depth signed planes
    signed = torch.cat([mags & pos_m[None, :], mags & neg_m[None, :]])
    st_g = stacked_set(idx.field("g"), [0], "standard")
    for _, a in stacked_set(idx.field("m"), [0], "standard").iter_blocks():
        report.err("pair_counts", G.pair_counts(a, signed),
                   G.pair_counts_plain(a, signed))
        # 2-field GroupBy Sum: both sign classes of a block x one plane
        # of the other field's block
        a2 = torch.cat([a & pos_m[None, :], a & neg_m[None, :]])
        for _, b in st_g.iter_blocks():
            bk = (b & mags[-1][None, :]).contiguous()
            report.err("pair_counts", G.pair_counts(a2, bk),
                       G.pair_counts_plain(a2, bk))
    # the 3-field fold: the (m, g) groups against a row block of t, then
    # the (m, g, t) groups against the ones row and the signed planes
    rows = {f: stacked_set(idx.field(f), [0], "standard") for f in "mgt"}
    mg = torch.stack([rows["m"].row_plane(a) & rows["g"].row_plane(b)
                      for a in range(5) for b in range(3)])
    for _, b in rows["t"].iter_blocks():
        report.err("pair_counts", G.pair_counts(mg, b),
                   G.pair_counts_plain(mg, b))
    mgt = torch.cat([mg & rows["t"].row_plane(r)[None, :] for r in range(4)])
    side = torch.cat([torch.full_like(pos_m, -1)[None, :],
                      mags & pos_m[None, :], mags & neg_m[None, :]])
    report.err("pair_counts", G.pair_counts(mgt, side),
               G.pair_counts_plain(mgt, side))


#: TPC-H/SSB order dates: 1992-01-01 .. 1998-08-02 (ENDDATE - 151 days)
FIRST_DATE, N_DATES = "1992-01-01", 2406


def _datekeys():
    """SSB ``d_datekey`` (YYYYMMDD) of every order date, in date order."""
    import numpy as np

    d = np.datetime64(FIRST_DATE) + np.arange(N_DATES)
    y = d.astype("datetime64[Y]").astype(np.int64) + 1970
    m = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dd = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    return y * 10000 + m * 100 + dd


def _want_top(counts_by_id: dict, k) -> list:
    """(id, count) of the k highest counts, ties by id (the executor's
    order), zero counts left out."""
    ranked = sorted((-c, i) for i, c in counts_by_id.items() if c)
    if k is not None:
        ranked = ranked[:k]
    return [(i, -c) for c, i in ranked]


def phase_ssb_by_date(report: Report, args) -> dict:
    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.ops import topk as T
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    name, brands = "ssb_by_date", 1000
    rng = np.random.default_rng(args.seed + 2)
    shards = args.shards
    n = shards * SHARD_WIDTH
    keys = _datekeys()
    day = np.sort(rng.integers(0, N_DATES, n))  # load order = date order
    date = keys[day]
    year = date // 10000
    brand_of = rng.integers(0, brands, n)
    names = np.array([f"MFGR#{1000 + b}" for b in range(brands)])
    cols = np.arange(n, dtype=np.int64)

    KU.reset_launches()
    t0 = time.perf_counter()
    api = API()
    api.create_index(name)
    api.create_field(name, "orderdate", {"type": "mutex"})
    api.create_field(name, "year", {"type": "mutex"})
    api.create_field(name, "brand", {"type": "mutex", "keys": True})
    api.import_bits(name, "orderdate", rows=date, cols=cols)
    api.import_bits(name, "year", rows=year, cols=cols)
    api.import_bits(name, "brand", cols=cols, row_keys=names[brand_of])
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0

    top_q = "TopN(orderdate, n=10)"
    ftop_q = 'TopN(orderdate, Row(brand="MFGR#1003"), n=10)'
    t0 = time.perf_counter()
    got = {top_q: api.query(name, top_q)[0]}  # builds and classifies
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    queries = [ftop_q, "TopN(orderdate, Row(year=1995), n=5)", "TopN(year)",
               'TopN(year, Row(brand="MFGR#1500"), n=7)',
               "GroupBy(Rows(year), Rows(brand), limit=100)",
               "GroupBy(Rows(orderdate), filter=Row(year=1996), limit=50)",
               'Count(Intersect(Row(year=1995), Row(brand="MFGR#1007")))',
               "Count(Row(orderdate=19950314))", "Count(Not(Row(year=1992)))",
               "Count(All())"]
    for q in queries:
        got[q] = api.query(name, q)[0]
    # a 3-field GroupBy folds: pair_counts at each level, per row block of
    # brand, then of orderdate (the compressed blocks decode first)
    fold_q = ('GroupBy(Rows(year), Rows(brand), Rows(orderdate), '
              'filter=Row(brand="MFGR#1003"))')
    before = KU.launches()["pair_counts"]
    t0 = time.perf_counter()
    got[fold_q] = api.query(name, fold_q)[0]
    torch.cuda.synchronize()
    fold_ms = (time.perf_counter() - t0) * 1e3
    fold_launches = KU.launches()["pair_counts"] - before
    launched = KU.launches()

    # -- oracle ---------------------------------------------------------------
    by_date = dict(zip(keys.tolist(),
                       np.bincount(day, minlength=N_DATES).tolist()))

    def date_counts(sel):
        return dict(zip(keys.tolist(), np.bincount(
            day[sel], minlength=N_DATES).tolist()))

    def year_counts(sel=slice(None)):
        ys, cs = np.unique(year[sel], return_counts=True)
        return dict(zip(ys.tolist(), cs.tolist()))

    def pairs(r):
        return [(p.id, p.count) for p in r.pairs]

    assert pairs(got[top_q]) == _want_top(by_date, 10), top_q
    assert pairs(got[ftop_q]) == _want_top(date_counts(brand_of == 3), 10), \
        ftop_q
    assert pairs(got["TopN(orderdate, Row(year=1995), n=5)"]) == _want_top(
        date_counts(year == 1995), 5), "TopN(orderdate, Row(year=1995))"
    assert pairs(got["TopN(year)"]) == _want_top(year_counts(), None), \
        "TopN(year)"
    assert pairs(got['TopN(year, Row(brand="MFGR#1500"), n=7)']) == \
        _want_top(year_counts(brand_of == 500), 7), "TopN(year, brand)"
    fb = api.holder.index(name).field("brand")
    bid = {b: fb.translate.key_to_id[names[b]] for b in range(brands)}
    table = np.bincount((year - 1992) * brands + brand_of,
                        minlength=7 * brands).reshape(7, brands)
    want_groups = sorted((1992 + y, bid[b], int(table[y, b]))
                         for y in range(7) for b in range(brands)
                         if table[y, b])[:100]
    assert [(g.group[0].row_id, bid[int(g.group[1].row_key[5:]) - 1000],
             g.count) for g in got["GroupBy(Rows(year), Rows(brand), "
                                   "limit=100)"]] == want_groups, \
        "GroupBy(year, brand)"
    in_1996 = date_counts(year == 1996)
    want_days = [(k, c) for k, c in sorted(in_1996.items()) if c][:50]
    assert [(g.group[0].row_id, g.count) for g in got[
        "GroupBy(Rows(orderdate), filter=Row(year=1996), limit=50)"]] == \
        want_days, "GroupBy(orderdate, filter)"
    sel = brand_of == 3
    triples, tcounts = np.unique(
        np.stack([year[sel], date[sel]], axis=1), axis=0, return_counts=True)
    want_fold = [(int(y), names[3], int(d), int(c))
                 for (y, d), c in zip(triples, tcounts)]
    assert [(g.group[0].row_id, g.group[1].row_key, g.group[2].row_id,
             g.count) for g in got[fold_q]] == want_fold, "3-field GroupBy"
    for q, sel in (
            ('Count(Intersect(Row(year=1995), Row(brand="MFGR#1007")))',
             (year == 1995) & (brand_of == 7)),
            ("Count(Row(orderdate=19950314))", date == 19950314),
            ("Count(Not(Row(year=1992)))", year != 1992),
            ("Count(All())", np.ones(n, dtype=bool))):
        assert got[q] == int(sel.sum()), f"{q}: {got[q]}"

    # -- residency -----------------------------------------------------------
    idx = api.holder.index(name)
    stacks = {f: STK.stacked_set(idx.field(f), list(range(shards)),
                                 "standard")
              for f in ("orderdate", "year", "_exists", "brand")}
    STK.BUDGET.audit()
    lines = []
    for f, st in stacks.items():
        blocks = [st._ensure_block(bi) for bi in range(st.n_blocks)]
        compressed = [isinstance(b, C.CompressedBlock) for b in blocks]
        if f == "brand":
            assert not any(compressed), "brand should stay dense (ratio rule)"
        else:
            assert all(compressed), f"{f} is not resident compressed"
            assert all(b.nbytes <= C.MAX_RATIO * b.dense_nbytes
                       for b in blocks), f"{f} stored above 0.9 x dense"
        for bi, b in enumerate(blocks):
            assert STK.BUDGET._lru[(st.serial, bi)][0] == STK._nbytes(b), \
                f"{f} block {bi} is charged other than its stored bytes"
        dense_b = sum(b.dense_nbytes if c else STK._nbytes(b)
                      for b, c in zip(blocks, compressed))
        stored_b = sum(b.nbytes if c else STK._nbytes(b)
                       for b, c in zip(blocks, compressed))
        list_b = sum(b.nz_nbytes for b, c in zip(blocks, compressed) if c)
        n_nz = sum(b.n_nz for b, c in zip(blocks, compressed) if c)
        tiles = sum(b.n_payload for b, c in zip(blocks, compressed) if c)
        lines.append(f"{f}: {st.n_blocks} x {st.block_rows} rows, dense "
                     f"{dense_b} B, stored {stored_b} B, non-zero constant "
                     f"list {list_b} B ({n_nz} constants), payload tiles "
                     f"{tiles}, "
                     f"{'compressed' if all(compressed) else 'dense'}")
    report.launched(name, launched, ("ctile_count", "tape_count",
                                     "pair_counts", "scatter_merge"))
    # one launch per level and row block: year's one block against
    # brand's blocks, then the pruned groups against orderdate's
    assert fold_launches == (stacks["brand"].n_blocks
                             + stacks["orderdate"].n_blocks), fold_launches
    lines.append(f"{fold_q}: {len(got[fold_q])} groups in {fold_ms:.1f} ms "
                 f"(first run), {fold_launches} pair_counts launches (one a "
                 f"level and row block)")
    # ctile_count on the path's own resident blocks (year, _exists and
    # every orderdate block), filtered and unfiltered, against its plain
    # version
    filt = stacks["brand"].row_plane(bid[3])
    n_held = 0
    for f in ("orderdate", "year", "_exists"):
        st = stacks[f]
        for bi in range(st.n_blocks):
            cb = st._ensure_block(bi)
            ft = C._filt_tiles(filt, cb.n_tiles, cb.tile_words)
            for fti in (None, ft):
                operands = (cb.payload, cb.payload_row, cb.payload_tile,
                         cb.const, fti)
                report.err("ctile_count", C.ctile_count(*operands),
                           C.ctile_count_plain(*operands))
                n_held += 1
        blocks = [st._ensure_block(bi) for bi in range(st.n_blocks)]
        for fi in (None, filt):
            report.err("ctile_count", C.ctile_count_blocks(blocks, fi),
                       C.ctile_count_blocks_plain(blocks, fi))
    lines.append(f"ctile_count equals its plain version on the path's "
                 f"{n_held // 2} resident compressed blocks, one by one and "
                 f"stack by stack, filtered and not")
    # pair_counts at the fold's shapes: the filtered year groups against
    # each brand block, then the (year, MFGR#1003) groups, the same
    # planes since the filter is that brand's row, against each decoded
    # orderdate block
    groups = stacks["year"].take_rows(stacks["year"].row_ids) & filt[None, :]
    fold_shapes = {}
    for level, (a, st) in enumerate(((groups, stacks["brand"]),
                                     (groups, stacks["orderdate"])), start=1):
        for _, b in st.iter_blocks():
            report.err("pair_counts", G.pair_counts(a, b),
                       G.pair_counts_plain(a, b))
        shape = f"{a.shape[0]} x {b.shape[0]} x {a.shape[1]} words"
        fold_shapes[f"level {level}: {shape}"] = {
            "ms": _time_ms(lambda a=a, b=b: G.pair_counts(a, b), reps=5,
                           trials=5),
            "kernel_ms": _device_ms(lambda a=a, b=b: G.pair_counts(a, b),
                                    "pc_", calls=10),
            "plain_ms": _time_ms(lambda a=a, b=b: G.pair_counts_plain(a, b),
                                 reps=1, trials=3),
            "bound_ms": (a.numel() + b.numel()) * 4 / _mem_rate(
                torch.cuda.get_device_name(0)) * 1e3}
        del b
    report.kernel("pair_counts", fold_shapes=fold_shapes)
    lines.append("pair_counts equals its plain version at the fold's "
                 "shapes: " + "; ".join(
                     f"{k}: {v['ms']:.4f} ms call, kernel "
                     f"{_fmt_ms(v['kernel_ms'])}, bound {v['bound_ms']:.4f} "
                     f"ms, plain {v['plain_ms']:.4f} ms"
                     for k, v in fold_shapes.items()))
    # one TopN over the 10 orderdate blocks: one ctile_count launch
    KU.reset_launches()
    api.query(name, top_q)
    api.query(name, ftop_q)
    per_query = KU.launches()["ctile_count"] / 2
    assert per_query == 1, f"{per_query} ctile_count launches per TopN"
    lines.append(f"ctile_count launches per TopN(orderdate) query: "
                 f"{per_query:g} over {stacks['orderdate'].n_blocks} blocks")
    for line in lines:
        print(f"ssb_by_date path: {line} {report.label}")
    print(f"ssb_by_date path: budget used {STK.BUDGET.used} B over "
          f"{len(STK.BUDGET._lru)} resident entries (every path's stacks), "
          f"audit holds {report.label}")

    # -- times ---------------------------------------------------------------
    p50 = {q: statistics.median(_wall_ms(lambda q=q: api.query(name, q))
                                for _ in range(11)) for q in (ftop_q, top_q)}
    busy = {q: _device_ms(lambda q=q: api.query(name, q), calls=11)
            for q in (ftop_q, top_q)}
    st = stacks["orderdate"]
    decoded = [blk for _, blk in st.iter_blocks()]
    for f in (None, filt):
        assert torch.equal(st.row_counts(f), torch.cat(
            [T.row_counts(b, f) for b in decoded])), "count step disagrees"
    comp_ms = _time_ms(lambda: st.row_counts(filt), reps=3, trials=5)
    dense_ms = _time_ms(lambda: [T.row_counts(b, filt) for b in decoded],
                        reps=3, trials=5)
    step_calls = 20
    step = _device_ops(lambda: st.row_counts(filt), calls=step_calls)
    # a fill and one ctile_count launch a call
    _once_per_call(step, step_calls, 2)
    assert any("ctile_count" in k for k in step), step
    comp_dev = sum(ms for _, ms in step.values())
    comp_ops = sum(k for k, _ in step.values()) / step_calls
    dense_dev = _device_ms(lambda: [T.row_counts(b, filt) for b in decoded],
                           calls=5)
    del decoded
    torch.cuda.empty_cache()
    print(f"ssb_by_date path: {n} columns by order date, {N_DATES} dates, "
          f"{brands} brands; import {import_s:.3f} s; first query (builds "
          f"and classifies the orderdate blocks) {first_s:.3f} s; launches "
          f"{launched} {report.label}")
    for q in (ftop_q, top_q):
        print(f"ssb_by_date path: p50 of {q} {p50[q]:.3f} ms; device busy "
              f"per query {_fmt_ms(busy[q])} {report.label}")
    print(f"ssb_by_date path: count step over the {st.n_blocks} orderdate "
          f"blocks, filtered: compressed (ctile_count) {comp_ms:.4f} ms "
          f"call, {_fmt_ms(comp_dev)} device in 2 device ops (events in a "
          f"trace of {step_calls} calls: " + ", ".join(
              f"{k} x {name} at {ms:.4f} ms" for name, (k, ms) in step.items())
          + f"); dense pair_counts on the "
          f"decoded blocks {dense_ms:.4f} ms call, {_fmt_ms(dense_dev)} "
          f"device {report.label}")
    report.kernel("ctile_count", count_step={
        "blocks": st.n_blocks, "call_ms": comp_ms, "device_ms": comp_dev,
        "device_ops": 2, "trace_events_per_call": comp_ops,
        "launches_per_topn": per_query})
    print("ssb_by_date path: every answer matches the numpy oracle")
    return {"api": api, "date": date, "year": year, "brand_of": brand_of,
            "names": names, "keys": keys, "bid": bid}


def phase_sparse_bsi(report: Report, args) -> None:
    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core.stacked import stacked_bsi
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.ops import kernel_util as KU

    rng = np.random.default_rng(args.seed + 3)
    n = 65536  # a clustered range of one shard
    delay = rng.integers(0, 1000, n)
    KU.reset_launches()
    api = API()
    api.create_index("sparse")
    api.create_field("sparse", "delay", {"type": "int"})
    api.import_values("sparse", "delay", cols=np.arange(n), values=delay)
    checks = {
        "Count(Row(delay > 100))": int((delay > 100).sum()),
        "Count(Row(50 <= delay <= 60))":
            int(((delay >= 50) & (delay <= 60)).sum()),
    }
    got = {q: api.query("sparse", q)[0] for q in checks}
    small = delay[delay < 7]
    aggs = {"Sum(Row(delay < 7), field=delay)": (int(small.sum()),
                                                 small.size),
            "Min(field=delay)": (int(delay.min()),
                                 int((delay == delay.min()).sum())),
            "Max(field=delay)": (int(delay.max()),
                                 int((delay == delay.max()).sum()))}
    got.update({q: api.query("sparse", q)[0] for q in aggs})
    torch.cuda.synchronize()
    launched = KU.launches()
    for q, want in checks.items():
        assert got[q] == want, f"{q}: {got[q]} != {want}"
    for q, want in aggs.items():
        assert (got[q].val, got[q].count) == want, f"{q}: {got[q]}"
    st = stacked_bsi(api.holder.index("sparse").field("delay"), [0])
    cb = st._entry()
    assert isinstance(cb, C.CompressedBlock), "the sparse BSI stack is dense"
    report.launched("sparse_bsi", launched, ("bsi_compare", "tape_count",
                                             "pair_counts", "scatter_merge"))
    dense = cb.decode()
    for op, v, v2 in ((S.EQ, 500, None), (S.NE, 500, None), (S.LT, 7, None),
                      (S.LE, 60, None), (S.GT, 100, None), (S.GE, 999, None),
                      (S.BETWEEN, 50, 60)):
        report.err("bsi_compare", C.bsi_compare_compressed(cb, op, v, v2),
                   S.bsi_compare_plain(dense, op, v, v2))
    print(f"sparse bsi: depth {st.depth}, stack dense {cb.dense_nbytes} B, "
          f"stored {cb.nbytes} B, {cb.active_tiles.size} of {cb.n_tiles} "
          f"tiles active; launches {launched}; every answer matches numpy "
          f"{report.label}")


def phase_config1(report: Report, args) -> dict:
    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.probes import import_probe as IP

    city, dev = IP.config1_data()
    n = city.size
    KU.reset_launches()
    api = API()
    changed, import_s, field_s = IP.timed_import(api, city, dev)
    q = "Count(Intersect(Row(city=7), Row(device=3)))"
    t0 = time.perf_counter()
    got = {q: api.query("taxi", q)[0]}  # builds the city and device stacks
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pairs = [(7, 3), (0, 0), (999, 9), (500, 5), (123, 1), (42, 8)]
    for c, d in pairs[1:]:
        pq = f"Count(Intersect(Row(city={c}), Row(device={d})))"
        got[pq] = api.query("taxi", pq)[0]
    torch.cuda.synchronize()
    launched = KU.launches()

    # -- oracle ---------------------------------------------------------------
    # timed_import checked every row's popcount of city, device and _exists
    # against np.bincount, and the changed counts against the records
    for c, d in pairs:
        pq = f"Count(Intersect(Row(city={c}), Row(device={d})))"
        assert got[pq] == int(((city == c) & (dev == d)).sum()), pq
    assert sum(ch for _, ch in changed) == 2 * n, "changed counts"
    # one launch per set_many: each import_bits call and its _exists mark
    assert launched["scatter_merge"] == 2 * len(changed), launched
    report.launched("config1", launched, ("scatter_merge", "tape_count"))

    split = IP.split_import(API(), city, dev)
    trace_path = os.path.abspath(os.path.join("build", "config1_trace.json"))
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    tr = IP.traced_import(API(), city, dev, trace_path)
    kernels = [k for k in tr["ops"] if "Memcpy" not in k]
    assert all("scatter_merge" in k for k in kernels), \
        f"device ops besides the kernel and the copies: {tr['ops']}"
    assert all("Pinned" in k for k in tr["ops"] if "Memcpy" in k), \
        f"a pageable copy: {tr['ops']}"
    launches = tr["scatter_merge_launches"]
    assert tr["kernel_events_per_launch"] <= 1 \
        and tr["events"] <= 3 * launches, tr
    staged = split["staged_bytes"]
    pcie = max(tr["bytes"]["h2d"] + tr["bytes"]["d2h"],
               staged.get("h2d", 0) + staged.get("d2h", 0))
    assert pcie <= 400e6, f"{pcie} B over PCIe"

    p50 = statistics.median(_wall_ms(lambda: api.query("taxi", q))
                            for _ in range(11))
    busy = _device_ms(lambda: api.query("taxi", q), calls=11)
    idx = api.holder.index("taxi")
    lines = []
    for f in ("city", "device", "_exists"):
        st = STK.stacked_set(idx.field(f), [0], "standard")
        blocks = [st._ensure_block(bi) for bi in range(st.n_blocks)]
        dense_b = sum(b.dense_nbytes if isinstance(b, C.CompressedBlock)
                      else STK._nbytes(b) for b in blocks)
        stored_b = sum(STK._nbytes(b) for b in blocks)
        kinds = sorted({"compressed" if isinstance(b, C.CompressedBlock)
                        else "dense" for b in blocks})
        lines.append(f"{f}: {st.n_blocks} x {st.block_rows} rows, dense "
                     f"{dense_b} B, stored {stored_b} B ({', '.join(kinds)})")
    print(f"config1 path: {n} records in batches of {IP.C1_BATCH}; import "
          f"{import_s:.3f} s (" + ", ".join(
              f"{k} {v:.3f} s" for k, v in field_s.items())
          + f"); first query (builds the stacks) {first_s:.3f} s; launches "
          f"{launched} {report.label}")
    print(f"config1 path: import split ({split['import_s']:.3f} s with a sync "
          f"around every stage call): " + ", ".join(
              f"{k} {v:.3f} s" for k, v in split["stages_s"].items())
          + f"; PCIe bytes as staged {staged.get('h2d', 0)} up, "
          f"{staged.get('d2h', 0)} down {report.label}")
    print(f"config1 path: traced import: {launches} scatter_merge launches, "
          f"{tr['device_ops_per_launch']:.2f} device ops and "
          f"{tr['kernel_events_per_launch']:.2f} kernel events per launch; "
          f"PCIe {tr['bytes']['h2d']} B up, {tr['bytes']['d2h']} B down; "
          + ", ".join(f"{k} x{v['events']} {v['device_ms']:.3f} ms"
                      for k, v in tr["ops"].items()) + f" {report.label}")
    for line in lines:
        print(f"config1 path: {line} {report.label}")
    print(f"config1 path: p50 of {q} {p50:.3f} ms; device busy per query "
          f"{_fmt_ms(busy)}"
          + (f" ({100 * busy / p50:.1f}% of the p50)" if busy else "")
          + f" {report.label}")
    report.kernel("scatter_merge", config1_import={
        "import_s": import_s, "field_s": field_s, "split": split["stages_s"],
        "launches": launches, "device_ops_per_launch":
            tr["device_ops_per_launch"], "pcie_bytes_traced": tr["bytes"],
        "pcie_bytes_staged": staged})
    print("config1 path: every answer matches numpy")
    return {"api": api, "city": city, "device": dev}


# ---------------------------------------------------------------------------
# Path 6: writes between reads
# ---------------------------------------------------------------------------


class _LogModel:
    """The write-delta log rules of the JAX package
    (``pilosa_tpu/core/fragment.py:75-136``) for the fragments of one
    stack, kept beside the port's to predict whether the next read
    advances the stack or rebuilds it: a log holds at most 512 ops and
    4,096 columns of replay cost, a bulk import of more than 4,096 pairs
    or a structural write resets it, and a reset since the stack's build
    means a rebuild."""

    MAX_OPS, MAX_COLS = 512, 4096

    def __init__(self):
        self.ops = self.cost = 0
        self.dirty = self.broken = False

    def record(self, cost: int = 1) -> bool:
        self.dirty = True
        if self.ops >= self.MAX_OPS or self.cost + cost > self.MAX_COLS:
            self.reset()
            return False
        self.ops += 1
        self.cost += cost
        return True

    def reset(self) -> None:
        self.ops = self.cost = 0
        self.dirty = self.broken = True

    def bulk(self, rows, cols) -> None:
        """``SetFragment.set_many``: one payload per row, in row order,
        costing its distinct columns; none past a reset."""
        import numpy as np

        self.dirty = True
        if cols.size > self.MAX_COLS:
            self.reset()
            return
        for r in np.unique(rows):
            if not self.record(np.unique(cols[rows == r]).size):
                break


class _Expect:
    """Advances, builds and stack uploads predicted for a segment's reads
    from the log models, held against the port's counters
    (``ADVANCE_STATS``, ``UPLOAD_STATS``) when the segment ends."""

    def __init__(self, stk):
        self.stk = stk
        self.begin()

    def begin(self) -> None:
        self.want = {"advanced": 0, "built": 0, "uploads": 0}
        self.adv0 = dict(self.stk.ADVANCE_STATS)
        self.up0 = dict(self.stk.UPLOAD_STATS)

    def read(self, model: _LogModel, blocks: int = 1,
             published: bool = True) -> None:
        """A read that stacks the model's field (``blocks`` blocks built
        if it rebuilds); a stack of a write request is not published, so
        the model keeps its state for the next read."""
        if not model.dirty:
            return  # versions unchanged: a cache hit
        if model.broken:
            self.want["built"] += 1
            self.want["uploads"] += blocks
        else:
            self.want["advanced"] += 1
        if published:
            model.dirty = model.broken = False

    def check(self, segment: str) -> dict:
        got = {k: self.stk.ADVANCE_STATS[k] - self.adv0[k]
               for k in ("advanced", "built")}
        got["uploads"] = self.stk.UPLOAD_STATS["count"] - self.up0["count"]
        assert got == self.want, f"{segment}: {got}, predicted {self.want}"
        got["upload_bytes"] = (self.stk.UPLOAD_STATS["bytes"]
                               - self.up0["bytes"])
        got["mask_bytes"] = (self.stk.ADVANCE_STATS["mask_bytes"]
                             - self.adv0["mask_bytes"])
        got["scatters"] = (self.stk.ADVANCE_STATS["scatters"]
                           - self.adv0["scatters"])
        self.begin()
        return got


def _same_as_rebuild(st) -> None:
    """Every resident block of a set stack (or a BSI stack) equals what a
    rebuild from the host planes would hold, slot for slot."""
    import numpy as np

    from pilosa_tpu_torch.core import stacked as STK

    if isinstance(st, STK.StackedBSI):
        pairs = [(st._planes, st._assemble_host)]
    else:
        pairs = [(b, lambda bi=bi: st._assemble_host(bi))
                 for bi, b in enumerate(st._blocks) if b is not None]
    for blk, host in pairs:
        got = STK._dense(blk).cpu().numpy().view(np.uint32)
        assert np.array_equal(got, host()), "advanced planes != a rebuild"


def _writes_config1(c1: dict) -> dict:
    """6a: config 7's write-invalidated traffic on config 1's index."""
    import numpy as np
    import torch

    from pilosa_tpu_torch import platform
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    api, city, dev = c1["api"], c1["city"], c1["device"]
    n = city.size
    idx = api.holder.index("taxi")
    f_city, f_dev = idx.field("city"), idx.field("device")
    # the oracle: the rows the checks read, as bitmaps over shard 0
    c3, d7, d9 = (np.zeros(SHARD_WIDTH, bool) for _ in range(3))
    c3[:n], d7[:n], d9[:n] = city == 3, dev == 7, dev == 9
    exists = np.zeros(SHARD_WIDTH, bool)
    exists[:n] = True
    c1000 = np.zeros(SHARD_WIDTH, bool)
    m = {f: _LogModel() for f in ("city", "device", "_exists")}
    ex = _Expect(STK)
    q = "Count(Intersect(Row(city=3), Row(device=7)))"
    out = {}

    def read():
        got = api.query("taxi", q)[0]
        ex.read(m["city"])
        ex.read(m["device"])
        return got

    def check(got):
        assert got == int((c3 & d7).sum()), f"{q}: {got}"

    def timed(write, reps):
        """write->visible: the write call to the read's answer (the
        oracle's bookkeeping in ``write`` is a few scalar stores)."""
        times = []
        for i in range(reps):
            t0 = time.perf_counter()
            write(i)
            got = read()
            times.append((time.perf_counter() - t0) * 1e3)
            check(got)
        return times

    def check_stacks(segment):
        for f in (f_city, f_dev):
            _same_as_rebuild(STK.stacked_set(f, [0], "standard"))
        out[segment] = ex.check(segment)

    check(read())  # the stacks are current after path 5
    ex.check("6a start")

    # rounds of Set(c, city=3)Set(c, device=7) on new records
    def round_(i):
        c = n + i
        api.query("taxi", f"Set({c}, city=3)Set({c}, device=7)")
        c3[c] = d7[c] = exists[c] = True
        m["city"].record()
        m["device"].record()
        m["_exists"].record()

    out["rounds_ms"] = timed(round_, 64)
    check_stacks("6a rounds")

    # 11 more rounds split in three: the write request, the advance of
    # both stacks (synced), the read on the advanced stacks; then the
    # device busy time of 11 whole rounds in a profiler trace
    split = {"write": [], "advance": [], "read": []}
    for i in range(64, 75):
        t0 = time.perf_counter()
        round_(i)
        t1 = time.perf_counter()
        STK.stacked_set(f_city, [0], "standard")
        STK.stacked_set(f_dev, [0], "standard")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = read()
        t3 = time.perf_counter()
        check(got)
        for k, (a, b) in zip(split, ((t0, t1), (t1, t2), (t2, t3))):
            split[k].append((b - a) * 1e3)
    out["split_ms"] = {k: statistics.median(v) for k, v in split.items()}
    nxt = iter(range(75, 128))
    out["round_busy_ms"] = _device_ms(lambda: (round_(next(nxt)), read()),
                                      calls=11)
    check(read())
    check_stacks("6a split rounds")

    # 32 clears of city=3 on existing records, then a new row in place
    clear_cols = np.flatnonzero(city == 3)[:32]

    def clear(i):
        api.query("taxi", f"Clear({int(clear_cols[i])}, city=3)")
        c3[clear_cols[i]] = False
        m["city"].record()

    out["clears_ms"] = timed(clear, 32)
    api.query("taxi", "Set(5, city=1000)")
    c1000[5] = True
    m["city"].record()
    check(read())
    assert api.query("taxi", "Count(Row(city=1000))")[0] == 1
    st = STK.stacked_set(f_city, [0], "standard")
    assert (st.cap, len(st.row_ids), st.paged) == (1024, 1001, False), \
        (st.cap, len(st.row_ids))
    check(read())
    check_stacks("6a clears and a new row")

    # 16 imports of 1,024 new records each (config 1's fields)
    rng = np.random.default_rng(7)
    lo = n + 128
    for b in range(16):
        cols = np.arange(lo + b * 1024, lo + (b + 1) * 1024, dtype=np.int64)
        rc, rd = rng.integers(0, 1000, cols.size), rng.integers(0, 10,
                                                                cols.size)
        api.import_bits("taxi", "city", rows=rc, cols=cols)
        api.import_bits("taxi", "device", rows=rd, cols=cols)
        c3[cols], d7[cols], d9[cols] = rc == 3, rd == 7, rd == 9
        exists[cols] = True
        m["city"].bulk(rc, cols)
        m["device"].bulk(rd, cols)
        for _ in range(2):  # each import_bits call marks _exists
            m["_exists"].bulk(np.zeros(cols.size, dtype=np.int64), cols)
        check(read())
    check_stacks("6a imports of 1,024")

    # 11 replays of a 65,536-record batch of the original import (the
    # default batch of the JAX package's ingester, delivered again): it
    # sets back only the city=3 bits cleared above, and each resets the
    # log, so the next read rebuilds city
    replay_ms = []
    for b in range(11):
        cols = np.arange(b * 65536, (b + 1) * 65536, dtype=np.int64)
        back = (city[cols] == 3) & ~c3[cols]
        assert api.import_bits("taxi", "city", rows=city[cols],
                               cols=cols) == int(back.sum())
        c3[cols] |= back
        m["city"].bulk(city[cols], cols)
        m["_exists"].bulk(np.zeros(cols.size, dtype=np.int64), cols)
        t0 = time.perf_counter()
        got = read()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        check(got)
    out["replay_read_ms"] = replay_ms
    check_stacks("6a replays of 65,536")

    # the same read after release_field_cache: a forced rebuild of both
    forced_ms = []
    for _ in range(11):
        STK.release_field_cache(f_city)
        STK.release_field_cache(f_dev)
        t0 = time.perf_counter()
        got = api.query("taxi", q)[0]
        forced_ms.append((time.perf_counter() - t0) * 1e3)
        assert got == int((c3 & d7).sum())
        ex.want["built"] += 2
        ex.want["uploads"] += 2
    out["forced_ms"] = forced_ms
    check_stacks("6a forced rebuilds")
    # a city rebuild in three parts (median of 3): host assembly, the
    # compress decision, the upload
    st = STK.stacked_set(f_city, [0], "standard")
    parts = {"assemble": [], "compress decision": [], "h2d": []}
    for _ in range(3):
        t0 = time.perf_counter()
        host = st._assemble_host(0)
        t1 = time.perf_counter()
        assert C.maybe_compress(host, st.device) is None  # city stays dense
        t2 = time.perf_counter()
        platform.h2d_copy(host, st.device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3))):
            parts[k].append((b - a) * 1e3)
    out["rebuild_parts_ms"] = {k: statistics.median(v)
                               for k, v in parts.items()}
    del host

    # Store, ClearRow, Delete
    assert api.query("taxi", "Store(Intersect(Row(city=3), Row(device=7)), "
                             "city=1001)") == [True]
    m["city"].reset()
    want_1001 = int((c3 & d7).sum())
    assert api.query("taxi", "Count(Row(city=1001))") == [want_1001]
    ex.read(m["city"])
    assert api.query("taxi", "ClearRow(city=1001)") == [True]
    m["city"].reset()
    assert api.query("taxi", "Count(Row(city=1001))") == [0]
    ex.read(m["city"])
    got = api.query("taxi", "Delete(Row(device=9))")[0]
    ex.read(m["_exists"], published=False)  # inside the write request
    assert got == int((d9 & exists).sum()), f"Delete: {got}"
    for f in m.values():
        f.reset()
    c3 &= ~d9
    d7 &= ~d9
    c1000 &= ~d9
    exists &= ~d9
    d9[:] = False
    assert api.query("taxi", "Count(All())Count(Row(device=9))"
                             "Count(Row(city=1000))") == [
        int(exists.sum()), 0, int(c1000.sum())]
    ex.read(m["_exists"])
    ex.read(m["device"])
    ex.read(m["city"])
    check(read())
    st_ex = STK.stacked_set(idx.field("_exists"), [0], "standard")
    got_ex = st_ex.row_plane(0).cpu().numpy().view(np.uint32)
    assert np.array_equal(got_ex, np.packbits(exists, bitorder="little")
                          .view(np.uint32)), "existence row"
    check_stacks("6a Store, ClearRow, Delete")
    st = STK.stacked_set(f_city, [0], "standard")
    out["city_bytes"] = sum(STK._nbytes(b) for b in st._blocks)
    return out


def _writes_ssb(ssb: dict) -> dict:
    """6b: mutex writes into SSB by order date: a touched compressed block
    decays to dense, the untouched stay compressed, a new brand key
    appends a slot to the paged brand stack."""
    import numpy as np

    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import ctiles as C

    api = ssb["api"]
    date, year, brand_of = ssb["date"].copy(), ssb["year"], \
        ssb["brand_of"].copy()
    keys, bid = ssb["keys"], dict(ssb["bid"])
    names = list(ssb["names"]) + ["MFGR#2000"]  # one new key
    brands = len(names)
    n = date.size
    name = "ssb_by_date"
    idx = api.holder.index(name)
    shards = sorted(idx.shards())
    od = STK.stacked_set(idx.field("orderdate"), shards, "standard")
    br = STK.stacked_set(idx.field("brand"), shards, "standard")
    before = {"od": list(od._blocks), "br": list(br._blocks)}
    used0 = STK.BUDGET.used
    slot_of = {int(k): i for i, k in enumerate(od.row_ids)}
    # corrections to orders of the first dates: columns and new dates
    # both in the first 200 order dates, so the writes stay in the
    # orderdate stack's first block
    rng = np.random.default_rng(11)
    early = int(np.searchsorted(date, keys[200]))
    cols = rng.choice(early, 32, replace=False)
    new_dates = keys[rng.integers(0, 200, 32)]
    new_brands = rng.integers(0, brands - 1, 32)
    new_brands[5] = brands - 1  # the new key
    m = {f: _LogModel() for f in ("orderdate", "brand")}
    touched = set()
    ex = _Expect(STK)
    for c, d, b in zip(cols, new_dates, new_brands):
        api.query(name, f"Set({int(c)}, orderdate={int(d)})"
                        f'Set({int(c)}, brand="{names[b]}")')
        if date[c] != d:
            touched.update({slot_of[int(date[c])] // od.block_rows,
                            slot_of[int(d)] // od.block_rows})
            m["orderdate"].record()  # clear_column: the old row
            m["orderdate"].record()  # set_bit
            date[c] = d
        if brand_of[c] != b:
            m["brand"].record()
            m["brand"].record()
            brand_of[c] = b
    bid[brands - 1] = idx.field("brand").translate.key_to_id[names[-1]]
    t0 = time.perf_counter()
    got_top = api.query(name, "TopN(orderdate, n=10)")[0]
    first_read_ms = (time.perf_counter() - t0) * 1e3
    ex.read(m["orderdate"])
    got_gb = api.query(name, "GroupBy(Rows(year), Rows(brand), limit=100)")[0]
    ex.read(m["brand"])
    cq = f'Count(Intersect(Row(year=1992), Row(brand="{names[-1]}")))'
    got_count = api.query(name, cq)[0]
    used1 = STK.BUDGET.used
    STK.BUDGET.audit()

    # -- oracle ---------------------------------------------------------------
    by_date = dict(zip(*np.unique(date, return_counts=True)))
    assert [(p.id, p.count) for p in got_top.pairs] == _want_top(
        {int(k): int(v) for k, v in by_date.items()}, 10), "TopN(orderdate)"
    table = np.bincount((year - 1992) * brands + brand_of,
                        minlength=7 * brands).reshape(7, brands)
    want_groups = sorted((1992 + y, bid[b], int(table[y, b]))
                         for y in range(7) for b in range(brands)
                         if table[y, b])[:100]
    key_id = {k: bid[i] for i, k in enumerate(names)}
    assert [(g.group[0].row_id, key_id[g.group[1].row_key], g.count)
            for g in got_gb] == want_groups, "GroupBy(year, brand)"
    assert got_count == int(((year == 1992) & (brand_of == brands - 1))
                            .sum()), cq
    seg = ex.check("6b")
    od = STK.stacked_set(idx.field("orderdate"), shards, "standard")
    br = STK.stacked_set(idx.field("brand"), shards, "standard")
    kinds = ["compressed" if isinstance(b, C.CompressedBlock) else "dense"
             for b in od._blocks]
    decayed = sorted(bi for bi, k in enumerate(kinds) if k == "dense")
    assert decayed == sorted(touched), (decayed, touched)
    for bi, b in enumerate(od._blocks):
        if bi not in touched:
            assert b is before["od"][bi], f"untouched block {bi} changed"
    assert len(br.row_ids) == 1001 and br.n_blocks == 4 and br.paged
    _same_as_rebuild(od)
    _same_as_rebuild(br)
    return {"seg": seg, "decayed": decayed, "kinds": kinds,
            "used": (used0, used1), "first_read_ms": first_read_ms,
            "od": od, "br": br, "date": date, "brand_of": brand_of}


def _writes_bsi(bsi: dict) -> dict:
    """6c: Set and Clear of values on config 2's BSI field, then a value
    that grows the depth."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.core import stacked as STK

    api, amount, shards = bsi["api"], bsi["amount"].copy(), bsi["shards"]
    has = np.ones(amount.size, bool)
    half = 524288
    sum_q = f"Sum(Row(amount > {half}), field=amount)"
    range_q = "Count(Row(1000 <= amount <= 200000))"
    m = _LogModel()
    ex = _Expect(STK)
    rng = np.random.default_rng(13)
    cols = rng.choice(amount.size, 103, replace=False)
    vals = rng.integers(0, 1 << 20, 103)

    def check(got):
        big = has & (amount > half)
        want_range = int((has & (amount >= 1000) & (amount <= 200000)).sum())
        assert (got[0].val, got[0].count, got[1]) == (
            int(amount[big].sum()), int(big.sum()), want_range), got

    times = []
    for i, (c, v) in enumerate(zip(cols[:80], vals[:80])):
        t0 = time.perf_counter()
        if i < 64:
            wrote = api.query("b", f"Set({int(c)}, amount={int(v)})")
        else:
            wrote = api.query("b", f"Clear({int(c)}, amount={int(v)})")
        got = api.query("b", sum_q + range_q)
        times.append((time.perf_counter() - t0) * 1e3)
        assert wrote == [True]
        if i < 64:
            amount[c] = v
        else:
            has[c] = False
        m.record(2 + 20)
        ex.read(m)
        check(got)
    field = api.holder.index("b").field("amount")

    def set_value(i):
        api.query("b", f"Set({int(cols[i])}, amount={int(vals[i])})")
        amount[cols[i]] = vals[i]
        m.record(2 + 20)

    # 11 more Sets split in three as in 6a, then the device busy time of
    # 11 whole rounds in a profiler trace
    split = {"write": [], "advance": [], "read": []}
    for i in range(80, 91):
        t0 = time.perf_counter()
        set_value(i)
        t1 = time.perf_counter()
        STK.stacked_bsi(field, list(range(shards)))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = api.query("b", sum_q + range_q)
        t3 = time.perf_counter()
        ex.read(m)
        check(got)
        for k, (a, b) in zip(split, ((t0, t1), (t1, t2), (t2, t3))):
            split[k].append((b - a) * 1e3)
    nxt = iter(range(91, 103))

    def round_():
        set_value(next(nxt))
        got = api.query("b", sum_q + range_q)
        ex.read(m)
        return got

    busy = _device_ms(round_, calls=11)
    check(api.query("b", sum_q + range_q))
    st = STK.stacked_bsi(field, list(range(shards)))
    _same_as_rebuild(st)
    seg = ex.check("6c")
    api.query("b", f"Set(77, amount={1 << 21})")  # depth 22: a rebuild
    amount[77], has[77] = 1 << 21, True
    m.reset()
    check(api.query("b", sum_q + range_q))
    ex.read(m)
    st = STK.stacked_bsi(api.holder.index("b").field("amount"),
                         list(range(shards)))
    assert st.depth == 22
    _same_as_rebuild(st)
    grow = ex.check("6c depth growth")
    return {"seg": seg, "grow": grow, "write_visible_ms": times, "st": st,
            "half": half,
            "split_ms": {k: statistics.median(v) for k, v in split.items()},
            "round_busy_ms": busy}


def phase_writes(report: Report, c1: dict, ssb: dict, bsi: dict) -> dict:
    """Path 6: writes between reads on paths 5, 3 and 2's indexes.
    Returns path 3's index with the orderdate and brand oracle as the
    writes left them."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.ops import scatter as SC
    from pilosa_tpu_torch.ops import topk as T

    KU.reset_launches()
    a = _writes_config1(c1)
    b = _writes_ssb(ssb)
    c = _writes_bsi(bsi)
    torch.cuda.synchronize()
    launched = KU.launches()
    report.launched("writes", launched, ("scatter_merge", "tape_count",
                                         "pair_counts", "bsi_compare",
                                         "ctile_count"))
    # each kernel of the path against its plain version on path 6's
    # advanced stacks (these launches are not counted)
    idx = c1["api"].holder.index("taxi")
    city = STK.stacked_set(idx.field("city"), [0], "standard")
    dev = STK.stacked_set(idx.field("device"), [0], "standard")
    leaves = [city.row_plane(3), dev.row_plane(7)]
    tape = (("and", 0, 1),)
    report.err("tape_count", B.tape_count(tape, leaves),
               B.tape_count_plain(tape, leaves))
    od, br = b["od"], b["br"]
    filt = br.row_plane(br.row_ids[-1])
    for bi in b["decayed"]:
        blk = od._blocks[bi]
        report.err("pair_counts", T.row_counts(blk, filt),
                   G.pair_counts_plain(filt.reshape(1, -1), blk)[0])
    packed = [blk for blk in od._blocks if isinstance(blk, C.CompressedBlock)]
    report.err("ctile_count", C.ctile_count_blocks(packed, filt),
               C.ctile_count_blocks_plain(packed, filt))
    report.err("bsi_compare", S.bsi_compare(c["st"].planes, S.GT, c["half"]),
               S.bsi_compare_plain(c["st"].planes, S.GT, c["half"]))
    rng = np.random.default_rng(17)
    addr, masks = SC.sort_updates(rng.integers(0, city.cap, 1024),
                                  rng.integers(0, city.words * 32, 1024),
                                  city.words)
    flat = city.planes.reshape(-1)
    ours, plain = flat.clone(), flat.clone()
    addr_t = torch.from_numpy(addr.astype(np.int32)).to(flat.device)
    masks_t = torch.from_numpy(masks.view(np.int32)).to(flat.device)
    report.err("scatter_merge", SC.scatter_merge_(ours, addr_t, masks_t),
               SC.scatter_merge_plain(plain, addr_t, masks_t))
    report.err("scatter_merge", ours, plain)
    del ours, plain

    lab = report.label
    ra = a["6a rounds"]
    print(f"writes path 6a: 64 rounds of Set(c, city=3)Set(c, device=7) "
          f"then {ra['advanced']} advances, {ra['built']} builds, "
          f"{ra['uploads']} stack uploads; {ra['scatters']} mask scatters "
          f"moved {ra['mask_bytes']} B ({ra['mask_bytes'] / 64:.0f} B a "
          f"round) against {a['city_bytes']} B of city {lab}")
    for seg in ("6a split rounds", "6a clears and a new row",
                "6a imports of 1,024",
                "6a replays of 65,536", "6a forced rebuilds",
                "6a Store, ClearRow, Delete"):
        g = a[seg]
        print(f"writes path {seg}: {g['advanced']} advances, {g['built']} "
              f"builds, {g['uploads']} uploads of {g['upload_bytes']} B, "
              f"{g['mask_bytes']} mask B (as the JAX package's rules "
              f"predict) {lab}")
    med = {k: statistics.median(v) for k, v in (
        ("write_visible_ms", a["rounds_ms"]),
        ("clear_visible_ms", a["clears_ms"]),
        ("forced_rebuild_ms", a["forced_ms"]),
        ("replay_rebuild_ms", a["replay_read_ms"]),
        ("bsi_write_visible_ms", c["write_visible_ms"]))}
    print(f"writes path 6a: write->visible median "
          f"{med['write_visible_ms']:.3f} ms (Set+Set, then the Count; 64 "
          f"rounds), {med['clear_visible_ms']:.3f} ms (Clear, then the "
          f"Count; 32); the Count after release_field_cache (rebuilds city "
          f"and device) {med['forced_rebuild_ms']:.3f} ms; the Count after "
          f"a 65,536-record replay (rebuilds city) "
          f"{med['replay_rebuild_ms']:.3f} ms (median of 11 each) {lab}")
    sp, rp = a["split_ms"], a["rebuild_parts_ms"]
    busy = a["round_busy_ms"]
    print(f"writes path 6a: a round split (median of 11): write request "
          f"{sp['write']:.3f} ms, advance of both stacks (synced) "
          f"{sp['advance']:.3f} ms, the Count on them {sp['read']:.3f} ms; "
          f"device busy per whole round {_fmt_ms(busy)}; a city rebuild "
          f"(median of 3): host assembly {rp['assemble']:.3f} ms, compress "
          f"decision {rp['compress decision']:.3f} ms, H2D {rp['h2d']:.3f}"
          f" ms {lab}")
    g = b["seg"]
    print(f"writes path 6b: 32 mutex writes of orderdate and brand, then "
          f"TopN/GroupBy/Count: {g['advanced']} advances, {g['built']} "
          f"builds, {g['uploads']} uploads, {g['mask_bytes']} mask B; "
          f"orderdate blocks {b['kinds']} (decayed {b['decayed']}); brand "
          f"4 x 256 rows with the new key appended; budget used "
          f"{b['used'][0]} -> {b['used'][1]} B; the first read after the "
          f"writes {b['first_read_ms']:.3f} ms {lab}")
    g, gg = c["seg"], c["grow"]
    cs = c["split_ms"]
    print(f"writes path 6c: 64 Set and 16 Clear of amount, each then "
          f"Sum+Count, and 23 more Sets: {g['advanced']} advances, "
          f"{g['built']} builds, {g['uploads']} uploads, {g['mask_bytes']} "
          f"mask B; write->visible median "
          f"{med['bsi_write_visible_ms']:.3f} ms (80 rounds); a round "
          f"split (median of 11): write request {cs['write']:.3f} ms, "
          f"advance (synced) {cs['advance']:.3f} ms, Sum+Count "
          f"{cs['read']:.3f} ms; device busy per round "
          f"{_fmt_ms(c['round_busy_ms'])}; a value of 2^21: "
          f"{gg['built']} rebuild, {gg['uploads']} upload of "
          f"{gg['upload_bytes']} B, depth 22 {lab}")
    print(f"writes path: launches {launched} {lab}")
    summary = {**med, "mask_bytes_per_round": ra["mask_bytes"] / 64,
               "city_bytes": a["city_bytes"], "round_split_ms": sp,
               "round_busy_ms": busy, "rebuild_parts_ms": rp,
               "bsi_round_split_ms": cs,
               "bsi_round_busy_ms": c["round_busy_ms"],
               "ssb_first_read_ms": b["first_read_ms"]}
    report.notes["write_visible_ms"] = med["write_visible_ms"]
    print("writes path: " + json.dumps(summary))
    print("writes path: every answer matches numpy")
    return {**ssb, "date": b["date"], "brand_of": b["brand_of"]}


# ---------------------------------------------------------------------------
# Path 7: time-quantum fields and the row-set calls (config 4)
# ---------------------------------------------------------------------------

C4_SHARDS, C4_ROWS = 256, 4
C4_MONTHS = [f"standard_2010{m:02d}" for m in range(1, 13)]
C4_RANGE = "from='2010-03-01T00:00', to='2010-07-01T00:00'"
C4_HALVES = ("from='2010-01-01T00:00', to='2010-07-01T00:00'",
             "from='2010-07-01T00:00', to='2011-01-01T00:00'")


def _popcount(a) -> int:
    """Set bits of a uint32 array (numpy has ``bitwise_count`` from 2.0)."""
    import numpy as np

    if hasattr(np, "bitwise_count"):
        return int(np.bitwise_count(a).sum(dtype=np.int64))
    table = np.array([bin(i).count("1") for i in range(1 << 16)], np.int64)
    return int(table[a & 0xFFFF].sum() + table[a >> 16].sum())


def _has_bit(plane, col: int) -> bool:
    return bool((int(plane[col // 32]) >> (col % 32)) & 1)


def _config4_build():
    """``BASELINE.json`` config 4 as ``bench.py`` ``bench_config4``
    builds it: seed 4, 256 shards, a ``time`` field ``cab`` of quantum
    YMD, 4 rows, 12 monthly views of random planes, written through the
    port's ``Field.write_row_plane``. Returns the API and the numpy
    planes (the oracle), ``{view: uint32[4, 256 * 32768]}``."""
    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD as W

    rng = np.random.default_rng(4)
    api = API()
    api.create_index("t")
    api.create_field("t", "cab", {"type": "time", "timeQuantum": "YMD"})
    f = api.holder.index("t").field("cab")
    host = {}
    for view in C4_MONTHS:
        planes = rng.integers(0, 1 << 32, size=(C4_ROWS, C4_SHARDS * W),
                              dtype=np.uint32)
        host[view] = planes
        for s in range(C4_SHARDS):
            for r in range(C4_ROWS):
                f.write_row_plane(s, r, planes[r, s * W:(s + 1) * W],
                                  view=view)
    return api, host


def _c4_oracle(host):
    """The oracle's answers on config 4's planes as built."""
    import numpy as np

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

    months = ["standard_201003", "standard_201004", "standard_201005",
              "standard_201006"]

    def ranged(row, views=months):
        acc = host[views[0]][row].copy()
        for v in views[1:]:
            acc |= host[v][row]
        return acc

    counts = [_popcount(ranged(r)) for r in range(C4_ROWS)]
    top = sorted(((r, c) for r, c in enumerate(counts) if c),
                 key=lambda rc: (-rc[1], rc[0]))
    row1 = ranged(1)
    union = row1.copy()
    for r in (0, 2, 3):
        union |= ranged(r)
    shaped = row1.reshape(C4_SHARDS, WORDS_PER_SHARD)
    carry = np.zeros_like(shaped)
    carry[:, 1:] = shaped[:, :-1] >> np.uint32(31)
    shifted = (shaped << np.uint32(1)) | carry
    year_all = ranged(1, C4_MONTHS)
    year_union = ranged(0, C4_MONTHS)
    for r in (1, 2, 3):
        year_union |= ranged(r, C4_MONTHS)
    probes = [int(np.flatnonzero(row1[:64])[0]) * 32,  # a word with bits
              SHARD_WIDTH - 1, (C4_SHARDS // 3) * SHARD_WIDTH + 12345,
              C4_SHARDS * SHARD_WIDTH - 1]
    return {
        "count": counts[1], "top": top, "rows": sorted(r for r, _ in top),
        "union": _popcount(union), "shift": _popcount(shifted),
        "year_count": _popcount(year_all),
        # the YMD cover of 2010 is the year view, which the build lacks
        "year_union": _popcount(year_union), "year_top": [],
        "includes": {c: bool((int(row1[c // 32]) >> (c % 32)) & 1)
                     for c in probes}}


def _c4_queries(o):
    """(name, PQL, expected answer) of path 7's timed queries."""
    def pairs(ranked):
        return [(r, c) for r, c in ranked]

    incl = [(f"IncludesColumn(Row(cab=1, {C4_RANGE}), column={c})", want)
            for c, want in o["includes"].items()]
    return [
        ("ranged Count", f"Count(Row(cab=1, {C4_RANGE}))", o["count"]),
        ("ranged TopN", f"TopN(cab, n=4, {C4_RANGE})", pairs(o["top"])),
        ("full-year TopN", "TopN(cab, from='2010-01-01T00:00', "
         "to='2011-01-01T00:00')", pairs(o["year_top"])),
        ("two half-years Count", "Count(Union(Row(cab=1, %s), "
         "Row(cab=1, %s)))" % C4_HALVES, o["year_count"]),
        ("two half-years UnionRows", "Count(UnionRows(Rows(cab, %s), "
         "Rows(cab, %s)))" % C4_HALVES, o["year_union"]),
        ("ranged Rows", f"Rows(cab, {C4_RANGE})", o["rows"]),
        ("Count(UnionRows)", f"Count(UnionRows(Rows(cab, {C4_RANGE})))",
         o["union"]),
        ("Count(Shift)", f"Count(Shift(Row(cab=1, {C4_RANGE}), n=1))",
         o["shift"]),
    ] + [(f"IncludesColumn #{i}", q, want)
         for i, (q, want) in enumerate(incl)]


def _answer(res):
    """A result as the oracle states it."""
    if hasattr(res, "pairs"):
        return [(p.id, p.count) for p in res.pairs]
    return res


def _c4_small() -> dict:
    """Path 7's small index: the row-set calls that do not scale (a keyed
    ``time`` field, a set field, an ``int`` field with negatives, three
    shards) against a Python oracle."""
    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.pql import result as R
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH as SW

    rng = np.random.default_rng(41)
    api = API()
    api.create_index("s")
    api.create_field("s", "t", {"type": "time", "timeQuantum": "YMD",
                                "keys": True})
    api.create_field("s", "s")
    api.create_field("s", "v", {"type": "int"})
    t_bits = {}  # key -> {view: set of cols}
    cols = rng.integers(0, 3 * SW, 60)
    for k, c in enumerate(cols):
        key, month = f"k{k % 5}", 3 + k % 4
        api.query("s", f'Set({int(c)}, t="{key}", '
                       f"2010-{month:02d}-{1 + k % 27:02d}T08:00)")
        t_bits.setdefault(key, {}).setdefault(month, set()).add(int(c))
    s_rows, s_cols = rng.integers(0, 6, 3000), rng.integers(0, 3 * SW, 3000)
    api.import_bits("s", "s", rows=s_rows, cols=s_cols)
    v_cols = np.unique(rng.integers(0, 3 * SW, 500))
    v_vals = rng.integers(-300, 300, v_cols.size)
    api.import_values("s", "v", cols=v_cols, values=v_vals)
    s1 = sorted({int(c) for r, c in zip(s_rows, s_cols) if r == 1})
    got = {}

    def check(pql, want):
        res = api.query("s", pql)[0]
        if isinstance(res, R.RowResult):
            res = res.columns
        assert res == want, f"{pql}: {res!r} != {want!r}"
        got[pql] = res

    const = [3, SW + 9, 2 * SW - 1, 5 * SW]  # the last is on no shard
    check(f"ConstRow(columns={const})", const[:3])
    check("Limit(Row(s=1), limit=5, offset=3)", s1[3:8])
    check("Limit(Row(s=1), limit=4)", s1[:4])
    check("Distinct(field=s)", sorted(set(int(r) for r in s_rows)))
    check("Distinct(Row(v > 100), field=v)",
          sorted({int(v) for v in v_vals if v > 100}))
    check("Count(Distinct(field=v))", len(set(int(v) for v in v_vals)))
    s2 = {int(c) for r, c in zip(s_rows, s_cols) if r == 2}
    check("Distinct(Row(s=2), field=v)",
          sorted({int(v) for c, v in zip(v_cols, v_vals) if int(c) in s2}))
    col = int(cols[7])
    check(f"Rows(t, column={col})", sorted(
        k for k, by in t_bits.items() if any(col in s for s in by.values())))
    check("Rows(s, previous=2)", [3, 4, 5])
    check('Rows(t, in=["k1", "zz", "k3"])', ["k1", "k3"])
    check('Rows(t, previous="k2", limit=1)', ["k3"])
    check("Rows(t, from='2010-05-01T00:00', to='2010-07-01T00:00')",
          sorted(k for k, by in t_bits.items() if {5, 6} & set(by)))
    k1 = sorted(set().union(*[s for m, s in t_bits["k1"].items()
                              if m in (3, 4)]))
    check("Row(t=\"k1\", from='2010-03-01T00:00', to='2010-05-01T00:00')",
          k1)
    return {"api": api, "answers": got}


def _c4_kernels(report, api, rates) -> dict:
    """tape_count at the ranged Count's 5 leaves and at 13 (a zero leaf
    and the 12 month views), pair_counts at the ranged TopN's 1 x 4, and
    the TopN's merge, on the resident view stacks: each against its plain
    version, timed, beside its bound (these launches are not counted)."""
    import torch

    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.pql import programs as P
    from pilosa_tpu_torch.pql.parser import parse

    mem_rate, popc_rate, lop_rate = rates
    idx = api.holder.index("t")
    f = idx.field("cab")
    shards = list(range(C4_SHARDS))
    out = {}
    tape5, leaves5 = P._lower_root(
        api.executor, idx, parse(f"Count(Row(cab=1, {C4_RANGE}))")
        .calls[0].children[0], shards)
    assert len(leaves5) == 5 and len(tape5) == 4, (tape5, len(leaves5))
    w = leaves5[0].numel()
    leaves13 = [B.device_zeros(w, leaves5[0].device)] + [
        STK.stacked_set(f, shards, v).row_plane(1) for v in C4_MONTHS]
    tape13 = tuple(("or", 0 if k == 0 else 12 + k, k + 1)
                   for k in range(12))
    for name, tape, leaves in (("5 leaves", tape5, leaves5),
                               ("13 leaves", tape13, leaves13)):
        report.err("tape_count", B.tape_count(tape, leaves),
                   B.tape_count_plain(tape, leaves))
        n_ops = len(tape)
        by_bytes = (len(leaves) * w * 4 + 4) / mem_rate * 1e3
        by_ops = (n_ops * w / lop_rate + w / popc_rate) * 1e3
        out[f"tape_count {name}"] = {
            "shape": f"{len(leaves)} leaves x {w} words, {n_ops} ORs",
            "ms": _time_ms(lambda: B.tape_count(tape, leaves)),
            "kernel_ms": _device_ms(lambda: B.tape_count(tape, leaves),
                                    "tape_"),
            "plain_ms": _time_ms(lambda: B.tape_count_plain(tape, leaves),
                                 reps=2, trials=3),
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    months = [STK.stacked_set(f, shards, v) for v in C4_MONTHS[2:6]]
    rows = list(range(C4_ROWS))

    def merge():
        merged = months[0].take_rows(rows)
        for s in months[1:]:
            merged.bitwise_or_(s.take_rows(rows))
        return merged

    merged = merge()
    ones = B.device_ones(w, merged.device).reshape(1, -1)
    report.err("pair_counts", G.pair_counts(ones, merged),
               G.pair_counts_plain(ones, merged))
    by_bytes = (5 * w * 4 + 16) / mem_rate * 1e3
    by_ops = 2 * 4 * w * 32 / INT8_OPS_PER_S * 1e3
    out["pair_counts 1 x 4"] = {
        "shape": f"1 x 4 x {w} words",
        "ms": _time_ms(lambda: G.pair_counts(ones, merged)),
        "kernel_ms": _device_ms(lambda: G.pair_counts(ones, merged),
                                "pc_"),
        "plain_ms": _time_ms(lambda: G.pair_counts_plain(ones, merged),
                             reps=2, trials=3),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    # the merge reads 4 views x 4 rows and writes 4 rows (4 gathers and
    # 3 in-place ORs, plain PyTorch as XLA in the JAX package)
    out["merge 4 views x 4 rows"] = {
        "ms": _time_ms(merge, reps=3, trials=5),
        "device_ms": _device_ms(merge, calls=5),
        "bound_ms": (4 * 4 * w * 4 + 4 * w * 4 + 3 * 2 * 4 * w * 4)
        / mem_rate * 1e3}
    del merged
    torch.cuda.synchronize()
    return out


def phase_time(report: Report, args, rates) -> dict:
    """Path 7: ``BASELINE.json`` config 4 at full size (time-quantum
    Row+Count across 256 shards), its ranged reads and writes, and the
    row-set calls on a small index."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH as SW

    lab = report.label
    t0 = time.perf_counter()
    api, host = _config4_build()
    build_s = time.perf_counter() - t0
    f = api.holder.index("t").field("cab")
    shards = list(range(C4_SHARDS))
    queries = _c4_queries(_c4_oracle(host))
    q_count = queries[0][1]

    KU.reset_launches()
    t0 = time.perf_counter()
    got = api.query("t", q_count)[0]  # builds the four month stacks
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    assert got == queries[0][2], (got, queries[0][2])
    first = {}
    for name, q, want in queries:
        t0 = time.perf_counter()
        got = _answer(api.query("t", q)[0])
        torch.cuda.synchronize()
        first[name] = (time.perf_counter() - t0) * 1e3
        assert got == want, f"{name}: {got} != {want}"
    stacks = [STK.stacked_set(f, shards, v) for v in C4_MONTHS]
    assert all(st.n_blocks == 1 and isinstance(st._blocks[0], torch.Tensor)
               for st in stacks), "a month view is paged or compressed"
    resident = sum(STK._nbytes(st._blocks[0]) for st in stacks)
    # 12 x 4 rows x 256 shards x 32,768 words x 4 B = 1,610,612,736 B
    assert resident == 12 * stacks[0].cap * C4_SHARDS * 32768 * 4, resident
    del stacks

    # p50s on resident stacks: no stack may be built or evicted inside a
    # timed loop (the budget's entries stay the same)
    p50, busy = {}, {}
    for name, q, want in queries:
        keys = set(STK.BUDGET._lru)
        p50[name] = statistics.median(
            _wall_ms(lambda: api.query("t", q)) for _ in range(11))
        busy[name] = _device_ms(lambda: api.query("t", q), calls=11)
        assert set(STK.BUDGET._lru) == keys, \
            f"{name}: a stack was built or evicted inside the timed loop"
        assert _answer(api.query("t", q)[0]) == want, name
    # the device ops of a ranged Count, TopN (its merge) and UnionRows
    ops = {name: _device_ops(lambda: api.query("t", q), calls=11)
           for name, q, _ in queries if name in (
               "ranged Count", "ranged TopN", "Count(UnionRows)")}

    small = _c4_small()

    # writes: 32 rounds of Set(c, cab=r, 2010-0M-DDTHH:MM) into March to
    # June, each followed by the ranged Count. A bit new to its month
    # view advances that view's stack and uploads none.
    read_months = C4_MONTHS[2:6]
    models = {v: _LogModel() for v in C4_MONTHS}
    ex = _Expect(STK)
    extra = {}  # year and day view -> row -> columns written
    row1 = host[read_months[0]][1].copy()
    for v in read_months[1:]:
        row1 |= host[v][1]
    count = _popcount(row1)
    rng = np.random.default_rng(44)
    write_ms = []
    for i in range(32):
        month, day = 3 + i % 4, 1 + (i * 5) % 28
        view = f"standard_2010{month:02d}"
        r = int(rng.integers(0, C4_ROWS))
        while True:  # a column whose bit is new to the month view
            c = int(rng.integers(0, C4_SHARDS * SW))
            if not _has_bit(host[view][r], c):
                break
        stamp = f"2010-{month:02d}-{day:02d}T{i % 24:02d}:{i % 60:02d}"
        t0 = time.perf_counter()
        api.query("t", f"Set({c}, cab={r}, {stamp})")
        got = api.query("t", q_count)[0]
        write_ms.append((time.perf_counter() - t0) * 1e3)
        host[view][r, c // 32] |= np.uint32(1 << (c % 32))
        if r == 1 and not _has_bit(row1, c):
            row1[c // 32] |= np.uint32(1 << (c % 32))
            count += 1
        assert got == count, f"round {i}: {got} != {count}"
        models[view].record()
        for v in read_months:
            ex.read(models[v])
        for v in ("standard_2010", f"standard_2010{month:02d}{day:02d}"):
            extra.setdefault(v, {}).setdefault(r, set()).add(c)
    rounds = ex.check("7 write rounds")
    assert rounds["advanced"] == 32 and rounds["uploads"] == 0, rounds
    for v in read_months:
        _same_as_rebuild(STK.stacked_set(f, shards, v))

    # a range that starts mid-March reads the day views the writes made
    # (each a build) beside the advanced April-June stacks (hits)
    q_days = ("Count(Row(cab=1, from='2010-03-15T00:00', "
              "to='2010-07-01T00:00'))")
    days = sorted(v for v in extra if v.startswith("standard_201003")
                  and len(v) == 17 and int(v[-2:]) >= 15)
    for v in days:
        fresh = _LogModel()
        fresh.reset()  # never built: the first read builds it
        ex.read(fresh)
    for v in read_months[1:]:
        ex.read(models[v])
    plane = host[read_months[1]][1].copy()
    for v in read_months[2:]:
        plane |= host[v][1]
    in_days = set().union(*[extra[v].get(1, set()) for v in days]) \
        if days else set()
    want = _popcount(plane) + sum(1 for c in in_days
                                  if not _has_bit(plane, c))
    t0 = time.perf_counter()
    got = api.query("t", q_days)[0]
    days_ms = (time.perf_counter() - t0) * 1e3
    assert got == want, (got, want)
    day_seg = ex.check("7 day views")
    assert day_seg["built"] == len(days) >= 1, (day_seg, days)
    # the year view holds only what the writes put there: a build
    year = extra["standard_2010"]
    want_top = sorted(((r, len(cs)) for r, cs in year.items()),
                      key=lambda rc: (-rc[1], rc[0]))
    fresh = _LogModel()
    fresh.reset()
    ex.read(fresh)
    got = _answer(api.query("t", queries[2][1])[0])
    assert got == want_top, (got, want_top)
    year_seg = ex.check("7 year view")
    torch.cuda.synchronize()
    launched = KU.launches()
    report.launched("time", launched, ("tape_count", "pair_counts",
                                       "bsi_compare"))

    # each kernel of the path against its plain version (not counted)
    kern = _c4_kernels(report, api, rates)
    st = STK.stacked_bsi(small["api"].holder.index("s").field("v"),
                         [0, 1, 2])
    report.err("bsi_compare", S.bsi_compare(st.planes, S.GT, 100),
               S.bsi_compare_plain(st.planes, S.GT, 100))
    report.kernel("tape_count", config4={
        k: v for k, v in kern.items() if k.startswith("tape_count")})
    report.kernel("pair_counts", config4=kern["pair_counts 1 x 4"])

    print(f"time path: config 4 built ({C4_SHARDS} shards, {C4_ROWS} rows, "
          f"12 month views through Field.write_row_plane) in {build_s:.3f} "
          f"s; first query {first_s:.3f} s (builds 4 month stacks); "
          f"resident month stacks {resident} B {lab}")
    for name, q, _ in queries:
        b = busy[name]
        print(f"time path: {name}: first {first[name]:.3f} ms, p50 "
              f"{p50[name]:.3f} ms, device busy {_fmt_ms(b)}"
              + (f" ({100 * b / p50[name]:.1f}%)" if b else "")
              + f" -- {q} {lab}")
    for name, table in ops.items():
        print(f"time path: {name} device ops per query: " + ", ".join(
            f"{k} x{n / 11:.2f} {ms:.4f} ms" for k, (n, ms) in
            table.items()) + f" {lab}")
    for name, k in kern.items():
        print(f"time path: {name}: " + ", ".join(
            f"{a} {_fmt_ms(b) if isinstance(b, float) or b is None else b}"
            for a, b in k.items()) + f" {lab}")
    print(f"time path: 32 write rounds (Set with a timestamp, then the "
          f"ranged Count): {rounds['advanced']} advances, {rounds['built']} "
          f"builds, {rounds['uploads']} uploads, {rounds['mask_bytes']} mask "
          f"B; write->visible median {statistics.median(write_ms):.3f} ms; "
          f"the range from 03-15 built {day_seg['built']} day views "
          f"({day_seg['uploads']} uploads) in {days_ms:.3f} ms; the year "
          f"view: {year_seg['built']} build {lab}")
    print(f"time path: small index: {len(small['answers'])} row-set "
          f"queries match; launches {launched} {lab}")
    print("time path: " + json.dumps({
        "build_s": build_s, "first_query_s": first_s,
        "resident_bytes": resident, "p50_ms": p50, "busy_ms": busy,
        "write_visible_ms": statistics.median(write_ms),
        "kernels": kern}))
    print("time path: every answer matches numpy")
    return {"api": api, "host": host}


#: BASELINE.json config 5 (bench.py bench_config5): 64 shards x 2^20 rows
C5_SHARDS = 64


def _config5_build():
    """Config 5 as ``bench.py`` builds it: per shard ``fare`` and
    ``dist`` float32 columns from seed 5, one ``API.import_dataframe``
    per shard; returns the API and the host columns ``[S, 2^20]``."""
    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH as SW

    rng = np.random.default_rng(5)
    api = API()
    api.create_index("df")
    fare = np.empty((C5_SHARDS, SW), dtype=np.float32)
    dist = np.empty((C5_SHARDS, SW), dtype=np.float32)
    pos = np.arange(SW)
    for s in range(C5_SHARDS):
        fare[s] = rng.random(SW, dtype=np.float32) * 100
        dist[s] = rng.random(SW, dtype=np.float32) * 30
        api.import_dataframe("df", s, pos, {"fare": fare[s], "dist": dist[s]})
    return api, fare, dist


def phase_dataframe(report: Report, args, mem_rate: float) -> None:
    """Path 8: ``BASELINE.json`` config 5 at full size (the dataframe's
    Apply float aggregation over 67,108,864 rows), its reductions against
    numpy, and filtered Apply / Arrow over a few thousand records."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH as SW

    lab = report.label
    KU.reset_launches()
    t0 = time.perf_counter()
    api, fare, dist = _config5_build()
    import_s = time.perf_counter() - t0
    rows = C5_SHARDS * SW
    x32 = fare + dist * np.float32(2)  # the expression, as the card rounds it
    x64 = fare.astype(np.float64) + dist.astype(np.float64) * 2
    sum_q = 'Apply("sum(fare + dist * 2)")'
    t0 = time.perf_counter()
    got_sum = api.query("df", sum_q)[0].value  # stacks and uploads 604 MB
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    want_sum = float(x64.sum())
    assert abs(got_sum - want_sum) <= 1e-4 * abs(want_sum), (got_sum,
                                                             want_sum)
    exact = {'Apply("min(fare + dist * 2)")': float(x32.min()),
             'Apply("max(fare + dist * 2)")': float(x32.max()),
             'Apply("count(fare + dist * 2)")': rows}
    for q, want in exact.items():
        got = api.query("df", q)[0].value
        assert got == want, f"{q}: {got} != {want}"
    got_mean = api.query("df", 'Apply("mean(fare + dist * 2)")')[0].value
    want_mean = float(x64.mean())
    assert abs(got_mean - want_mean) <= 1e-4 * abs(want_mean), (got_mean,
                                                                want_mean)
    # a few thousand seeded records across the shards, as a ConstRow
    rng = np.random.default_rng(args.seed + 5)
    picked = np.sort(rng.choice(rows, 4096, replace=False))
    const = "ConstRow(columns=[" + ",".join(map(str, picked)) + "])"
    flat_fare = fare.reshape(-1)
    got = api.query("df", f'Apply({const}, "sum(fare)")')[0].value
    want = float(flat_fare[picked].astype(np.float64).sum())
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    got = api.query("df", f'Apply({const}, "fare * 2")')[0].value
    assert got == [float(v) for v in flat_fare[picked] * np.float32(2)], \
        "vector Apply disagrees"
    got = api.query("df", f'Arrow({const}, header=["fare"])')[0]
    assert [f.name for f in got.fields] == ["fare"]
    assert got.ids == picked.tolist(), "Arrow ids disagree"
    assert got.columns == [[float(v) for v in flat_fare[picked]]], \
        "Arrow values disagree"
    torch.cuda.synchronize()
    launched = KU.launches()
    # the Apply path runs no hand-written kernel: eager torch ops only
    report.launched("dataframe", launched, ())

    store = api.holder.index("df").dataframe
    cols, valid, cap = store.device_columns(["dist", "fare"],
                                            list(range(C5_SHARDS)))
    assert cap == SW and valid.is_cuda and all(
        c.is_cuda for c in cols.values()), "the columns are not on the card"
    resident = valid.numel() * valid.element_size() + sum(
        c.numel() * c.element_size() for c in cols.values())
    # two float32 columns and a bool validity: 603,979,776 B at 64 shards
    assert resident == rows * (4 + 4 + 1), resident
    bound_ms = resident / mem_rate * 1e3  # each input read once
    p50 = {}
    for label, q in (("sum", sum_q), ("mean", 'Apply("mean(fare + dist * 2)")'),
                     ("filtered sum of 4096 rows",
                      f'Apply({const}, "sum(fare)")')):
        p50[label] = statistics.median(
            _wall_ms(lambda q=q: api.query("df", q)) for _ in range(11))
    calls = 11
    ops = _device_ops(lambda: api.query("df", sum_q), calls=calls)
    # each op runs once a query; a trace loses events, so the busy time
    # is the sum of the ops' mean times
    _once_per_call(ops, calls, len(ops))
    busy = sum(ms for _, ms in ops.values())
    print(f"dataframe path: config 5, {C5_SHARDS} shards x {SW} rows "
          f"({rows}); import {import_s:.3f} s; first Apply (stacks and "
          f"uploads {resident} B) {first_s:.3f} s; launches {launched} {lab}")
    print(f"dataframe path: sum {got_sum!r} against numpy float64 "
          f"{want_sum!r} (rel {abs(got_sum - want_sum) / want_sum:.2e}); "
          f"mean rel {abs(got_mean - want_mean) / want_mean:.2e}; min, max "
          f"and count exact {lab}")
    for label, ms in p50.items():
        print(f"dataframe path: p50 of the {label} {ms:.3f} ms {lab}")
    print(f"dataframe path: {sum_q}: device busy {busy:.4f} ms per query "
          f"({100 * busy / p50['sum']:.1f}% of its p50) in {len(ops)} "
          f"device ops (events in a trace of {calls} queries): "
          + ", ".join(f"{k} x {name} at {ms:.4f} ms"
                      for name, (k, ms) in ops.items())
          + f"; bytes bound {bound_ms:.4f} ms ({resident} B at "
          f"{mem_rate / 1e12:.2f} TB/s) {lab}")
    print("dataframe path: " + json.dumps({
        "import_s": import_s, "first_query_s": first_s,
        "resident_bytes": resident, "p50_ms": p50, "busy_ms": busy,
        "device_ops_per_query": len(ops),
        "bound_ms": bound_ms}))
    print("dataframe path: every answer matches numpy")
    store.delete()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Path 9: the serving layer (bench.py configs 6-8, fused masked waves)
# ---------------------------------------------------------------------------


class _ServingProbe:
    """What a fused wave did, counted by wrapping the executor's and the
    scheduler's functions while the probe is open: the host's blocking
    waits (``_wait_copies``) and those inside each ``execute_many``, the
    sizes of the batches the scheduler dispatched, solo ``execute``
    calls, ``execute_batch`` fallbacks (an entry re-run alone inside a
    batch of several) and the mask planes built and found in the LRU.
    The port needs no counter of its own for these."""

    def __init__(self):
        import threading

        from pilosa_tpu_torch.pql import executor as EX
        from pilosa_tpu_torch.sched import batch as BAT
        from pilosa_tpu_torch.sched import scheduler as SCH

        self.EX, self.BAT, self.SCH = EX, BAT, SCH
        self.tls = threading.local()
        self.lock = threading.Lock()
        self.reset()
        self._orig = (EX._wait_copies, EX._mask_plane, BAT._run_single,
                      SCH.execute_batch)
        wait0, mask0, single0, batch0 = self._orig
        probe = self

        def wait(ev):
            with probe.lock:
                probe.waits += 1
            if getattr(probe.tls, "fused", None) is not None:
                probe.tls.fused += 1
            return wait0(ev)

        def mask_plane(shard_list, subset, device):
            with EX._MASK_LOCK:
                hit = (str(device), shard_list, subset) in EX._MASK_PLANES
            with probe.lock:
                probe.masks[0 if hit else 1] += 1
            return mask0(shard_list, subset, device)

        def run_single(executor, entry):
            if getattr(probe.tls, "batch", 1) > 1:
                with probe.lock:
                    probe.fallbacks += 1
            return single0(executor, entry)

        def execute_batch(executor, entries):
            probe.tls.batch = len(entries)
            with probe.lock:
                probe.batches.append(len(entries))
            try:
                return batch0(executor, entries)
            finally:
                probe.tls.batch = 1

        EX._wait_copies, EX._mask_plane = wait, mask_plane
        BAT._run_single, SCH.execute_batch = run_single, execute_batch

    def reset(self) -> None:
        self.waits = 0
        self.fused_waits = []  # waits inside each execute_many call
        self.batches = []
        self.solo = 0
        self.fallbacks = 0
        self.masks = [0, 0]  # found, built

    def watch(self, api) -> None:
        """Count the solo and fused calls of ``api``'s executor."""
        ex = api.executor
        cls = type(ex)
        probe = self

        def execute(index, query, shards=None):
            with probe.lock:
                probe.solo += 1
            return cls.execute(ex, index, query, shards)

        def execute_many(index, queries, shards=None, per_query_shards=None):
            probe.tls.fused = 0
            try:
                return cls.execute_many(ex, index, queries, shards=shards,
                                        per_query_shards=per_query_shards)
            finally:
                with probe.lock:
                    probe.fused_waits.append(probe.tls.fused)
                probe.tls.fused = None

        ex.execute, ex.execute_many = execute, execute_many

    @staticmethod
    def unwatch(api) -> None:
        del api.executor.execute
        del api.executor.execute_many

    def close(self) -> None:
        EX, BAT, SCH = self.EX, self.BAT, self.SCH
        (EX._wait_copies, EX._mask_plane, BAT._run_single,
         SCH.execute_batch) = self._orig


def _pct_ms(lat_s, p: float) -> float:
    """The ``p`` quantile of latencies in seconds, in ms, as bench.py
    takes it (the sorted sample at ``int(p * n)``)."""
    lat = sorted(lat_s)
    return lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3


def _free_wave(api, index, queries, shards=None):
    """Every query from its own thread at once through ``api.query``, as
    bench.py's configs 6 and 8 run them: (answers, per-query seconds,
    wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(i):
        t0 = time.perf_counter()
        r = api.query(index, queries[i],
                      shards=None if shards is None else shards[i])[0]
        return r, time.perf_counter() - t0

    with ThreadPoolExecutor(len(queries)) as pool:
        t0 = time.perf_counter()
        futs = [pool.submit(timed, i) for i in range(len(queries))]
        out = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
    return [r for r, _ in out], [s for _, s in out], wall


def _staged_wave(api, index, queries, shards):
    """Every query submitted from its own thread while the scheduler is
    paused, then released at once, so the wave is one fused dispatch per
    op family: (answers, seconds from the release to each answer, wall
    seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    sched = api.scheduler
    sched.pause()
    done = {}

    def one(i):
        r = api.query(index, queries[i], shards=shards[i])[0]
        done[i] = time.perf_counter()
        return r

    with ThreadPoolExecutor(len(queries)) as pool:
        futs = [pool.submit(one, i) for i in range(len(queries))]
        assert sched.wait_queued(len(queries), timeout=60) == len(queries)
        t0 = time.perf_counter()
        sched.resume()
        out = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
    return out, [done[i] - t0 for i in range(len(queries))], wall


def _counters(reg, prefix: str) -> float:
    return sum(v for k, v in reg.as_json()["counters"].items()
               if k.startswith(prefix))


def _c67_build(seed: int, name: str):
    """Config 6 or 7 as bench.py builds it: 1,000,000 records of seed
    ``seed``, set fields ``city`` (50 rows) and ``device`` (10), one
    shard."""
    import numpy as np

    from pilosa_tpu_torch.api import API

    rng = np.random.default_rng(seed)
    n = 1_000_000
    city = rng.integers(0, 50, n)
    dev = rng.integers(0, 10, n)
    api = API()
    api.create_index(name)
    api.create_field(name, "city")
    api.create_field(name, "device")
    cols = np.arange(n)
    api.import_bits(name, "city", rows=city, cols=cols)
    api.import_bits(name, "device", rows=dev, cols=cols)
    return api, city, dev


def _serving_config6(probe, lab) -> dict:
    """9a: bench.py config 6, 64 Intersect Counts with the scheduler off,
    then from 64 threads with it on; one fused batch under the sync
    debug mode."""
    import numpy as np

    from pilosa_tpu_torch.obs.metrics import MetricsRegistry

    api, city, dev = _c67_build(6, "c6")
    nq = 64
    queries = [f"Count(Intersect(Row(city={i % 50}), Row(device={i % 10})))"
               for i in range(nq)]
    want = [int(np.sum((city == i % 50) & (dev == i % 10)))
            for i in range(nq)]
    assert api.query("c6", queries[0]) == [want[0]]  # builds the stacks
    off, t0 = [], time.perf_counter()
    for q, w in zip(queries, want):
        t1 = time.perf_counter()
        assert api.query("c6", q) == [w]
        off.append(time.perf_counter() - t1)
    off_wall = time.perf_counter() - t0
    reg = MetricsRegistry()
    api.enable_scheduler(window_ms=2.0, max_batch=nq, registry=reg)
    probe.reset()
    probe.watch(api)
    try:
        got, on, on_wall = _free_wave(api, "c6", queries)
    finally:
        probe.unwatch(api)
        api.disable_scheduler()
    assert got == want, "config 6: a batched answer disagrees with numpy"
    assert probe.fallbacks == 0, f"{probe.fallbacks} solo fallbacks"
    assert probe.fused_waits and all(w == 1 for w in probe.fused_waits), \
        f"waits per fused Count batch {probe.fused_waits}"
    batches = _counters(reg, "sched_batches_total")
    # the implicit syncs one fused batch of the 64 Counts makes
    fused, syncs = _implicit_syncs(
        lambda: api.executor.execute_many("c6", queries))
    assert [r[0] for r in fused] == want
    fused_ms = statistics.median(
        _wall_ms(lambda: api.executor.execute_many("c6", queries))
        for _ in range(5))
    fused_busy = _device_ms(lambda: api.executor.execute_many("c6", queries),
                            calls=5)
    out = {
        "qps_off": nq / off_wall, "qps_on": nq / on_wall,
        "p50_off_ms": _pct_ms(off, 0.5), "p99_off_ms": _pct_ms(off, 0.99),
        "p50_on_ms": _pct_ms(on, 0.5), "p99_on_ms": _pct_ms(on, 0.99),
        "sched_batches_total": batches, "batch_sizes": probe.batches,
        "waits_per_fused_batch": probe.fused_waits,
        "solo_executes": probe.solo, "fallbacks": probe.fallbacks,
        "implicit_syncs_in_one_fused_batch": len(syncs),
        "fused_batch_of_64_ms": fused_ms, "fused_batch_busy_ms": fused_busy}
    print(f"serving path: 9a config 6 (1,000,000 records, 60 rows x "
          f"131,072 B of stacks): scheduler off {out['qps_off']:.1f} QPS, "
          f"p50 {out['p50_off_ms']:.3f} ms, p99 {out['p99_off_ms']:.3f} ms; "
          f"on (64 threads, window 2 ms) {out['qps_on']:.1f} QPS, p50 "
          f"{out['p50_on_ms']:.3f} ms, p99 {out['p99_on_ms']:.3f} ms; "
          f"sched_batches_total {batches:g} (sizes {probe.batches}); waits "
          f"per fused batch {probe.fused_waits}; solo executes "
          f"{probe.solo} (batches of one), fallbacks {probe.fallbacks}; "
          f"implicit syncs in one fused batch of 64: {len(syncs)}"
          + (f" ({syncs[0]})" if syncs else "") + f"; that batch alone "
          f"(execute_many of the 64, no scheduler) {fused_ms:.3f} ms, busy "
          f"{_fmt_ms(fused_busy)} {lab}")
    del api
    return out


def _implicit_syncs(fn):
    """(``fn()``, the Python line, as ``file:line``, of each implicit
    host sync that ``torch.cuda.set_sync_debug_mode("warn")`` reports
    while it runs)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice that it is a prototype is not a sync
    return res, [f"{os.path.basename(w.filename)}:{w.lineno}"
                 for w in caught if "prototype" not in str(w.message)]


def _serving_config7(lab) -> dict:
    """9b: bench.py config 7, one Intersect Count with the cache off,
    cold, warm and write-invalidated."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.obs.metrics import MetricsRegistry
    from pilosa_tpu_torch.ops import kernel_util as KU

    api, city, dev = _c67_build(7, "c7")
    n = city.size
    q = "Count(Intersect(Row(city=3), Row(device=7)))"
    want = int(np.sum((city == 3) & (dev == 7)))
    assert api.query("c7", q) == [want]
    iters = 11

    def timed(expect):
        t0 = time.perf_counter()
        r = api.query("c7", q)[0]
        s = time.perf_counter() - t0
        assert r == expect, (r, expect)
        return s

    lat = {"off": [timed(want) for _ in range(iters)]}
    cache = api.enable_cache(registry=MetricsRegistry())
    try:
        lat["cold"] = []
        for _ in range(iters):
            cache.flush()
            lat["cold"].append(timed(want))
        timed(want)  # fill
        torch.cuda.synchronize()
        before = KU.launches()
        lat["warm"] = [timed(want) for _ in range(iters * 4)]
        warm_launches = {k: v - before[k] for k, v in KU.launches().items()}
        assert not any(warm_launches.values()), \
            f"a warm cache hit launched {warm_launches}"
        lat["write-invalidated"] = []
        exp = want
        for i in range(iters):
            api.query("c7", f"Set({n + i}, city=3)Set({n + i}, device=7)")
            exp += 1
            misses, tc = cache.stats()["misses"], \
                KU.launches()["tape_count"]
            lat["write-invalidated"].append(timed(exp))
            assert cache.stats()["misses"] == misses + 1, \
                "a read after a write was not a miss"
            assert KU.launches()["tape_count"] == tc + 1, \
                "a read after a write did not launch tape_count"
        stats = cache.stats()
    finally:
        api.disable_cache()
    out = {k: {"p50_ms": _pct_ms(v, 0.5), "p99_ms": _pct_ms(v, 0.99)}
           for k, v in lat.items()}
    out["warm_launches"] = warm_launches
    out["cache"] = stats
    print("serving path: 9b config 7: " + "; ".join(
        f"{k} p50 {v['p50_ms']:.3f} ms, p99 {v['p99_ms']:.3f} ms"
        for k, v in out.items() if "p50_ms" in v)
        + f"; warm phase launched nothing; every write-invalidated read a "
        f"miss with one tape_count launch; cache {stats} {lab}")
    del api
    return out


_FAMILY_QUERIES = [
    "Count(Row(city=1))", "Count(Intersect(Row(city=0), Row(device=1)))",
    "Count(Row(amt > 10))", "Row(city=2)", "Union(Row(city=0), Row(city=3))",
    "Difference(Row(city=1), Row(device=0))", "Xor(Row(city=1), Row(city=2))",
    "Not(Row(city=1))", "Shift(Row(city=4), n=2)",
    "UnionRows(Rows(city, limit=3))", "Limit(Row(city=0), limit=7, offset=2)",
    "Sum(Row(city=1), field=amt)", "Sum(field=amt)", "Min(field=amt)",
    "Max(Row(device=2), field=amt)", "Percentile(field=amt, nth=50)",
    "TopN(city, n=3)", "TopK(device, k=2)", "Rows(city)",
    "Rows(city, limit=2)", "GroupBy(Rows(city))",
    "GroupBy(Rows(city), Rows(device), aggregate=Sum(field=amt))",
    "Distinct(field=city)", "Count(Distinct(field=amt))"]


def _serving_config8(probe, report, lab) -> dict:
    """9c: bench.py config 8 (32 Counts over random 4-of-8 shard subsets,
    unfused and fused), then the fusion battery's families through
    ``execute_many(per_query_shards=...)`` against solo runs."""
    import random

    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.obs.metrics import MetricsRegistry
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(8)
    n_shards, per_shard = 8, 200_000
    api = API()
    api.create_index("c8")
    api.create_field("c8", "city")
    api.create_field("c8", "device")
    city_by, dev_by = [], []
    for shard in range(n_shards):
        city = rng.integers(0, 50, per_shard)
        dev = rng.integers(0, 10, per_shard)
        cols = shard * SHARD_WIDTH + np.arange(per_shard)
        api.import_bits("c8", "city", rows=city, cols=cols)
        api.import_bits("c8", "device", rows=dev, cols=cols)
        city_by.append(city)
        dev_by.append(dev)
    nq = 32
    subsets = [sorted(rng.choice(n_shards, size=4, replace=False).tolist())
               for _ in range(nq)]
    queries = [f"Count(Intersect(Row(city={i % 50}), Row(device={i % 10})))"
               for i in range(nq)]
    want = [int(sum(np.sum((city_by[s] == i % 50) & (dev_by[s] == i % 10))
                    for s in subsets[i])) for i in range(nq)]
    api.query("c8", queries[0], shards=subsets[0])
    api.executor.execute_many("c8", queries[:2], per_query_shards=subsets[:2])
    out = {}
    for label, ratio in (("unfused", 0.0), ("fused", 2.0)):
        reg = MetricsRegistry()
        api.enable_scheduler(window_ms=2.0, max_batch=nq,
                             fuse_waste_ratio=ratio, registry=reg)
        probe.reset()
        probe.watch(api)
        try:
            got, lat, wall = _free_wave(api, "c8", queries, subsets)
        finally:
            probe.unwatch(api)
            api.disable_scheduler()
        assert got == want, f"config 8 {label}: an answer disagrees"
        assert probe.fallbacks == 0, f"{probe.fallbacks} solo fallbacks"
        out[label] = {
            "dispatches": _counters(reg, "sched_batches_total"),
            "superset_merges": _counters(reg, "sched_superset_merges_total"),
            "p50_ms": _pct_ms(lat, 0.5), "p99_ms": _pct_ms(lat, 0.99),
            "qps": nq / wall, "solo_executes": probe.solo,
            "fallbacks": probe.fallbacks, "masks_found_built": probe.masks}

    # the fusion battery (tests/test_fusion.py's families) on 8 shards
    # with a BSI field
    b = API()
    b.create_index("fz")
    for f in ("city", "device"):
        b.create_field("fz", f)
    b.create_field("fz", "amt", {"type": "int", "min": -100, "max": 200})
    r = random.Random(1234)
    cols, cities, devices, vals = [], [], [], []
    for shard in range(n_shards):
        for i in r.sample(range(600), 80):
            cols.append(shard * SHARD_WIDTH + i)
            cities.append((i + shard) % 5)
            devices.append(i % 3)
            vals.append(r.randrange(-60, 120))
    b.import_bits("fz", "city", rows=cities, cols=cols)
    b.import_bits("fz", "device", rows=devices, cols=cols)
    b.import_values("fz", "amt", cols=cols, values=vals)
    sets = [[0, 1, 2, 3], [4, 5, 6, 7], [2], [1, 3, 5, 7],
            list(range(n_shards)), [0, 7]]
    # implicit syncs of each family's fused round: the first round
    # builds stacks and mask planes; the second finds them resident
    battery_syncs = {}
    for q in _FAMILY_QUERIES:
        def fused_round():
            return b.executor.execute_many("fz", [q] * len(sets),
                                           per_query_shards=sets)

        fused, cold = _implicit_syncs(fused_round)
        for s, res in zip(sets, fused):
            assert res == b.executor.execute("fz", q, shards=s), (q, s)
        again, warm = _implicit_syncs(fused_round)
        assert again == fused, q
        battery_syncs[q] = {"cold": len(cold), "warm": len(warm),
                            "warm_at": sorted(set(warm))}
    torch.cuda.synchronize()
    out["launches"] = KU.launches()
    # bsi_compare of the battery's Count(Row(amt > 10)) on its stack,
    # after the path's launches are read
    st = STK.stacked_bsi(b.holder.index("fz").field("amt"),
                         list(range(n_shards)))
    report.err("bsi_compare", S.bsi_compare(st.planes, S.GT, 10),
               S.bsi_compare_plain(st.planes, S.GT, 10))
    out["battery"] = {"families": len(_FAMILY_QUERIES), "subsets": sets,
                      "implicit_syncs_per_fused_round": battery_syncs}
    for label in ("unfused", "fused"):
        o = out[label]
        print(f"serving path: 9c config 8 {label} (fuse_waste_ratio "
              f"{0.0 if label == 'unfused' else 2.0}): dispatches "
              f"{o['dispatches']:g}, superset merges "
              f"{o['superset_merges']:g}, p50 {o['p50_ms']:.3f} ms, p99 "
              f"{o['p99_ms']:.3f} ms, {o['qps']:.1f} QPS, solo executes "
              f"{o['solo_executes']}, fallbacks {o['fallbacks']}, mask "
              f"planes found/built {o['masks_found_built']} {lab}")
    print(f"serving path: 9c fusion battery: {len(_FAMILY_QUERIES)} families "
          f"x {len(sets)} subsets through execute_many(per_query_shards) "
          f"equal to solo runs; implicit syncs in each family's fused round "
          f"{battery_syncs} {lab}")
    del api, b
    return out


def _complement_pairs(rng, n_shards: int, k: int, pairs: int):
    """``2 * pairs`` random ``k``-of-``n_shards`` subsets, each followed by
    its complement, so that every fused batch of them covers all the
    shards (the union layout is the resident one)."""
    out = []
    for _ in range(pairs):
        s = sorted(rng.choice(n_shards, size=k, replace=False).tolist())
        out += [s, sorted(set(range(n_shards)) - set(s))]
    return out


def _popcount_rows(a2d):
    """Set bits of each row of a uint32 ``[R, W]`` array."""
    import numpy as np

    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(a2d).sum(axis=1, dtype=np.int64)
    return np.array([_popcount(r) for r in a2d], dtype=np.int64)


def _masked_wave(probe, api, index, queries, subsets, want, label, lab,
                 answer=None):
    """One staged wave through the scheduler (fuse_waste_ratio 2.0) and the
    same batch straight through ``execute_many``, timed and traced; each
    answer, as ``answer`` states it, against ``want``."""
    answer = answer or _answer
    import statistics

    from pilosa_tpu_torch.obs.metrics import MetricsRegistry
    from pilosa_tpu_torch.pql import executor as EX

    reg = MetricsRegistry()
    api.enable_scheduler(window_ms=2.0, max_batch=len(queries),
                         fuse_waste_ratio=2.0, registry=reg)
    probe.reset()
    probe.watch(api)
    try:
        got, lat, wall = _staged_wave(api, index, queries, subsets)
        masks = list(probe.masks)
        solo, fallbacks = probe.solo, probe.fallbacks
    finally:
        probe.unwatch(api)
        api.disable_scheduler()
    for q, g, w in zip(queries, got, want):
        assert answer(g) == w, f"{label}: {q} disagrees with numpy"
    assert solo == 0 and fallbacks == 0, (label, solo, fallbacks)

    def fused():
        return api.executor.execute_many(index, queries,
                                         per_query_shards=subsets)

    assert [answer(r[0]) for r in fused()] == want
    wall_ms = statistics.median(_wall_ms(fused) for _ in range(5))
    busy_ms = _device_ms(fused, calls=3)
    out = {"dispatches": _counters(reg, "sched_batches_total"),
           "superset_merges": _counters(reg, "sched_superset_merges_total"),
           "masks_found": masks[0], "masks_built": masks[1],
           "mask_lru_bytes": EX.mask_plane_bytes(),
           "p50_ms": _pct_ms(lat, 0.5), "p99_ms": _pct_ms(lat, 0.99),
           "wave_ms": wall * 1e3, "fused_batch_ms": wall_ms,
           "fused_batch_busy_ms": busy_ms,
           "busy_share": None if busy_ms is None else busy_ms / wall_ms}
    print(f"serving path: 9d {label}: {len(queries)} queries, dispatches "
          f"{out['dispatches']:g}, superset merges "
          f"{out['superset_merges']:g}, mask planes found "
          f"{masks[0]} / built {masks[1]}, mask LRU "
          f"{out['mask_lru_bytes']} B on the card; p50 "
          f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms from the "
          f"release; the fused batch {wall_ms:.3f} ms, busy "
          f"{_fmt_ms(busy_ms)}"
          + ("" if busy_ms is None else
             f" ({100 * out['busy_share']:.1f}%)") + f" {lab}")
    return out


def _serving_full_width(probe, report, ssb, by_date, c4, rates, lab) -> dict:
    """9d: fused masked waves on the indexes paths 1, 3 and 7 built, and
    each kernel they launch held against its plain version on those
    stacks and mask planes (launches for that are not counted)."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.pql import executor as EX
    from pilosa_tpu_torch.pql import programs as PR
    from pilosa_tpu_torch.pql.parser import parse
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

    mem_rate, popc_rate, lop_rate = rates
    rng = np.random.default_rng(9)
    out = {}
    KU.reset_launches()

    # config 4: 32 ranged Counts over 128-of-256 shard subsets
    api, host = c4["api"], c4["host"]
    months = C4_MONTHS[2:6]
    per_shard = {}
    for k in range(C4_ROWS):
        acc = host[months[0]][k].copy()
        for v in months[1:]:
            acc |= host[v][k]
        per_shard[k] = _popcount_rows(acc.reshape(C4_SHARDS, -1))
    subsets = _complement_pairs(rng, C4_SHARDS, C4_SHARDS // 2, 16)
    queries = [f"Count(Row(cab={i % C4_ROWS}, {C4_RANGE}))"
               for i in range(32)]
    want = [int(per_shard[i % C4_ROWS][subsets[i]].sum()) for i in range(32)]
    out["config4"] = _masked_wave(probe, api, "t", queries, subsets, want,
                                  "config 4 (256 shards, 12 month views)",
                                  lab)

    # SSB SF-1: Count(Intersect), TopN and GroupBy over 3-of-6 subsets
    api = ssb["api"]
    year_of, brand_of, names = ssb["year_of"], ssb["brand_of"], ssb["names"]
    bid = ssb["bid"]
    shard_of = np.arange(year_of.size) >> 20
    n_ssb = int(shard_of[-1]) + 1
    subsets = _complement_pairs(rng, n_ssb, n_ssb // 2, 8)
    queries, want = [], []
    for i, s in enumerate(subsets):
        sel = np.isin(shard_of, s)
        y, b = int(rng.integers(0, 7)), int(rng.integers(0, 1000))
        kind = ("count", "topn", "groupby")[i % 3] if i % 2 else "count"
        if kind == "count":
            queries.append(f'Count(Intersect(Row(year={y}), '
                           f'Row(brand="{names[b]}")))')
            want.append(int(np.sum(sel & (year_of == y) & (brand_of == b))))
        elif kind == "topn":
            queries.append(f"TopN(brand, Row(year={y}), n=10)")
            counts = np.bincount(brand_of[sel & (year_of == y)],
                                 minlength=1000)
            ranked = sorted((-int(c), bid[k], names[k])
                            for k, c in enumerate(counts) if c)[:10]
            want.append([(key, -c) for c, _, key in ranked])
        else:
            queries.append("GroupBy(Rows(year), Rows(brand))")
            table = np.bincount(year_of[sel] * 1000 + brand_of[sel],
                                minlength=7000).reshape(7, 1000)
            want.append(sorted((yy, bid[bb], int(table[yy, bb]))
                               for yy in range(7) for bb in range(1000)
                               if table[yy, bb]))
    key_bid = {names[k]: bid[k] for k in range(1000)}

    def ssb_answer(res):
        if isinstance(res, list):
            return [(g.group[0].row_id, key_bid[g.group[1].row_key], g.count)
                    for g in res]
        if hasattr(res, "pairs"):
            return [(p.key, p.count) for p in res.pairs]
        return res

    out["ssb"] = _masked_wave(probe, api, "ssb", queries, subsets, want,
                              f"SSB SF-1 ({n_ssb} shards)", lab, ssb_answer)

    # SSB by order date: TopN(orderdate), half filtered by year
    api = by_date["api"]
    date, year = by_date["date"], by_date["year"]
    shard_of = np.arange(date.size) >> 20
    n_date = int(shard_of[-1]) + 1
    subsets = _complement_pairs(rng, n_date, n_date // 2, 8)
    queries, want = [], []
    for i, s in enumerate(subsets):
        sel = np.isin(shard_of, s)
        if i % 2:
            y = int(rng.integers(1992, 1999))
            queries.append(f"TopN(orderdate, Row(year={y}), n=10)")
            sel = sel & (year == y)
        else:
            queries.append("TopN(orderdate, n=10)")
        d, c = np.unique(date[sel], return_counts=True)
        want.append(_want_top(dict(zip(d.tolist(), c.tolist())), 10))
    out["ssb_by_date"] = _masked_wave(probe, api, "ssb_by_date", queries,
                                      subsets, want,
                                      f"SSB by order date ({n_date} shards)",
                                      lab)
    torch.cuda.synchronize()
    launched = KU.launches()

    # -- each kernel of the waves against its plain version, timed -------
    # Kernel times are taken twice: back to back (operands may sit in
    # the 50 MB L2) and with L2 flushed before each call, the time that
    # stands beside the bound.
    kern = {}
    flush = torch.empty(128 << 20, dtype=torch.int32,
                        device=c4["api"].holder.index("t").device)
    api = c4["api"]
    idx = api.holder.index("t")
    shards = list(range(C4_SHARDS))
    mask = EX.ShardMask(shards, set(range(0, C4_SHARDS, 2)), idx.device)
    tape, leaves = PR._lower_root(
        api.executor, idx, parse(f"Count(Row(cab=1, {C4_RANGE}))")
        .calls[0].children[0], shards)
    w = leaves[0].numel()
    report.err("tape_count", B.tape_count(tape, leaves, mask.plane),
               B.tape_count_plain(tape, leaves, mask.plane))
    by_bytes = ((len(leaves) + 1) * w * 4 + 4) / mem_rate * 1e3
    by_ops = ((len(tape) + 1) * w / lop_rate + w / popc_rate) * 1e3
    kern["tape_count masked"] = {
        "shape": f"{len(leaves)} leaves + a mask x {w} words, "
                 f"{len(tape)} ORs",
        "ms": _time_ms(lambda: B.tape_count(tape, leaves, mask.plane)),
        "kernel_ms": _device_ms(
            lambda: B.tape_count(tape, leaves, mask.plane), "tape_"),
        "kernel_ms_l2_flushed": _device_ms(
            lambda: B.tape_count(tape, leaves, mask.plane), "tape_",
            flush=flush),
        "plain_ms": _time_ms(
            lambda: B.tape_count_plain(tape, leaves, mask.plane),
            reps=2, trials=3),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    del leaves

    api = ssb["api"]
    idx = api.holder.index("ssb")
    shards = list(range(n_ssb))
    mask = EX.ShardMask(shards, set(shards[::2]), idx.device)
    years = STK.stacked_set(idx.field("year"), shards, "standard").planes
    brand = STK.stacked_set(idx.field("brand"), shards, "standard")
    blk = STK._dense(brand._ensure_block(0))
    filt = S.mask_filter(None, mask.plane)

    def masked_plain():
        return G.pair_counts_plain((years & filt[None, :]).contiguous(), blk)

    report.err("pair_counts", G.masked_pair_counts(years, blk, filt),
               masked_plain())
    a_rows, w = years.shape[0], blk.shape[1]
    by_bytes = ((a_rows + blk.shape[0] + 1) * w * 4
                + a_rows * blk.shape[0] * 4) / mem_rate * 1e3
    by_ops = 2 * a_rows * blk.shape[0] * w * 32 / INT8_OPS_PER_S * 1e3
    kern["pair_counts masked filter"] = {
        "shape": f"{a_rows} year rows & a mask x {blk.shape[0]} "
                 f"brand rows x {w} words",
        "ms": _time_ms(lambda: G.masked_pair_counts(years, blk, filt)),
        "kernel_ms": _device_ms(
            lambda: G.masked_pair_counts(years, blk, filt), "pc_"),
        "kernel_ms_l2_flushed": _device_ms(
            lambda: G.masked_pair_counts(years, blk, filt), "pc_",
            flush=flush),
        "plain_ms": _time_ms(masked_plain, reps=1, trials=3),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    del years, blk

    api = by_date["api"]
    idx = api.holder.index("ssb_by_date")
    shards = list(range(n_date))
    mask = EX.ShardMask(shards, set(shards[1::2]), idx.device)
    od = STK.stacked_set(idx.field("orderdate"), shards, "standard")
    blocks = [b for b in (od._ensure_block(i) for i in range(od.n_blocks))
              if isinstance(b, C.CompressedBlock)]
    assert blocks, "no orderdate block is resident compressed"
    filt = mask.plane
    report.err("ctile_count", C.ctile_count_blocks(blocks, filt),
               C.ctile_count_blocks_plain(blocks, filt))
    payload = sum(b.payload.numel() for b in blocks)
    by_bytes = (payload * 4 + filt.numel() * 4
                + sum(b.rows for b in blocks) * 4) / mem_rate * 1e3
    by_ops = payload / popc_rate * 1e3
    kern["ctile_count masked filter"] = {
        "shape": f"{len(blocks)} compressed blocks, {payload} payload "
                 f"words, a mask filter of {filt.numel()} words",
        "ms": _time_ms(lambda: C.ctile_count_blocks(blocks, filt)),
        "kernel_ms": _device_ms(lambda: C.ctile_count_blocks(blocks, filt),
                                "ctile"),
        "kernel_ms_l2_flushed": _device_ms(
            lambda: C.ctile_count_blocks(blocks, filt), "ctile",
            flush=flush),
        "plain_ms": _time_ms(lambda: C.ctile_count_blocks_plain(blocks,
                                                                filt),
                             reps=1, trials=3),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    torch.cuda.synchronize()
    del flush
    out["kernels"] = kern
    out["launches"] = launched
    for name, k in kern.items():
        print(f"serving path: {name} ({k['shape']}): call "
              f"{_fmt_ms(k['ms'])}, kernel {_fmt_ms(k['kernel_ms'])}, "
              f"{_fmt_ms(k['kernel_ms_l2_flushed'])} with L2 flushed, bound "
              f"{_fmt_ms(k['bound_ms'])} ({k['bound_by']}), plain "
              f"{_fmt_ms(k['plain_ms'])}; equal to its plain version {lab}")
    return out


def phase_serving(report: Report, ssb: dict, by_date: dict, c4: dict,
                  rates) -> None:
    """Path 9: the serving layer (scheduler, result cache, fused masked
    dispatches) on bench.py configs 6-8 and on paths 1, 3 and 7's
    indexes."""
    import torch

    from pilosa_tpu_torch.ops import kernel_util as KU

    lab = report.label
    probe = _ServingProbe()
    try:
        KU.reset_launches()
        c6 = _serving_config6(probe, lab)
        c7 = _serving_config7(lab)
        c8 = _serving_config8(probe, report, lab)
        report.launched("serving 9a-9c", c8.pop("launches"),
                        ("tape_count", "scatter_merge", "bsi_compare",
                         "pair_counts"))
        full = _serving_full_width(probe, report, ssb, by_date, c4, rates,
                                   lab)
        report.launched("serving 9d", full["launches"],
                        ("tape_count", "pair_counts", "ctile_count"))
    finally:
        probe.close()
    report.kernel("tape_count", serving=full["kernels"]["tape_count masked"])
    report.kernel("pair_counts",
                  serving=full["kernels"]["pair_counts masked filter"])
    report.kernel("ctile_count",
                  serving=full["kernels"]["ctile_count masked filter"])
    print("serving path: " + json.dumps({
        "config6": c6, "config7": c7, "config8": c8,
        "full_width": {k: v for k, v in full.items() if k != "kernels"}},
        default=str))
    print("serving path: every answer matches numpy")


# ---------------------------------------------------------------------------
# Path 10: the API's read calls (bench.py configs 13 and 12)
# ---------------------------------------------------------------------------

C13_PER_SHARD, C13_VALUES = 120_000, 4_000
C13_QUERIES = [
    "Count(Row(f=3))",
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Count(Union(Row(f=2), Row(g=3), Row(f=5)))",
    "Count(Difference(Row(f=4), Row(g=0)))",
    "Count(Not(Row(f=6)))",
    "Count(Intersect(Row(v > 0), Row(g=2)))",
    "Intersect(Row(f=1), Row(g=1))",
]
C12_PER_SHARD = 40_000
#: bench.py's config 12 reads Row(g=2) of a field g it never creates, which
#: raises KeyError in both packages; its one set field f stands in
C12_QUERIES = ["Count(Row(f=3))", "Intersect(Row(f=1), Row(f=2))",
               "TopN(f, n=4)"]


class _StageClock:
    """Wraps functions by module attribute while open and adds each
    call's own seconds (its wrapped callees' excluded) to its stage: the
    host split of a query without a switch in the package."""

    def __init__(self, stages):
        import collections

        self.own = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._stack = []
        self._undo = []
        for stage, owner, name in stages:
            self._wrap(stage, owner, name)

    def _wrap(self, stage, owner, name):
        fn = getattr(owner, name)
        clock = self

        def wrapped(*a, **k):
            clock._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                child = clock._stack.pop()
                clock.own[stage] += dt - child
                clock.calls[stage] += 1
                if clock._stack:
                    clock._stack[-1] += dt

        setattr(owner, name, wrapped)
        self._undo.append((owner, name, fn))

    def close(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo = []


def _span_names(doc, acc=None):
    acc = [] if acc is None else acc
    acc.append(doc.get("name", ""))
    for c in doc.get("children", ()):
        _span_names(c, acc)
    return acc


def _c13_build():
    """bench.py config 13 as it builds it (seed 13), on the card."""
    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(13)
    api = API()
    api.create_index("c13")
    api.create_field("c13", "f")
    api.create_field("c13", "g")
    api.create_field("c13", "v", {"type": "int"})
    rows = {"f": [], "g": [], "v": []}
    for shard in range(2):
        cols = shard * SHARD_WIDTH + np.arange(C13_PER_SHARD)
        f = rng.integers(0, 64, C13_PER_SHARD)
        api.import_bits("c13", "f", rows=f.tolist(), cols=cols.tolist())
        g = rng.integers(0, 32, C13_PER_SHARD)
        api.import_bits("c13", "g", rows=g.tolist(), cols=cols.tolist())
        v = rng.integers(-50, 50, C13_VALUES)
        api.holder.index("c13").field("v").set_values(
            cols[:C13_VALUES].tolist(), v.tolist())
        rows["f"].append(f)
        rows["g"].append(g)
        rows["v"].append(np.concatenate(
            [v, np.zeros(C13_PER_SHARD - C13_VALUES, np.int64)]))
    return api, {k: np.concatenate(x) for k, x in rows.items()}


def _c13_oracle(r):
    """The seven answers, as query_json gives them, from numpy."""
    import numpy as np

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    f, g, v = r["f"], r["g"], r["v"]
    cols = np.concatenate([s * SHARD_WIDTH + np.arange(C13_PER_SHARD)
                           for s in range(2)])
    both = (f == 1) & (g == 1)
    return [{"results": [x]} for x in (
        int((f == 3).sum()), int(both.sum()),
        int(((f == 2) | (g == 3) | (f == 5)).sum()),
        int(((f == 4) & (g != 0)).sum()), int((f != 6).sum()),
        int(((v > 0) & (g == 2)).sum()),
        {"columns": cols[both].tolist()})]


def _release(api, index):
    from pilosa_tpu_torch.core.stacked import release_field_cache

    for fld in api.holder.index(index).fields.values():
        release_field_cache(fld)


def _traced_json(api, index, q):
    """query_json's answer and the span names of its trace, under an
    always-on tracer."""
    from pilosa_tpu_torch.obs import tracing as T

    prev = T.set_tracer(T.Tracer(enabled=True, sample_rate=1.0,
                                 store=T.TraceStore(8)))
    try:
        with T.get_tracer().start_trace("q13") as root:
            out = api.query_json(index, q)
        return out, _span_names(root.to_json())
    finally:
        T.set_tracer(prev)


def _config13(lab) -> dict:
    import numpy as np
    import torch

    from pilosa_tpu_torch import api as A
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.pql import executor as E
    from pilosa_tpu_torch.pql import programs

    t0 = time.perf_counter()
    api, rows = _c13_build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    want = _c13_oracle(rows)

    # cold: every stack released before every query, so each query stages
    # (stack.build + device.h2d_copy) as a non-resident engine would
    cold_ms = {q: [] for q in C13_QUERIES}
    for _ in range(5):
        for q, w in zip(C13_QUERIES, want):
            _release(api, "c13")
            ms = _wall_ms(lambda q=q: api.query_json("c13", q))
            cold_ms[q].append(ms)
    for q, w in zip(C13_QUERIES, want):
        _release(api, "c13")
        got, names = _traced_json(api, "c13", q)
        assert got == w, f"config 13 cold {q}: {got} != {w}"
        assert "stack.build" in names and "device.h2d_copy" in names, \
            f"a cold trace of {q} staged nothing: {names}"

    _release(api, "c13")
    stats0 = dict(api.holder.residency_stats())
    built = api.holder.prewarm("c13")
    assert built == {"set_stacks": 3, "bsi_stacks": 1}, built
    warm = {}
    for q, w in zip(C13_QUERIES, want):
        got, names = _traced_json(api, "c13", q)
        assert got == w, f"config 13 warm {q}: {got} != {w}"
        assert "stack.build" not in names, f"warm query rebuilt: {q}"
        assert "device.h2d_copy" not in names, f"warm query staged: {q}"
    for q in C13_QUERIES:
        warm[q] = {
            "p50_ms": statistics.median(
                _wall_ms(lambda q=q: api.query_json("c13", q))
                for _ in range(21)),
            "cold_p50_ms": statistics.median(cold_ms[q]),
            "device_ms": _device_ms(lambda q=q: api.query_json("c13", q),
                                    calls=21)}
    stats = api.holder.residency_stats()
    assert stats["block_builds"] == stats0["block_builds"] + 3, \
        (stats0, stats)
    idx = api.holder.index("c13")
    kinds = {f: "compressed" if isinstance(
        STK.stacked_set(idx.field(f), [0, 1], "standard")._blocks[0],
        C.CompressedBlock) else "dense" for f in ("f", "g", "_exists")}

    def cold_pass():
        for q in C13_QUERIES:
            _release(api, "c13")
            api.query_json("c13", q)

    def warm_pass():
        for q in C13_QUERIES:
            api.query_json("c13", q)

    api.holder.prewarm("c13")
    warm_pass_ms = statistics.median(_wall_ms(warm_pass) for _ in range(11))
    cold_pass_ms = statistics.median(_wall_ms(cold_pass) for _ in range(5))
    api.holder.prewarm("c13")

    # the host split of each warm query by stage (each call's own time)
    stages = [("parse", A, "parse"), ("lower", programs, "_lower_root"),
              ("stack lookup", programs, "stacked_set"),
              ("stack lookup", E, "stacked_set"),
              ("stack lookup", E, "stacked_bsi"),
              ("compressed row decode", C.CompressedBlock, "decode"),
              ("tape_count wrapper", B, "tape_count"),
              ("bsi_compare wrapper", S, "bsi_compare"),
              ("copies back", E, "_start_copies"),
              ("copies back (the wait)", E, "_wait_copies")]
    reps = 21
    for q in C13_QUERIES:
        clock = _StageClock(stages)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                api.query_json("c13", q)
            torch.cuda.synchronize()
            total_ms = (time.perf_counter() - t0) * 1e3 / reps
        finally:
            clock.close()
        split = {k: v * 1e3 / reps for k, v in clock.own.items()}
        split["other"] = total_ms - sum(split.values())
        warm[q]["split_ms"] = split
        warm[q]["wrapped_ms"] = total_ms
    _release(api, "c13")
    out = {"build_s": build_s, "cold_pass_ms": cold_pass_ms,
           "warm_pass_ms": warm_pass_ms, "per_query": warm,
           "residency": stats, "stack_kinds": kinds, "program_cache_len":
               programs.program_cache_len(),
           "resident_bytes_warm": stats["resident_bytes"]}
    print(f"api reads 10 config 13: 2 x {C13_PER_SHARD} records, f 64 rows, "
          f"g 32, v {C13_VALUES} values a shard; built in {build_s:.3f} s; "
          f"a pass of 7 queries cold {cold_pass_ms:.3f} ms, warm "
          f"{warm_pass_ms:.3f} ms ({cold_pass_ms / warm_pass_ms:.1f}x); "
          f"residency {stats}; stacks {kinds}; programs cached "
          f"{out['program_cache_len']} {lab}")
    for q in C13_QUERIES:
        w = warm[q]
        dev = w["device_ms"]
        print(f"api reads 10 config 13: {q}: warm p50 {w['p50_ms']:.3f} ms "
              f"(cold {w['cold_p50_ms']:.3f}), device {_fmt_ms(dev)}"
              + (f" ({100 * dev / w['p50_ms']:.1f}%)" if dev else "")
              + "; host split " + ", ".join(
                  f"{k} {v:.4f}" for k, v in sorted(w["split_ms"].items()))
              + f" ms (wrapped {w['wrapped_ms']:.3f} ms) {lab}")
    print("api reads 10 config 13: every cold trace holds stack.build and "
          "device.h2d_copy, no warm trace holds either; every answer "
          "matches numpy")
    return out


def _config12(lab) -> dict:
    import random

    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.obs import tracing as T
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(12)
    api = API()
    api.create_index("c12")
    api.create_field("c12", "f")
    f = []
    for shard in range(2):
        rows = rng.integers(0, 8, C12_PER_SHARD)
        cols = shard * SHARD_WIDTH + np.arange(C12_PER_SHARD)
        api.import_bits("c12", "f", rows=rows.tolist(), cols=cols.tolist())
        f.append(rows)
    f = np.concatenate(f)
    cols = np.concatenate([s * SHARD_WIDTH + np.arange(C12_PER_SHARD)
                           for s in range(2)])
    counts = np.bincount(f, minlength=8)
    top = _want_top({i: int(c) for i, c in enumerate(counts)}, 4)
    want = [{"results": [int(counts[3])]},
            {"results": [{"columns": cols[(f == 1) & (f == 2)].tolist()}]},
            {"results": [{"rows": [{"id": i, "count": c} for i, c in top],
                          "field": "f"}]}]

    def workload():
        return [api.query_json("c12", q) for q in C12_QUERIES]

    def p50():
        return statistics.median(_wall_ms(workload) for _ in range(21))

    prev = T.get_tracer()
    phases, results = {}, {}
    try:
        T.set_tracer(T.NopTracer())
        results["untraced"] = workload()
        phases["untraced"] = p50()
        T.set_tracer(T.Tracer(enabled=False))
        assert T.get_tracer().start_span("probe") is T.NOP_SPAN
        orig_init, allocs = T.Span.__init__, [0]

        def counting_init(self, *a, **k):
            allocs[0] += 1
            orig_init(self, *a, **k)

        T.Span.__init__ = counting_init
        try:
            results["off"] = workload()
            phases["off"] = p50()
        finally:
            T.Span.__init__ = orig_init
        assert allocs[0] == 0, f"tracing off allocated {allocs[0]} spans"
        T.set_tracer(T.Tracer(enabled=True, sample_rate=0.1,
                              store=T.TraceStore(64),
                              rng=random.Random(12)))
        results["sampled"] = workload()
        phases["sampled"] = p50()
        T.set_tracer(T.Tracer(enabled=True, sample_rate=1.0,
                              store=T.TraceStore(64)))
        results["always"] = workload()
        phases["always"] = p50()
        stored = len(T.get_tracer().store)
        assert stored > 0, "always-on tracing stored no traces"
    finally:
        T.set_tracer(prev)
    assert results["untraced"] == want, "config 12 disagrees with numpy"
    for name in ("off", "sampled", "always"):
        assert results[name] == results["untraced"], name
    _release(api, "c12")
    base = phases["untraced"]
    print(f"api reads 10 config 12: p50 of the 3-query workload untraced "
          f"{base:.3f} ms, off {phases['off']:.3f}, 10% sampled "
          f"{phases['sampled']:.3f}, always on {phases['always']:.3f} ("
          + ", ".join(f"{k} {100 * (v / base - 1):+.1f}%"
                      for k, v in phases.items() if k != "untraced")
          + f"); spans allocated off 0; traces stored {stored} {lab}")
    return {"p50_ms": phases, "traces_stored": stored}


def phase_api_reads(report: Report) -> dict:
    """Path 10: bench.py configs 13 (cold vs warm residency, the host
    split of a warm read) and 12 (tracing overhead) through the API's
    read calls."""
    import torch

    from pilosa_tpu_torch.ops import kernel_util as KU

    t0 = time.perf_counter()
    KU.reset_launches()
    c13 = _config13(report.label)
    c12 = _config12(report.label)
    torch.cuda.synchronize()
    report.launched("api reads 10", KU.launches(),
                    ("tape_count", "bsi_compare"))
    out = {"config13": c13, "config12": c12,
           "seconds": time.perf_counter() - t0}
    print("api reads 10: " + json.dumps(
        {"config13": {k: v for k, v in c13.items() if k != "per_query"},
         "config12": c12, "seconds": out["seconds"]}, default=str))
    return out


# ---------------------------------------------------------------------------
# Path 11: durability (WAL, checkpoints, crash recovery, backup/restore)
# ---------------------------------------------------------------------------

C11_COMMITS = (64, 256, 1024)
C2_SHARDS = 10


def _dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total


class _CheckpointLog:
    """Counts and times ``Holder.checkpoint`` calls while open."""

    def __init__(self):
        from pilosa_tpu_torch.core.holder import Holder

        self.seconds = []
        self._orig = Holder.checkpoint
        log = self

        def checkpoint(holder):
            t0 = time.perf_counter()
            try:
                return log._orig(holder)
            finally:
                log.seconds.append(time.perf_counter() - t0)

        Holder.checkpoint = checkpoint

    def close(self):
        from pilosa_tpu_torch.core.holder import Holder

        Holder.checkpoint = self._orig


def _recover(path: str):
    """Reopen ``path`` (crash recovery), split into the schema load, the
    npz load, the WAL replay and the repair; returns (api, seconds,
    split)."""
    import torch

    from pilosa_tpu_torch import api as A
    from pilosa_tpu_torch.core import holder as H
    from pilosa_tpu_torch.storage import store, wal

    clock = _StageClock([("schema", H.Holder, "_load_schema"),
                         ("npz load", store, "load_holder_data"),
                         ("replay", H.Holder, "replay_records"),
                         ("repair", wal.WAL, "repair")])
    try:
        t0 = time.perf_counter()
        api = A.API(path)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        clock.close()
    return api, secs, dict(clock.own)


def _config11(base: str, lab) -> dict:
    """11a: bench.py config 11 as it builds it, on the card."""
    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.storage.recovery import (
        CrashPlan, abandon_holder, crash_workload, oracle_checksums,
        run_crash_point)

    rng = np.random.default_rng(11)
    sizes = []
    for n_commits in C11_COMMITS:
        path = os.path.join(base, f"wal{n_commits}")
        api = API(path)
        api.create_index("r", {"trackExistence": False})
        api.create_field("r", "f")
        api.save()  # the schema checkpoint: the WAL tail is all data
        rows = rng.integers(0, 8, size=(n_commits, 32))
        cols = rng.integers(0, 1 << 20, size=(n_commits, 32))
        t0 = time.perf_counter()
        for i in range(n_commits):
            api.import_bits("r", "f", rows=rows[i].tolist(),
                            cols=cols[i].tolist())
        ingest_s = time.perf_counter() - t0
        want = api.checksum()
        wal_bytes = api.holder.wal_bytes()
        api.holder.flush_wals()
        abandon_holder(api.holder)
        recovered, recover_s, split = _recover(path)
        assert recovered.checksum() == want, \
            f"recovery lost data at {n_commits} commits"
        abandon_holder(recovered.holder)
        sizes.append({"commits": n_commits, "recover_ms": recover_s * 1e3,
                      "wal_kb": wal_bytes / 1024,
                      "replay_mbps": wal_bytes / recover_s / 1e6,
                      "reingest_ms": ingest_s * 1e3,
                      "split_ms": {k: v * 1e3 for k, v in split.items()}})
        print(f"durability 11a: {n_commits} commits of 32 bits: recovery "
              f"{recover_s * 1e3:.3f} ms ("
              + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in split.items())
              + f" ms) for {wal_bytes / 1024:.1f} KB of WAL, replay "
              f"{wal_bytes / recover_s / 1e6:.3f} MB/s; re-ingest "
              f"{ingest_s * 1e3:.3f} ms; checksum equal {lab}")
    kp = os.path.join(base, "killpoint")
    batches = crash_workload(n_batches=8, seed=11)
    oracle = oracle_checksums(kp, batches)
    plan = CrashPlan.seeded(11)
    res = run_crash_point(kp, plan, batches, checkpoint_bytes=1)
    k = oracle.index(res["checksum"]) if res["checksum"] in oracle else -1
    assert k >= 0, "the seeded kill point recovered a non-prefix state"
    assert k >= res["acked"], f"acked batch lost: prefix {k} < {res['acked']}"
    abandon_holder(res["api"].holder)
    print(f"durability 11a: CrashPlan.seeded(11) fired at {res['fired']}; "
          f"{res['acked']} of 8 batches acknowledged, recovered the prefix "
          f"of {k} batches (crashed {res['crashed']})")
    return {"sizes": sizes, "kill_point": {"fired": res["fired"],
                                           "acked": res["acked"],
                                           "prefix": k}}


def _c1_answers(api, pairs):
    out = {}
    for c, d in pairs:
        q = f"Count(Intersect(Row(city={c}), Row(device={d})))"
        out[q] = api.query("taxi", q)[0]
    top = api.query("taxi", "TopN(city, n=10)")[0]
    out["TopN(city, n=10)"] = [(p.id, p.count) for p in top.pairs]
    return out


def _c1_oracle(city, dev, pairs):
    import numpy as np

    out = {}
    for c, d in pairs:
        q = f"Count(Intersect(Row(city={c}), Row(device={d})))"
        out[q] = int(((city == c) & (dev == d)).sum())
    counts = np.bincount(city)
    out["TopN(city, n=10)"] = _want_top(
        {i: int(x) for i, x in enumerate(counts)}, 10)
    return out


def _c2_answers(api):
    half = 524288
    s = api.query("b", f"Sum(Row(amount > {half}), field=amount)")[0]
    mn = api.query("b", "Min(field=amount)")[0]
    mx = api.query("b", "Max(field=amount)")[0]
    return {"sum": (s.val, s.count),
            "range": api.query("b", "Count(Row(1000 <= amount <= 2000))")[0],
            "min": (mn.val, mn.count), "max": (mx.val, mx.count)}


def _c2_oracle(amount):
    half = 524288
    big = amount[amount > half]
    lo, hi = int(amount.min()), int(amount.max())
    return {"sum": (int(big.sum()), int(big.size)),
            "range": int(((amount >= 1000) & (amount <= 2000)).sum()),
            "min": (lo, int((amount == lo).sum())),
            "max": (hi, int((amount == hi).sum()))}


def phase_durability(report: Report, args, write_visible_ms) -> dict:
    """Path 11: durability at full size in one data directory on local
    disk (the checkout's build/), wal_sync="batch": 11a bench.py config
    11, 11b BASELINE config 1 into API(path) with two crashes, 11c
    config 2's amount field beside it, 11d backup and restore, 11e a
    roaring import."""
    import io
    import shutil

    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.probes import import_probe as IP
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.storage import roaring
    from pilosa_tpu_torch.storage.recovery import abandon_holder

    lab = report.label
    base = os.path.abspath(os.path.join("build", "chip_smoke_data"))
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    t_phase = time.perf_counter()
    out = {}
    ckpts = _CheckpointLog()
    try:
        KU.reset_launches()
        # -- 11a ---------------------------------------------------------------
        t0 = time.perf_counter()
        out["11a"] = _config11(os.path.join(base, "c11"), lab)
        out["11a"]["seconds"] = time.perf_counter() - t0
        ckpts.seconds.clear()

        # -- 11b: config 1 into API(path) ------------------------------------
        t0 = time.perf_counter()
        path = os.path.join(base, "holder")
        city, dev = IP.config1_data()
        n = city.size
        pairs = [(7, 3), (0, 0), (999, 9), (500, 5), (123, 1), (42, 8)]
        api = API(path)
        t1 = time.perf_counter()
        changed = IP.import_config1(api, city, dev)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t1
        IP.check_config1(api, city, dev, changed)
        import_ckpts = list(ckpts.seconds)
        ckpts.seconds.clear()
        want = _c1_oracle(city, dev, pairs)
        assert _c1_answers(api, pairs) == want, "config 1 disagrees"
        digest = api.checksum()
        wal_bytes = api.holder.wal_bytes()
        abandon_holder(api.holder)
        t1 = time.perf_counter()
        api, rec_s, split = _recover(path)
        first = api.query(
            "taxi", "Count(Intersect(Row(city=7), Row(device=3)))")[0]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        assert first == want["Count(Intersect(Row(city=7), Row(device=3)))"]
        assert api.checksum() == digest, "crash 1 changed the checksum"
        assert _c1_answers(api, pairs) == want, "crash 1 changed an answer"
        t1 = time.perf_counter()
        api.save()
        save_s = time.perf_counter() - t1
        ckpts.seconds.clear()
        disk = _dir_bytes(path)
        assert api.holder.wal_bytes() == 0
        # 64 rounds of writes with the WAL, each read back
        q = "Count(Intersect(Row(city=3), Row(device=7)))"
        c3d7 = int(((city == 3) & (dev == 7)).sum())
        rounds_ms = []
        for i in range(64):
            c = n + i
            t1 = time.perf_counter()
            api.query("taxi", f"Set({c}, city=3)Set({c}, device=7)")
            got = api.query("taxi", q)[0]
            rounds_ms.append((time.perf_counter() - t1) * 1e3)
            assert got == c3d7 + i + 1, f"round {i}: {got}"
        city = np.concatenate([city, np.full(64, 3)])
        dev = np.concatenate([dev, np.full(64, 7)])
        cols_all = np.arange(city.size)
        # one import_bits of 131,072 new records; shard 0 has 48,512 free
        # columns left, so they go to the start of shard 1
        rng = np.random.default_rng(111)
        new = rng.integers(0, 1000, IP.C1_BATCH)
        ids = SHARD_WIDTH + np.arange(IP.C1_BATCH)
        before = KU.launches()["scatter_merge"]
        api.import_bits("taxi", "city", rows=new, cols=ids)
        torch.cuda.synchronize()
        import_launches = KU.launches()["scatter_merge"] - before
        # the city field and the _exists mark: one launch each
        assert import_launches == 2, import_launches
        city = np.concatenate([city, new])
        dev = np.concatenate([dev, np.full(new.size, -1)])
        cols_all = np.concatenate([cols_all, ids])
        want = _c1_oracle(city, dev, pairs)
        assert _c1_answers(api, pairs) == want, "after the writes"
        writes_ckpts = list(ckpts.seconds)
        digest = api.checksum()
        tail_bytes = api.holder.wal_bytes()
        abandon_holder(api.holder)
        api, rec2_s, split2 = _recover(path)
        assert api.checksum() == digest, "crash 2 changed the checksum"
        assert _c1_answers(api, pairs) == want, "crash 2 changed an answer"
        out["11b"] = {
            "import_s": import_s, "import_checkpoints_s": import_ckpts,
            "wal_bytes_at_crash1": wal_bytes, "recovery1_s": rec_s,
            "recovery1_split_s": split, "first_answer_s": first_s,
            "checkpoint_s": save_s, "bytes_on_disk": disk,
            "write_visible_median_ms": statistics.median(rounds_ms),
            "write_visible_in_memory_ms": write_visible_ms,
            "import_launches": import_launches,
            "writes_checkpoints_s": writes_ckpts,
            "wal_bytes_at_crash2": tail_bytes, "recovery2_s": rec2_s,
            "recovery2_split_s": split2,
            "seconds": time.perf_counter() - t0}
        b = out["11b"]
        print(f"durability 11b: config 1 into API(path): import "
              f"{import_s:.3f} s with {len(import_ckpts)} checkpoints ("
              + ", ".join(f"{s:.3f}" for s in import_ckpts)
              + f" s); crash 1 with {wal_bytes} B of WAL: recovery "
              f"{rec_s:.3f} s (" + ", ".join(
                  f"{k} {v:.3f}" for k, v in split.items())
              + f" s); first answer after the restart {first_s:.3f} s "
              f"{lab}")
        print(f"durability 11b: checkpoint {save_s:.3f} s, {disk} B on "
              f"disk; write->visible with the WAL median "
              f"{b['write_visible_median_ms']:.3f} ms (64 rounds; path 6a "
              f"in memory {_fmt_ms(write_visible_ms)}); an import of "
              f"{IP.C1_BATCH} new records: {import_launches} scatter_merge "
              f"launches; {len(writes_ckpts)} checkpoints since the save; "
              f"crash 2 (checkpoint + {tail_bytes} B of tail): "
              f"recovery {rec2_s:.3f} s (" + ", ".join(
                  f"{k} {v:.3f}" for k, v in split2.items())
              + f" s); checksum and answers equal {lab}")

        # -- 11c: config 2's amount field in a second index -------------------
        t0 = time.perf_counter()
        ckpts.seconds.clear()
        amount = np.random.default_rng(args.seed).integers(
            0, 1 << 20, C2_SHARDS * SHARD_WIDTH)
        api.create_index("b")
        api.create_field("b", "amount", {"type": "int"})
        t1 = time.perf_counter()
        for s in range(C2_SHARDS):
            lo = s * SHARD_WIDTH
            api.import_values("b", "amount",
                              cols=np.arange(lo, lo + SHARD_WIDTH),
                              values=amount[lo:lo + SHARD_WIDTH])
        torch.cuda.synchronize()
        c2_import_s = time.perf_counter() - t1
        c2_ckpts = list(ckpts.seconds)
        want2 = _c2_oracle(amount)
        digest = api.checksum()
        tail = api.holder.wal_bytes()
        abandon_holder(api.holder)
        api, rec3_s, split3 = _recover(path)
        assert api.checksum() == digest, "11c: the checksum changed"
        assert _c2_answers(api) == want2, "11c disagrees with numpy"
        assert _c1_answers(api, pairs) == want
        bsi_bytes = sum(f.planes.nbytes for f in
                        api.holder.index("b").field("amount").bsi.values())
        out["11c"] = {"import_s": c2_import_s, "checkpoints_s": c2_ckpts,
                      "wal_tail_bytes": tail, "recovery_s": rec3_s,
                      "recovery_split_s": split3, "bsi_bytes": bsi_bytes,
                      "seconds": time.perf_counter() - t0}
        print(f"durability 11c: config 2's amount ({C2_SHARDS} shards, "
              f"{bsi_bytes} B of BSI planes) imported a shard a request in "
              f"{c2_import_s:.3f} s with {len(c2_ckpts)} checkpoints ("
              + ", ".join(f"{s:.3f}" for s in c2_ckpts)
              + f" s); crash with {tail} B of tail: recovery {rec3_s:.3f} "
              f"s (" + ", ".join(f"{k} {v:.3f}" for k, v in split3.items())
              + f" s); Sum, Range Count, Min, Max match numpy {lab}")

        # -- 11d: backup and restore -------------------------------------------
        t0 = time.perf_counter()
        buf = io.BytesIO()
        api.backup_tar(buf)
        backup_s = time.perf_counter() - t0
        tar = buf.getvalue()
        del buf
        t1 = time.perf_counter()
        dst = API(os.path.join(base, "restored"))
        dst.restore_tar(io.BytesIO(tar))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        assert dst.checksum() == api.checksum(), "restore changed the data"
        assert _c1_answers(dst, pairs) == want
        assert _c2_answers(dst) == want2
        abandon_holder(dst.holder)
        del dst
        out["11d"] = {"tar_bytes": len(tar), "backup_s": backup_s,
                      "restore_s": restore_s}
        print(f"durability 11d: backup_tar {len(tar)} B in {backup_s:.3f} "
              f"s; restore_tar into a fresh API(path) {restore_s:.3f} s; "
              f"checksum and every answer of 11b and 11c equal {lab}")
        del tar

        # -- 11e: import_roaring -----------------------------------------------
        t0 = time.perf_counter()
        in0 = cols_all < SHARD_WIDTH
        blob = roaring.encode_positions(
            city[in0].astype(np.uint64) * np.uint64(SHARD_WIDTH)
            + cols_all[in0].astype(np.uint64))
        api.create_field("taxi", "city2")
        t1 = time.perf_counter()
        api.import_roaring("taxi", "city2", 0, {"": blob})
        roaring_s = time.perf_counter() - t1
        for c in (0, 3, 7, 500, 999):
            assert api.query("taxi", f"Count(Row(city2={c}))")[0] == \
                int((city[in0] == c).sum())
        q2 = "Count(Intersect(Row(city2=7), Row(device=3)))"
        assert api.query("taxi", q2)[0] == want[
            "Count(Intersect(Row(city=7), Row(device=3)))"]
        out["11e"] = {"roaring_bytes": len(blob), "import_s": roaring_s,
                      "seconds": time.perf_counter() - t0}
        print(f"durability 11e: one shard of city as a {len(blob)} B "
              f"roaring blob, imported into a fresh field in "
              f"{roaring_s:.3f} s; Counts equal {lab}")

        torch.cuda.synchronize()
        launched = KU.launches()
        report.launched("durability 11", launched,
                        ("tape_count", "pair_counts", "bsi_compare",
                         "scatter_merge"))
        # tape_count and pair_counts against their plain versions on the
        # recovered stacks (these launches are not counted)
        idx = api.holder.index("taxi")
        cs = STK.stacked_set(idx.field("city"), [0], "standard")
        ds = STK.stacked_set(idx.field("device"), [0], "standard")
        leaves = [cs.row_plane(3), ds.row_plane(7)]
        tape = (("and", 0, 1),)
        report.err("tape_count", B.tape_count(tape, leaves),
                   B.tape_count_plain(tape, leaves))
        for _, blk in cs.iter_blocks():
            report.err("pair_counts", G.pair_counts(ds.planes, blk),
                       G.pair_counts_plain(ds.planes, blk))
        abandon_holder(api.holder)
        del api
    finally:
        ckpts.close()
        shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"durability 11: launches {launched} {lab}")
    print("durability 11: " + json.dumps(out, default=str))
    print("durability 11: every recovered checksum equals the one before "
          "its crash; every answer matches numpy")
    return out


# ---------------------------------------------------------------------------
# Path 12: ingest and streams (sources, Batch, Ingester, datagen, the
# broker, the pipelined ingester, API.enable_stream)
# ---------------------------------------------------------------------------

#: bench.py's sizes (configs 1 and 17, kitchen-sink and the service run)
C1_ROWS = 1_000_000
C17_ROWS = 2_000_000
C17_CHUNK = 8192
C17_ITERS = 100  # bench.py: max(25, QUERY_ITERS * 5)
C17_GROUPBY = "GroupBy(Rows(city), Rows(device), limit=100)"
KS_ROWS = 200_000
SVC_PUSHES, SVC_PER_PUSH, SVC_BATCH_ROWS = 64, 1024, 64


def _csv_lines(ids, city, dev) -> str:
    lines = ["id,city__IS,device__IS"]
    lines.extend(f"{i},{c},{d}" for i, c, d in zip(ids, city, dev))
    return "\n".join(lines)


def _synced_s(fn):
    """(fn's result, its seconds to a device sync)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _bar(ok: bool) -> str:
    return "met" if ok else "missed"


_UNCOUNTED: dict = {}


@contextlib.contextmanager
def _uncounted():
    """Set aside the launches of a reference load or a timed re-run:
    ``phase_ingest`` and ``phase_observability`` take them out of paths
    12 and 14's counts."""
    from pilosa_tpu_torch.ops import kernel_util as KU

    before = KU.launches()
    try:
        yield
    finally:
        for k, v in KU.launches().items():
            _UNCOUNTED[k] = _UNCOUNTED.get(k, 0) + v - before.get(k, 0)


def _ingest_config1(lab) -> dict:
    """12a: bench.py config 1 through the Ingester."""
    import csv
    import io

    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core import field as F
    from pilosa_tpu_torch.ingest import ingest as IG
    from pilosa_tpu_torch.ingest import source as SRC
    from pilosa_tpu_torch.ingest.ingest import Ingester
    from pilosa_tpu_torch.ingest.source import CSVSource
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.ops import scatter as SC
    from pilosa_tpu_torch.probes import import_probe as IP

    city, dev = IP.config1_data(C1_ROWS)
    n = city.size
    text = _csv_lines(range(n), city, dev)
    t0 = time.perf_counter()
    for _ in csv.reader(io.StringIO(text)):
        pass
    parse_s = time.perf_counter() - t0
    api = API()
    before = KU.launches()["scatter_merge"]
    got, ingest_s = _synced_s(lambda: Ingester(
        api, "taxi", CSVSource(text, inline=True), batch_size=131072).run())
    launches = KU.launches()["scatter_merge"] - before
    # the same load again with its host stages timed: the whole-column
    # parse, the cell coercion, the field writes and, inside them, the
    # bulk scatter (sort, pack, one scatter_merge round trip)
    clock = _StageClock([("parse", SRC.CSVSource, "columns"),
                         ("coerce", IG, "coerce_column"),
                         ("import_bits", F.Field, "import_bits"),
                         ("scatter", SC, "scatter_new_bits_bulk")])
    try:
        with _uncounted():
            _, split_s = _synced_s(lambda: Ingester(
                API(), "taxi", CSVSource(text, inline=True),
                batch_size=131072).run())
    finally:
        clock.close()
    split = dict(clock.own)
    split["rest"] = split_s - sum(split.values())
    del text
    assert got == n, got
    assert launches > 0, "the ingest launched no scatter_merge"
    ref = API()
    with _uncounted():
        IP.import_config1(ref, city, dev)
    digest = api.checksum()
    assert digest == ref.checksum(), \
        "the Ingester's load differs from API.import_bits'"
    del ref
    pairs = [(7, 3), (0, 0), (999, 9), (500, 5), (123, 1), (42, 8)]
    for c, d in pairs:
        q = f"Count(Intersect(Row(city={c}), Row(device={d})))"
        assert api.query("taxi", q)[0] == int(((city == c) & (dev == d))
                                               .sum()), q
    rows_s = n / ingest_s
    out = {"rows": n, "ingest_s": ingest_s, "rows_s": rows_s,
           "parse_s": parse_s, "parse_rows_s": n / parse_s,
           "vs_parse": rows_s / (n / parse_s),
           "scatter_merge_launches": launches, "split_s": split,
           "split_total_s": split_s}
    print(f"ingest 12a: config 1, {n} CSV rows through the Ingester in "
          f"{ingest_s:.3f} s, {rows_s:,.0f} rows/s ({out['vs_parse']:.3f}x "
          f"the raw csv.reader parse, {n / parse_s:,.0f} rows/s); "
          f"{launches} scatter_merge launches; checksum equal to "
          f"API.import_bits' load; 6 Counts equal numpy {lab}")
    print(f"ingest 12a: the load again, {split_s:.3f} s split by host "
          f"stage (each its own time): " + ", ".join(
              f"{k} {v:.3f} s" for k, v in split.items()) + f" {lab}")
    return out


def _ingest_config17(lab) -> dict:
    """12b: bench.py config 17's three phases."""
    import threading

    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.ingest.ingest import Ingester
    from pilosa_tpu_torch.ingest.source import CSVSource, _parse_header
    from pilosa_tpu_torch.pql.result import result_to_json
    from pilosa_tpu_torch.stream.broker import (BrokerSource, StreamBroker,
                                                make_chunk)
    from pilosa_tpu_torch.stream.pipeline import PipelinedIngester

    rng = np.random.default_rng(17)
    n = C17_ROWS
    city = rng.integers(0, 100, n)
    dev = rng.integers(0, 10, n)

    # phase 1: the control, the classic columnar CSV ingest, best of 2
    text = _csv_lines(range(n), city, dev)
    classic_s = []
    for _ in range(2):
        api = API()
        got, s = _synced_s(lambda: Ingester(
            api, "s17", CSVSource(text, inline=True),
            batch_size=131072).run())
        assert got == n, got
        classic_s.append(s)
    csv_digest = api.checksum()
    del text, api
    c1_rows_s = n / min(classic_s)

    # the stream: chunked messages, drained by the classic oracle and the
    # timed pipelined runs as separate groups
    broker = StreamBroker(partitions=1, seed=17)
    ids = np.arange(n)
    for lo in range(0, n, C17_CHUNK):
        hi = min(lo + C17_CHUNK, n)
        broker.produce("s17", make_chunk({
            "id": ids[lo:hi], "city": city[lo:hi], "device": dev[lo:hi]}))
    schema = _parse_header(["city__IS", "device__IS"])
    api_cl = API()
    got, oracle_s = _synced_s(lambda: Ingester(
        api_cl, "s17", BrokerSource(broker.consumer("classic", ["s17"]),
                                    schema), batch_size=131072).run())
    assert got == n, got
    oracle = api_cl.checksum()
    assert oracle == csv_digest, "the broker's stream differs from the CSV"
    del api_cl

    # phase 2: pipelined over the same stream, best of 3
    piped_s, api_rd, batches = [], None, 0
    for t in range(3):
        api_pp = API()
        p = PipelinedIngester(api_pp, "s17",
                              broker.consumer(f"piped{t}", ["s17"]),
                              schema=schema, batch_rows=32)
        got, s = _synced_s(p.run)
        assert got == n, got
        assert api_pp.checksum() == oracle, \
            "pipelined ingest diverged from the classic Ingester oracle"
        piped_s.append(s)
        batches = p.batches
        api_rd = api_pp
    piped_rows_s = n / min(piped_s)

    # one more pipelined run with each thread's busy seconds summed: the
    # host side's _prepare, the device side's _apply (imports, WAL)
    busy = {"prepare": 0.0, "apply": 0.0}
    lock = threading.Lock()
    p = PipelinedIngester(API(), "s17", broker.consumer("split", ["s17"]),
                          schema=schema, batch_rows=32)
    for name in busy:
        def timed(*a, _fn=getattr(p, f"_{name}"), _name=name):
            t0 = time.perf_counter()
            try:
                return _fn(*a)
            finally:
                with lock:
                    busy[_name] += time.perf_counter() - t0
        setattr(p, f"_{name}", timed)
    with _uncounted():
        _, split_wall = _synced_s(p.run)
    del p

    # phase 3: read p50/p99 alone vs under full-rate ingest churn. The
    # reads are paced, in both runs: each starts twice the scheduler's
    # batch holdoff after the last one ended. bench.py's back-to-back
    # reads keep every batch admit inside the holdoff, so no churn batch
    # could start while they run
    gap_s = 2 * api_rd.enable_scheduler().batch_holdoff_s
    q = C17_GROUPBY
    want_count = int(np.sum((city == 7) & (dev == 3)))
    assert api_rd.query(
        "s17", "Count(Intersect(Row(city=7), Row(device=3)))")[0] \
        == want_count
    pairs, counts = np.unique(np.stack([city, dev]), axis=1,
                              return_counts=True)
    want = [{"group": [{"field": "city", "rowID": int(c)},
                       {"field": "device", "rowID": int(d)}],
             "count": int(k)}
            for (c, d), k in zip(pairs.T[:100], counts[:100])]

    def percentiles(iters):
        """(p50 ms, p99 ms, each read's (start, end))."""
        api_rd.query("s17", q)  # warm
        spans, answers = [], []
        for _ in range(iters):
            time.sleep(gap_s)
            t0 = time.perf_counter()
            answers.append(api_rd.query("s17", q)[0])
            spans.append((t0, time.perf_counter()))
        for a in answers:
            assert result_to_json(a) == want, "GroupBy disagrees with numpy"
        times = [b - a for a, b in spans]
        return (float(np.percentile(times, 50)) * 1e3,
                float(np.percentile(times, 99)) * 1e3, spans)

    p50_alone, p99_alone, _ = percentiles(C17_ITERS)
    stop = threading.Event()
    churned = [0]
    applied = []  # (start, end, rows) of each churn batch's apply
    sheds = {"done": 0, "cur": None}
    shed_lock = threading.Lock()
    errors = []

    def shed_total():
        with shed_lock:
            cur = sheds["cur"]
            return sheds["done"] + (cur.shed if cur is not None else 0)

    def churn():
        w = 0
        try:
            while not stop.is_set():
                w += 1
                c = PipelinedIngester(
                    api_rd, "s17", broker.consumer(f"churn{w}", ["s17"]),
                    schema=schema, batch_rows=8, group=f"churn{w}")

                def timed(batch, _fn=c._apply):
                    t0 = time.perf_counter()
                    _fn(batch)
                    applied.append((t0, time.perf_counter(), batch.n))
                c._apply = timed
                with shed_lock:
                    sheds["cur"] = c
                got = c.run()
                with shed_lock:
                    sheds["done"] += c.shed
                    sheds["cur"] = None
                churned[0] += got
        except BaseException as e:  # noqa: BLE001 - fails the phase below
            errors.append(e)

    th = threading.Thread(target=churn, daemon=True)
    t_churn = time.perf_counter()
    th.start()
    while not applied and th.is_alive():  # the churn is live
        time.sleep(0.005)
    live_s = time.perf_counter() - t_churn
    shed0 = shed_total()
    p50_busy, p99_busy, spans = percentiles(C17_ITERS)
    shed_window = shed_total() - shed0
    still_churning = th.is_alive()
    stop.set()
    th.join(timeout=120)
    assert not th.is_alive(), "the churn did not stop"
    assert not errors, f"the churn failed: {errors}"
    # the churn batches that started and landed between the first read's
    # start and the last read's end, and the reads an apply overlapped
    w0, w1 = spans[0][0], spans[-1][1]
    inside = [a for a in applied if w0 < a[0] and a[1] < w1]
    overlapped = sum(any(a[0] < e and s < a[1] for a in applied)
                     for s, e in spans)
    assert inside, "no churn batch started and landed during the reads"
    assert still_churning and churned[0] >= n, \
        f"the churn stopped early ({churned[0]} rows)"
    assert api_rd.checksum() == oracle, \
        "idempotent re-ingest changed the checksum"
    assert api_rd.query(
        "s17", "Count(Intersect(Row(city=7), Row(device=3)))")[0] \
        == want_count
    api_rd.disable_scheduler()
    out = {"rows": n, "classic_s": classic_s, "classic_rows_s": c1_rows_s,
           "oracle_s": oracle_s, "oracle_rows_s": n / oracle_s,
           "piped_s": piped_s, "piped_rows_s": piped_rows_s,
           "piped_batches": batches, "chunk_rows": C17_CHUNK,
           "ratio": piped_rows_s / c1_rows_s,
           "p50_alone_ms": p50_alone, "p99_alone_ms": p99_alone,
           "p50_busy_ms": p50_busy, "p99_busy_ms": p99_busy,
           "read_gap_ms": gap_s * 1e3, "churn_live_s": live_s,
           "churned_rows": churned[0], "iters": C17_ITERS,
           "window_s": w1 - w0, "window_batches": len(inside),
           "window_rows": sum(a[2] for a in inside),
           "window_sheds": shed_window, "reads_overlapped": overlapped,
           "thread_busy_s": busy, "split_wall_s": split_wall}
    print(f"ingest 12b: config 17, {n} rows: classic CSV Ingester "
          f"{c1_rows_s:,.0f} rows/s (best of 2: " + ", ".join(
              f"{s:.3f}" for s in classic_s) + " s); the classic oracle "
          f"over {len(range(0, n, C17_CHUNK))} chunks of {C17_CHUNK} "
          f"{oracle_s:.3f} s; pipelined ({batches} batches of 32 chunks) "
          f"{piped_rows_s:,.0f} rows/s (best of 3: " + ", ".join(
              f"{s:.3f}" for s in piped_s) + " s); every checksum equal to "
          f"the oracle's {lab}")
    print(f"ingest 12b: a pipelined run of {split_wall:.3f} s: host side "
          f"(_prepare) busy {busy['prepare']:.3f} s, device side (_apply) "
          f"busy {busy['apply']:.3f} s {lab}")
    print(f"ingest 12b: GroupBy p50 / p99 alone {p50_alone:.3f} / "
          f"{p99_alone:.3f} ms, under churn {p50_busy:.3f} / "
          f"{p99_busy:.3f} ms ({C17_ITERS} reads each, "
          f"{gap_s * 1e3:.1f} ms apart); in the {out['window_s']:.3f} s of "
          f"the churned reads {len(inside)} churn batches "
          f"({out['window_rows']} rows) started and landed, {shed_window} "
          f"admits were shed, {overlapped} of {C17_ITERS} reads overlapped "
          f"an apply; churn re-applied {churned[0]} rows in all; checksum "
          f"unchanged; Count and the 100 groups equal numpy {lab}")
    print(f"ingest 12b: bench.py's bars: pipelined / classic "
          f"{out['ratio']:.3f}x (>= 2x) {_bar(out['ratio'] >= 2.0)}; busy / "
          f"alone p50 {p50_busy / p50_alone:.3f}x (<= 1.5x) "
          f"{_bar(p50_busy <= 1.5 * p50_alone)}, p99 "
          f"{p99_busy / p99_alone:.3f}x (<= 1.5x) "
          f"{_bar(p99_busy <= 1.5 * p99_alone)} {lab}")
    out["api"] = api_rd
    return out


def _ingest_kitchen_sink(lab) -> dict:
    """12c: datagen's kitchen-sink through the per-record Batch."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.ingest.datagen import scenario
    from pilosa_tpu_torch.ingest.ingest import Ingester

    t0 = time.perf_counter()
    recs = list(scenario("kitchen-sink", rows=KS_ROWS, seed=1).records())
    gen_s = time.perf_counter() - t0
    idset = {}
    for r in recs:
        for x in set(r["an_idset"]):
            idset[x] = idset.get(x, 0) + 1
    want = {
        'Count(Row(a_mutex="v3"))': sum(r["a_mutex"] == "v3" for r in recs),
        "Count(Row(an_int > 0))": sum(r["an_int"] > 0 for r in recs),
        "Sum(field=an_int)": sum(r["an_int"] for r in recs),
        "Count(Row(a_bool=true))": sum(r["a_bool"] for r in recs),
        **{f"Count(Row(an_idset={x}))": k for x, k in sorted(idset.items())},
    }
    del recs
    api = API()
    got, ingest_s = _synced_s(lambda: Ingester(
        api, "ks", scenario("kitchen-sink", rows=KS_ROWS, seed=1),
        batch_size=65536).run())
    assert got == KS_ROWS, got
    for q, w in want.items():
        r = api.query("ks", q)[0]
        assert (r.val if q.startswith("Sum") else r) == w, (q, r, w)
    out = {"rows": KS_ROWS, "generate_s": gen_s, "ingest_s": ingest_s,
           "rows_s": KS_ROWS / ingest_s, "queries": len(want)}
    print(f"ingest 12c: kitchen-sink, {KS_ROWS} records through Batch in "
          f"{ingest_s:.3f} s, {out['rows_s']:,.0f} rows/s with the "
          f"generator (which alone takes {gen_s:.3f} s); {len(want)} "
          f"answers (Counts, a Range Count, a Sum) equal the records' "
          f"oracle {lab}")
    return out


def _ingest_service(base: str, lab) -> dict:
    """12d: API(path).enable_stream, pushes drained by step, then a kill
    at stream.apply hit 2, a reopen and a resume."""
    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.ingest.source import _parse_header
    from pilosa_tpu_torch.storage.recovery import (CrashPlan,
                                                   SimulatedCrash,
                                                   abandon_holder,
                                                   attach_crash_plan)

    rng = np.random.default_rng(12)
    total = SVC_PUSHES * SVC_PER_PUSH
    city = rng.integers(0, 1000, total)
    dev = rng.integers(0, 10, total)
    recs = [{"id": i, "city": int(c), "device": int(d)}
            for i, (c, d) in enumerate(zip(city, dev))]
    schema = _parse_header(["city__IS", "device__IS"])

    def serve(path, plan=None, api=None):
        api = api if api is not None else API(path)
        if plan is not None:
            attach_crash_plan(api.holder, plan)
        svc = api.enable_stream("taxi", schema=schema,
                                batch_rows=SVC_BATCH_ROWS, plan=plan)
        t0 = time.perf_counter()
        for lo in range(0, total, SVC_PER_PUSH):
            svc.push(recs[lo:lo + SVC_PER_PUSH])
            try:
                svc.step()
            except SimulatedCrash:
                return api, svc, None
        return api, svc, time.perf_counter() - t0

    clean, svc, clean_s = serve(os.path.join(base, "clean"))
    assert clean_s is not None and svc.stats()["rows"] == total
    digest = clean.checksum()
    clean.disable_stream()
    abandon_holder(clean.holder)
    path = os.path.join(base, "crash")
    plan = CrashPlan().kill("stream.apply", at=2)
    api, svc, done = serve(path, plan)
    assert done is None and plan.fired == ("stream.apply", 2), plan.fired
    api.disable_stream()
    abandon_holder(api.holder)
    t0 = time.perf_counter()
    api = API(path)
    reopen_s = time.perf_counter() - t0
    api, svc, resume_s = serve(path, api=api)
    assert resume_s is not None
    assert api.checksum() == digest, "the resumed stream's checksum differs"
    offsets = api.holder.index("taxi").stream_offsets["ingest"]
    assert sum(offsets.values()) == total, offsets
    resumed = svc.stats()["rows"]
    for c, d in ((7, 3), (500, 5)):
        q = f"Count(Intersect(Row(city={c}), Row(device={d})))"
        assert api.query("taxi", q)[0] == int(((city == c) & (dev == d))
                                               .sum()), q
    api.disable_stream()
    abandon_holder(api.holder)
    out = {"records": total, "clean_s": clean_s,
           "clean_rows_s": total / clean_s, "reopen_s": reopen_s,
           "resume_s": resume_s, "resumed_rows": resumed}
    print(f"ingest 12d: enable_stream on API(path), {SVC_PUSHES} pushes of "
          f"{SVC_PER_PUSH} records drained by step in {clean_s:.3f} s "
          f"({out['clean_rows_s']:,.0f} rows/s, batches of "
          f"{SVC_BATCH_ROWS}); killed at stream.apply hit 2, reopened in "
          f"{reopen_s:.3f} s, resumed {resumed} rows in {resume_s:.3f} s; "
          f"checksum equal to the clean run's, offsets sum to {total} {lab}")
    return out


def phase_ingest(report: Report) -> dict:
    """Path 12: ingest and streams (12a config 1, 12b config 17, 12c the
    kitchen sink through Batch, 12d the stream service and a crash)."""
    import shutil

    import numpy as np
    import torch

    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.ops import scatter as SC

    lab = report.label
    base = os.path.abspath(os.path.join("build", "chip_smoke_stream"))
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    t_phase = time.perf_counter()
    out = {}
    try:
        KU.reset_launches()
        _UNCOUNTED.clear()
        for key, fn in (("12a", lambda: _ingest_config1(lab)),
                        ("12b", lambda: _ingest_config17(lab)),
                        ("12c", lambda: _ingest_kitchen_sink(lab)),
                        ("12d", lambda: _ingest_service(base, lab))):
            t0 = time.perf_counter()
            out[key] = fn()
            out[key]["seconds"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        # the main path's own runs: less the reference load and the
        # timed re-runs of 12a and 12b
        launched = {k: v - _UNCOUNTED.get(k, 0)
                    for k, v in KU.launches().items()}
        report.launched("ingest 12", launched,
                        ("scatter_merge", "tape_count", "pair_counts",
                         "bsi_compare"))
    finally:
        shutil.rmtree(base, ignore_errors=True)

    # scatter_merge and pair_counts against their plain versions on path
    # 12's planes and stacks (these launches are not counted)
    api = out["12b"].pop("api")
    idx = api.holder.index("s17")
    frag = idx.field("city").fragment(0)
    rng = np.random.default_rng(12)
    rows = rng.integers(0, 100, 32 * C17_CHUNK)
    slots = np.asarray([frag.row_index[int(r)] for r in range(100)])[rows]
    cols = np.arange(rows.size)
    addr, masks_np = SC.sort_updates(slots, cols, frag.planes.shape[1])
    t = SC._tile_words(frag.planes.size)
    which, packed, _ = SC.pack_tiles(addr, t)
    tiles = frag.planes.reshape(-1, t)[which].reshape(-1)
    device = api.device
    addr_t = torch.from_numpy(packed.astype(np.int32)).to(device)
    masks_t = torch.from_numpy(masks_np.view(np.int32)).to(device)
    # the churn's shape (every bit already set) and a fresh flat
    for flat in (torch.from_numpy(tiles.view(np.int32)).to(device),
                 torch.zeros(tiles.size, dtype=torch.int32, device=device)):
        ours, plain = flat.clone(), flat.clone()
        report.err("scatter_merge", SC.scatter_merge_(ours, addr_t, masks_t),
                   SC.scatter_merge_plain(plain, addr_t, masks_t))
        report.err("scatter_merge", ours, plain)
    cs = STK.stacked_set(idx.field("city"), [0, 1], "standard")
    ds = STK.stacked_set(idx.field("device"), [0, 1], "standard")
    for _, blk in cs.iter_blocks():
        report.err("pair_counts", G.pair_counts(ds.planes, blk),
                   G.pair_counts_plain(ds.planes, blk))
    del api, cs, ds
    out["seconds"] = time.perf_counter() - t_phase
    print(f"ingest 12: launches {launched} (set aside: the reference "
          f"load and the timed re-runs, {dict(_UNCOUNTED)}) {lab}")
    print(f"ingest 12: scatter_merge ({which.size} "
          f"packed tiles of {t} words, {addr.size} updates) and pair_counts "
          f"equal their plain versions on path 12's planes and stacks {lab}")
    print("ingest 12: " + json.dumps(out, default=str))
    print("ingest 12: every pipelined and resumed checksum equals its "
          "oracle; every answer matches numpy or the generated records")
    return out


# ---------------------------------------------------------------------------
# Path 13: SQL (lexer, parser, planner, engine, the bitwise semi-join) with
# the query history and the query log, on bench.py config 23's single node
# ---------------------------------------------------------------------------

#: bench.py config 23: ``ssb.generate(max(_n(120_000), 15_000), seed=7)``
#: loaded by ``ssb.load`` in 500-row INSERTs, 20 iterations a p50
C23_ROWS = 120_000
C23_SEED = 7
C23_ITERS = 20
#: the hash fallback's iterations a flight (bench.py: 20), cut first to
#: keep path 13 inside its 600 s beside the load: a hash-fallback run of
#: a Q2/Q3 flight takes 5-10 s at 120,000 rows on the H100's host. One
#: run since path 20 came: with 2 and 20b already cut to 3 shards, the
#: whole script took 1,136.7 s of its 1,200 s on a slow host
C23_HASH_ITERS = 1
#: the queries whose card time, launches and syncs path 13 prints
C23_CARD = ("Q1.1", "Q2.1", "Q3.1", "Q4.1")
#: bench.py config 23's no-join queries (the join plane must not move)
C23_NO_JOIN = ("SELECT d_year, COUNT(*) FROM ssb_date GROUP BY d_year",
               "SELECT SUM(lo_revenue) FROM lineorder WHERE lo_discount = 3")
_JOIN_COUNTERS = ("sql_join_queries_total", "sql_join_fallback_total")


def _join_counts():
    from pilosa_tpu_torch.obs import metrics as M

    c = M.REGISTRY.snapshot()["counters"]
    return tuple(c.get(k, 0) for k in _JOIN_COUNTERS)


def _sql_load(api, data, lab) -> dict:
    """``ssb.load`` through ``api.sql``, its host seconds split by stage
    (each stage its own time, its wrapped callees' excluded)."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core.fragment import BSIFragment, SetFragment
    from pilosa_tpu_torch.loadgen import ssb
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.ops import scatter as SC
    from pilosa_tpu_torch.sql import engine as E

    clock = _StageClock([
        ("parse", E, "parse_statement"),
        ("records", E.SQLEngine, "_insert"),
        ("batch_upsert", E.SQLEngine, "_batch_upsert"),
        ("import_bits", API, "import_bits"),
        ("import_values", API, "import_values"),
        ("set_mutex_many", SetFragment, "set_mutex_many"),
        ("bsi_set_values", BSIFragment, "set_values"),
        ("scatter (scatter_merge)", SC, "scatter_new_bits_bulk")])
    before = KU.launches()["scatter_merge"]
    try:
        _, load_s = _synced_s(lambda: ssb.load(api.sql, data))
    finally:
        clock.close()
    split = dict(clock.own)
    split["rest"] = load_s - sum(split.values())
    out = {"rows": len(data.lineorder["_id"]), "load_s": load_s,
           "split_s": split, "calls": dict(clock.calls),
           "scatter_merge_launches": KU.launches()["scatter_merge"] - before}
    print(f"sql 13a: config 23 single node, SSB {out['rows']} lineorder rows "
          f"(seed {C23_SEED}) loaded by ssb.load in 500-row INSERTs through "
          f"API.sql in {load_s:.3f} s; {out['scatter_merge_launches']} "
          f"scatter_merge launches {lab}")
    print(f"sql 13a: the load split by host stage: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in split.items()) + f" {lab}")
    return out


def _resident_bytes(idx) -> dict:
    """{field: [stored B, dense B]} of the stacks ``idx``'s fields hold on
    the card now (a compressed block's dense size beside its stored)."""
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import ctiles as C

    out = {}
    for f in idx.fields.values():
        for inner in getattr(f, "_stacked_cache", {}).values():
            for _, st in inner.values():
                blocks = getattr(st, "_blocks", None) or [st._planes]
                for b in blocks:
                    if b is None:
                        continue
                    stored = STK._nbytes(b)
                    dense = (b.dense_nbytes if isinstance(
                        b, C.CompressedBlock) else stored)
                    acc = out.setdefault(f.name, [0, 0])
                    acc[0] += stored
                    acc[1] += dense
    return out


def _card_figures(api, q) -> dict:
    """Warm runs of ``q``: device busy ms, launches per kernel, the
    executor's host waits and the implicit syncs inside one run, and one
    run's host seconds by layer (the SQL parse, planning, the executor's
    calls, and the host operators with the API's own work as the rest)."""
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.pql import executor as EX
    from pilosa_tpu_torch.sql import engine as E
    from pilosa_tpu_torch.sql.planner import Planner

    busy = _device_ms(lambda: api.sql(q), calls=5)
    clock = _StageClock([("parse", E, "parse_statement"),
                         ("plan", Planner, "plan_select"),
                         ("executor", EX.Executor, "execute")])
    try:
        _, total_s = _synced_s(lambda: api.sql(q))
    finally:
        clock.close()
    split = {k: v * 1e3 for k, v in clock.own.items()}
    split["host operators and the rest"] = total_s * 1e3 - sum(
        split.values())
    waits = [0]
    wait0 = EX._wait_copies

    def wait(ev):
        waits[0] += 1
        return wait0(ev)

    before = KU.launches()
    EX._wait_copies = wait
    try:
        _, syncs = _implicit_syncs(lambda: api.sql(q))
    finally:
        EX._wait_copies = wait0
    after = KU.launches()
    return {"busy_ms": busy, "split_ms": split,
            "executor_calls": clock.calls["executor"],
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]},
            "waits": waits[0], "implicit_syncs": len(syncs),
            "sync_sites": sorted(set(syncs))}


def _sql_kernels(report: Report, holder, device) -> None:
    """Each kernel of path 13 against its plain version on the lineorder
    planes of ``holder`` (a single node's, or a cluster node's): the INT
    filter (bsi_compare), the Sum's sign classes (pair_counts), the filter
    under _exists (tape_count) and the last INSERT's _exists bits cleared
    in a copy and set anew (scatter_merge). These launches are not
    counted."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import scatter as SC

    idx = holder.index("lineorder")
    disc = STK.stacked_bsi(idx.field("lo_discount"), [0])
    rev = STK.stacked_bsi(idx.field("lo_revenue"), [0])
    filt = S.bsi_compare_plain(disc.planes, S.BETWEEN, 1, 3)
    report.err("bsi_compare", S.bsi_compare(disc.planes, S.BETWEEN, 1, 3),
               filt)
    rows = rev.planes[S.EXISTS] & filt
    sign = rev.planes[S.SIGN]
    a = torch.stack([rows & ~sign, rows & sign])
    report.err("pair_counts", G.pair_counts(a, rev.planes[S.OFFSET:]),
               G.pair_counts_plain(a, rev.planes[S.OFFSET:]))
    ex = STK.stacked_set(idx.field("_exists"), [0], "standard")
    leaves = [filt, ex.row_plane(0)]
    tape = (("and", 0, 1),)
    report.err("tape_count", B.tape_count(tape, leaves),
               B.tape_count_plain(tape, leaves))
    frag = idx.field("_exists").fragment(0)
    cols = np.arange(C23_ROWS - 500, C23_ROWS + 1)
    addr, masks_np = SC.sort_updates(np.zeros(cols.size, np.int64), cols,
                                     frag.planes.shape[1])
    t = SC._tile_words(frag.planes.size)
    which, packed, _ = SC.pack_tiles(addr, t)
    tiles = frag.planes.reshape(-1, t)[which].reshape(-1)
    # the load set every one of these bits: clear them in the copy,
    # so that both sides set all of them anew
    tiles[packed] &= ~masks_np
    flat = torch.from_numpy(tiles.view(np.int32)).to(device)
    addr_t = torch.from_numpy(packed.astype(np.int32)).to(device)
    masks_t = torch.from_numpy(masks_np.view(np.int32)).to(device)
    ours, plain = flat.clone(), flat.clone()
    new_bits = SC.scatter_merge_plain(plain, addr_t, masks_t)
    assert int(new_bits) == cols.size, \
        f"the replay set {int(new_bits)} new bits of {cols.size}"
    report.err("scatter_merge", SC.scatter_merge_(ours, addr_t, masks_t),
               new_bits)
    report.err("scatter_merge", ours, plain)
    torch.cuda.synchronize()


#: path 13c: warm runs of each query from the coordinator (bench.py
#: times none: its phase 2 is a gate)
C23_CLUSTER_ITERS = 3
#: 13c's spread battery: tests/test_cluster.py::TestSQLFanout's queries
#: over its fs / fu / fo tables (5, 3 and 4 shards of 8 rows)
C23_SPREAD = (
    "select _id, v from fs where v % 4 = 1",
    "select _id from fs where v % 8 = 3",
    "select seg, count(*), avg(v), min(v), max(v) from fs "
    "where v % 2 = 0 group by seg order by seg",
    "select count(distinct seg) from fs where v % 2 = 1",
    "select fu.name, sum(fo.amt) from fu inner join fo on fu._id = fo.uid "
    "where upper(fu.name) = 'U1' group by fu.name",
    "select _id, v from fs where v % 2 = 1 order by v desc limit 3",
    "select v % 4 as v from fs where v % 3 = 1 order by v desc limit 2",
)
_FANOUT_COUNTERS = ("sql_fanout_rows_total",
                    "sql_join_broadcast_bytes_total")


def _fanout_counts():
    from pilosa_tpu_torch.obs import metrics as M

    c = M.REGISTRY.snapshot()["counters"]
    return [c.get(k, 0) for k in _FANOUT_COUNTERS]


def _rpc_ops(c) -> dict:
    """The internal RPCs every node of ``c`` sent so far, by op."""
    out = {}
    for n in c.nodes:
        for k, v in n.client.op_counts.items():
            out[k] = out.get(k, 0) + v
    return out


def _fanout_ops(node, q) -> list:
    """The fan-out operators of ``q``'s plan on ``node``, with their
    index."""
    from pilosa_tpu_torch.sql import SQLEngine

    found = []

    def walk(n):
        if n["op"] in ("FanoutScanOp", "FanoutAggOp"):
            found.append(f"{n['op']}({n.get('fanout', {}).get('index', '')})"
                         if "fanout" in n else n["op"])
        for ch in n.get("children", []):
            walk(ch)
    walk(SQLEngine(node).compile_plan(q).plan_json())
    return found


def _sql_cluster_load(c, data, lab) -> dict:
    """13c's load: ``ssb.load`` through the coordinator's ``sql``, its
    host seconds split by stage (each stage its own time, its wrapped
    callees' excluded). The imports a node routes to a peer run on that
    peer's HTTP thread while the routing call waits, so they nest inside
    it on the one stack, and the routing stage holds the RPCs' own time
    (HTTP and JSON on both ends)."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.cluster.node import ClusterNode
    from pilosa_tpu_torch.core.fragment import BSIFragment, SetFragment
    from pilosa_tpu_torch.loadgen import ssb
    from pilosa_tpu_torch.ops import scatter as SC
    from pilosa_tpu_torch.sql import engine as E

    rpc0 = _rpc_ops(c)
    clock = _StageClock([
        ("parse", E, "parse_statement"),
        ("batch_upsert", E.SQLEngine, "_batch_upsert"),
        ("ClusterNode.import_bits (routing, RPCs)", ClusterNode,
         "import_bits"),
        ("ClusterNode.import_values (routing, RPCs)", ClusterNode,
         "import_values"),
        ("API.import_bits (owners)", API, "import_bits"),
        ("API.import_values (owners)", API, "import_values"),
        ("set_mutex_many", SetFragment, "set_mutex_many"),
        ("bsi_set_values", BSIFragment, "set_values"),
        ("scatter (scatter_merge)", SC, "scatter_new_bits_bulk")])
    try:
        _, load_s = _synced_s(lambda: ssb.load(c.coordinator.sql, data))
    finally:
        clock.close()
    split = dict(clock.own)
    split["rest"] = load_s - sum(split.values())
    rpc = {k: v - rpc0.get(k, 0) for k, v in _rpc_ops(c).items()
           if v - rpc0.get(k, 0)}
    snap = c.coordinator.snapshot()
    owners = [n.id for n in snap.shard_nodes("lineorder", 0)]
    print(f"sql 13c: config 23's 3-node phase: LocalCluster(3, replica_n=2) "
          f"on the card, SSB {len(data.lineorder['_id'])} lineorder rows "
          f"(seed {C23_SEED}) loaded by ssb.load in 500-row INSERTs through "
          f"the coordinator's sql in {load_s:.3f} s; lineorder's shard 0 "
          f"on {owners} {lab}")
    print(f"sql 13c: the load split by host stage: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in split.items()) +
        f" ({dict(clock.calls)} calls); RPCs by op {rpc} {lab}")
    return {"load_s": load_s, "split_s": split, "calls": dict(clock.calls),
            "rpcs": rpc, "lineorder_owners": owners}


def _sql_cluster_answers(c, data, oracles) -> dict:
    """13c's gate: every query from the coordinator and from node1 equals
    the oracle (bench.py phase 2's check); each query's fan-out
    operators and the fan-out rows and broadcast bytes it added; then
    13a's no-join gate from both nodes."""
    import numpy as np

    from pilosa_tpu_torch.loadgen import ssb

    out = {"cold_ms": {}, "plans": {}, "fanout_rows": {},
           "broadcast_bytes": {}}
    for qid, q in ssb.QUERIES.items():
        for node in (c.coordinator, c[1]):
            before = _fanout_counts()
            res, sec = _synced_s(lambda: node.sql(q))
            after = _fanout_counts()
            err = ssb.verify(data, qid, res.data, expected=oracles[qid])
            assert err is None, f"3-node from {node.node.id}: {err}"
            key = f"{qid}@{node.node.id}"
            out["cold_ms"][key] = sec * 1e3
            out["fanout_rows"][key] = after[0] - before[0]
            out["broadcast_bytes"][key] = after[1] - before[1]
        out["plans"][qid] = _fanout_ops(c[1], q)
    aggs = [qid for qid, ops in out["plans"].items()
            if any(o.startswith("FanoutAggOp") for o in ops)]
    assert aggs, f"no query planned a FanoutAggOp: {out['plans']}"
    out["fanout_agg_queries"] = aggs
    # 13a's no-join gate from both nodes: the join plane stays still, the
    # Sum (its legs' BSI sums launch pair_counts) equals numpy
    lo, dates = data.lineorder, data.date
    years, counts = np.unique(np.asarray(dates["d_year"]),
                              return_counts=True)
    want = {C23_NO_JOIN[0]: sorted([int(y), int(n)]
                                   for y, n in zip(years, counts)),
            C23_NO_JOIN[1]: [[int(np.asarray(lo["lo_revenue"])[
                np.asarray(lo["lo_discount"]) == 3].sum())]]}
    before = _join_counts()
    for node in (c.coordinator, c[1]):
        for q in C23_NO_JOIN:
            got = node.sql(q).data
            assert sorted(got) == want[q], (node.node.id, q, got)
    assert _join_counts() == before, "no-JOIN queries touched the join plane"
    return out


def _sql_cluster_spread(c, API, lab) -> dict:
    """13c's spread battery: the fs / fu / fo tables over 5, 3 and 4
    shards on the same cluster, so that the fan-out legs reach more than
    one node; each query from node1 against a single node; a DELETE
    ... WHERE from the coordinator read back from node2."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH as SW

    stmts = [
        "create table fs (_id id, seg id, v int)",
        "insert into fs values " + ",".join(
            f"({s * SW + i}, {(s + i) % 3}, {s * 10 + i})"
            for s in range(5) for i in range(8)),
        "create table fu (_id id, name string, age int)",
        "insert into fu values " + ",".join(
            f"({s * SW + i}, 'u{(s * 8 + i) % 4}', {20 + (s * 8 + i) % 30})"
            for s in range(3) for i in range(8)),
        "create table fo (_id id, uid int, amt int)",
        "insert into fo values " + ",".join(
            f"({s * SW + i}, {(s * 8 + i) * 7 % (5 * SW)}, {i + 1})"
            for s in range(4) for i in range(8)),
    ]
    single = API()
    for target in (c.coordinator, single):
        for stmt in stmts:
            target.sql(stmt)
    held = {n.node.id: _cl_held(n, "fs") for n in c.nodes}
    assert sum(1 for h in held.values() if h) >= 2, held
    out = {"held": held, "plans": {}, "fanout_rows": {}}
    for q in C23_SPREAD:
        before = _fanout_counts()
        got = c[1].sql(q).data
        out["fanout_rows"][q] = _fanout_counts()[0] - before[0]
        want = single.sql(q).data
        ordered = "order by" in q
        assert (got if ordered else sorted(map(tuple, got))) == \
            (want if ordered else sorted(map(tuple, want))), (q, got, want)
        out["plans"][q] = _fanout_ops(c[1], q)
    co = c.coordinator
    co.sql("create table cdel (_id id, v int)")
    co.sql(f"insert into cdel values (5,1),({SW + 5},2),({2 * SW + 5},3)")
    assert c[1].sql("select count(*) from cdel").data == [[3]]
    co.sql("delete from cdel where v >= 2")
    assert c[2].sql("select count(*) from cdel").data == [[1]]
    del single
    print(f"sql 13c: the spread battery (fs over the shards {held}): "
          f"{len(C23_SPREAD)} queries from node1 equal a single node, with "
          f"plans {out['plans']} and fan-out rows {out['fanout_rows']}; a "
          f"DELETE from the coordinator reads back 1 row from node2 {lab}")
    return out


def _sql_cluster_figures(c) -> dict:
    """13c's figures: warm p50s from the coordinator, and the card's
    busy share of one warm Q2.1 (its device time over its wall time)."""
    from pilosa_tpu_torch.loadgen import ssb

    co = c.coordinator
    p50 = {qid: statistics.median(_wall_ms(lambda: co.sql(q))
                                  for _ in range(C23_CLUSTER_ITERS))
           for qid, q in ssb.QUERIES.items()}
    q21 = ssb.QUERIES["Q2.1"]
    wall = statistics.median(_wall_ms(lambda: co.sql(q21))
                             for _ in range(C23_CLUSTER_ITERS))
    busy = _device_ms(lambda: co.sql(q21), calls=C23_CLUSTER_ITERS)
    return {"warm_p50_ms": p50, "q21_wall_ms": wall, "q21_busy_ms": busy,
            "q21_busy_share": None if busy is None else busy / wall}


#: 13c's faulted pass: the delay of lineorder's shard-0 owner on its
#: query and SQL-subtree legs (config 9's ceiling: a fact-side Extract
#: leg takes 0.5-1 s warm, so a shorter delay lets the primary go out
#: beside its hedge and both nodes serve it in the one interpreter)
C23_FAULT_DELAY_S = 2.0
#: and the floor of its adaptive leg timeouts: the client's own 30 s.
#: With the owner and its replica serving one Extract leg at once, a leg
#: took 4.8 s of a 5 s timeout on an H100's host, and a reaped primary
#: and a reaped hedge leave no owner for the shard
C23_TIMEOUT_MIN_MS = 30000.0


def _sql_cluster_faulted(c, plan, data, oracles, owner, lab) -> dict:
    """13c's faulted pass: resilience on with config 14's chaos-wave
    settings (hedges after 30 ms at the least; breakers held shut) but
    leg timeouts floored at C23_TIMEOUT_MIN_MS, since the three nodes
    share one interpreter, one fault-free
    pass of the 13 queries from node0 to fill the latency windows, then
    one with ``owner``'s query and SQL-subtree legs delayed
    C23_FAULT_DELAY_S: every answer equals the oracle; the fan-out waves
    of each kind (PQL legs, SQL subtrees), their hedges and won hedges
    are counted."""
    from pilosa_tpu_torch.loadgen import ssb
    from pilosa_tpu_torch.obs import metrics as M
    from pilosa_tpu_torch.obs.metrics import MetricsRegistry

    co = c.coordinator
    reg = MetricsRegistry()
    res = co.enable_resilience(registry=reg, hedge_min_ms=30.0,
                               timeout_min_ms=C23_TIMEOUT_MIN_MS,
                               breaker_threshold=1 << 30)
    kinds = {"pql": [0, 0, 0], "sql": [0, 0, 0]}  # waves, hedges, wins
    run_legs = res.run_legs

    def counted(remote, nodes, run_remote, next_owners, **kw):
        kind = "sql" if "sql_subtree" in run_remote.__qualname__ else "pql"
        h0 = reg.value(M.METRIC_CLUSTER_HEDGES) or 0.0
        w0 = reg.value(M.METRIC_CLUSTER_HEDGE_WINS) or 0.0
        try:
            return run_legs(remote, nodes, run_remote, next_owners, **kw)
        finally:
            k = kinds[kind]
            k[0] += 1
            k[1] += (reg.value(M.METRIC_CLUSTER_HEDGES) or 0.0) - h0
            k[2] += (reg.value(M.METRIC_CLUSTER_HEDGE_WINS) or 0.0) - w0

    res.run_legs = counted
    ms = {}
    try:
        for q in ssb.QUERIES.values():
            co.sql(q)
        for k in kinds.values():
            k[:] = [0, 0, 0]
        rpc0 = dict(co.client.op_counts)
        plan.delay(owner, C23_FAULT_DELAY_S, op="query")
        plan.delay(owner, C23_FAULT_DELAY_S, op="sql")
        for qid, q in ssb.QUERIES.items():
            res_q, sec = _synced_s(lambda: co.sql(q))
            err = ssb.verify(data, qid, res_q.data, expected=oracles[qid])
            assert err is None, f"3-node under the straggler: {err}"
            ms[qid] = sec * 1e3
        rpcs = {k: v - rpc0.get(k, 0) for k, v in co.client.op_counts.items()
                if v - rpc0.get(k, 0)}
    finally:
        plan.clear()
        co.disable_resilience()
    out = {"owner": owner, "delay_s": C23_FAULT_DELAY_S, "ms": ms,
           "rpcs": rpcs, "seed": plan.seed,
           "waves": {k: v[0] for k, v in kinds.items()},
           "hedges": {k: int(v[1]) for k, v in kinds.items()},
           "wins": {k: int(v[2]) for k, v in kinds.items()}}
    print(f"sql 13c: faulted pass (FaultPlan seed {plan.seed}): {owner}'s "
          f"query and SQL-subtree legs delayed {C23_FAULT_DELAY_S} s, "
          f"resilience on; all 13 queries from node0 equal ssb.oracle in "
          f"{sum(ms.values()):.1f} ms ({', '.join(f'{q} {v:.1f}' for q, v in ms.items())}); "
          f"fan-out waves {out['waves']}, hedges {out['hedges']}, won "
          f"{out['wins']}; RPCs by op {rpcs} {lab}")
    return out


def _sql_cluster(report: Report, data, oracles,
                 device: str = "cuda:0") -> dict:
    """Path 13c: bench.py config 23's phase 2, the SSB load and the 13
    queries through a 3-node LocalCluster(replica_n=2) on the card under
    its seeded FaultPlan (``PILOSA_TPU_FAULT_SEED``, default 23, as
    bench.py seeds it), then the multi-shard fan-out battery and a
    routed DELETE; the launches of that run, figures, the faulted pass
    (:func:`_sql_cluster_faulted`), and the kernels on shard 0's owner's
    planes. A dry run on the CPU passes ``device="cpu"``."""
    import gc

    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.cluster import FaultPlan, LocalCluster
    from pilosa_tpu_torch.loadgen import ssb
    from pilosa_tpu_torch.ops import kernel_util as KU

    lab = report.label
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    KU.reset_launches()
    plan = FaultPlan(seed=int(os.environ.get("PILOSA_TPU_FAULT_SEED", "23")))
    c = LocalCluster(3, replica_n=2, fault_plan=plan, device=device)
    try:
        assert all(n.device == torch.device(device) for n in c.nodes)
        out = {"load": _sql_cluster_load(c, data, lab)}
        out.update(_sql_cluster_answers(c, data, oracles))
        out["spread"] = _sql_cluster_spread(
            c, lambda: API(device=device), lab)
        torch.cuda.synchronize()
        launched = KU.launches()
        report.launched("sql 13c", launched,
                        ("tape_count", "pair_counts", "bsi_compare",
                         "scatter_merge"))
        out["launches"] = launched
        for qid in ssb.QUERIES:
            keys = [f"{qid}@{n}" for n in ("node0", "node1")]
            cold = " / ".join("%.3f" % out["cold_ms"][k] for k in keys)
            rows = " / ".join(str(out["fanout_rows"][k]) for k in keys)
            sent = " / ".join(str(out["broadcast_bytes"][k]) for k in keys)
            print(f"sql 13c: {qid} equals ssb.oracle from node0 and node1, "
                  f"cold {cold} ms; fan-out operators {out['plans'][qid]}; "
                  f"sql_fanout_rows_total +{rows}, "
                  f"sql_join_broadcast_bytes_total +{sent} {lab}")
        print(f"sql 13c: FanoutAggOp planned for "
              f"{out['fanout_agg_queries']}; launches on 13c {launched} "
              f"{lab}")
        out.update(_sql_cluster_figures(c))
        for qid, ms in out["warm_p50_ms"].items():
            print(f"sql 13c: {qid} warm p50 {ms:.3f} ms from the "
                  f"coordinator ({C23_CLUSTER_ITERS} runs) {lab}")
        share = out["q21_busy_share"]
        print(f"sql 13c: one warm Q2.1: wall {out['q21_wall_ms']:.3f} ms, "
              f"card busy {_fmt_ms(out['q21_busy_ms'])}, busy share "
              f"{'not measured' if share is None else f'{share:.4f}'} "
              f"{lab}")
        t1 = time.perf_counter()
        out["faulted"] = _sql_cluster_faulted(
            c, plan, data, oracles, out["load"]["lineorder_owners"][0], lab)
        out["faulted"]["seconds"] = time.perf_counter() - t1
        owner = next(n for n in c.nodes
                     if n.node.id == out["load"]["lineorder_owners"][0])
        _sql_kernels(report, owner.holder, owner.device)
        print(f"sql 13c: the four kernels equal their plain versions on "
              f"{owner.node.id}'s lineorder planes {lab}")
    finally:
        c.close()
        del c
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"sql 13c: {out['seconds']:.2f} s {lab}")
    return out


def phase_sql(report: Report) -> dict:
    """Path 13: SQL over config 23's single node (13a), the query history
    and log (13b), and config 23's 3-node phase (13c)."""
    import shutil

    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.loadgen import ssb
    from pilosa_tpu_torch.obs import metrics as M
    from pilosa_tpu_torch.ops import kernel_util as KU

    lab = report.label
    base = os.path.abspath(os.path.join("build", "chip_smoke_sql"))
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    t_phase = time.perf_counter()
    out = {"cuts": {"hash_iters": C23_HASH_ITERS,
                    "warm_runs_13c": C23_CLUSTER_ITERS}}
    try:
        data = ssb.generate(C23_ROWS, seed=C23_SEED)
        oracles = {qid: ssb.oracle(data, qid) for qid in ssb.QUERIES}
        api = API()
        log_path = os.path.join(base, "query.log")
        api.set_query_logger(log_path)
        c0 = M.REGISTRY.snapshot()["counters"]
        KU.reset_launches()

        # -- 13a: load, the oracle gate, the no-join gate, timings -----------
        out["load"] = _sql_load(api, data, lab)
        cold = {}
        for qid, q in ssb.QUERIES.items():
            res, s = _synced_s(lambda: api.sql(q))
            cold[qid] = s * 1e3
            err = ssb.verify(data, qid, res.data, expected=oracles[qid])
            assert err is None, f"single-node {err}"
        before = _join_counts()
        for q in C23_NO_JOIN:
            api.sql(q)
        assert _join_counts() == before, \
            "no-JOIN queries touched the join plane"
        assert api.sql(C23_NO_JOIN[1]).data == [[int(
            data.lineorder["lo_revenue"][
                data.lineorder["lo_discount"] == 3].sum())]]
        warm = {qid: statistics.median(_wall_ms(lambda: api.sql(q))
                                       for _ in range(C23_ITERS))
                for qid, q in ssb.QUERIES.items()}
        flights = [q for q in ssb.QUERIES if q.startswith(("Q2", "Q3"))]
        hash_p50 = {}
        os.environ["PILOSA_TPU_SEMIJOIN"] = "0"
        try:
            n0 = _join_counts()
            for qid in flights:
                res = []
                hash_p50[qid] = statistics.median(
                    _wall_ms(lambda: res.append(api.sql(ssb.QUERIES[qid])))
                    for _ in range(C23_HASH_ITERS))
                err = ssb.verify(data, qid, res[0].data,
                                 expected=oracles[qid])
                assert err is None, f"hash fallback {err}"
            assert _join_counts()[0] == n0[0], "the semi plane ran"
        finally:
            del os.environ["PILOSA_TPU_SEMIJOIN"]
        speedups = {q: hash_p50[q] / max(warm[q], 1e-6) for q in flights}
        worst = min(speedups, key=speedups.get)
        card = {qid: _card_figures(api, ssb.QUERIES[qid]) for qid in C23_CARD}
        resident = _resident_bytes(api.holder.index("lineorder"))
        out.update(cold_ms=cold, warm_p50_ms=warm, hash_p50_ms=hash_p50,
                   speedups=speedups, card=card, resident=resident)
        print(f"sql 13a: all 13 queries equal ssb.oracle (row multisets and "
              f"ORDER BY keys); the no-join queries left "
              f"{'/'.join(_JOIN_COUNTERS)} at {before} {lab}")
        for qid in ssb.QUERIES:
            print(f"sql 13a: {qid} cold {cold[qid]:.3f} ms, warm p50 "
                  f"{warm[qid]:.3f} ms ({C23_ITERS} runs)" + (
                      f", hash fallback p50 {hash_p50[qid]:.3f} ms "
                      f"({C23_HASH_ITERS} runs), {speedups[qid]:.2f}x"
                      if qid in hash_p50 else "") + f" {lab}")
        print(f"sql 13a: semi-join vs hash fallback on the Q2/Q3 flights: "
              f"worst {worst} at {speedups[worst]:.2f}x; bench.py's 2x bar "
              f"{_bar(speedups[worst] >= 2.0)} (printed, not asserted) "
              f"{lab}")
        for qid, fig in card.items():
            print(f"sql 13a: {qid} card busy {_fmt_ms(fig['busy_ms'])}, "
                  f"launches {fig['launches']}, {fig['waits']} executor "
                  f"waits, {fig['implicit_syncs']} implicit syncs at "
                  f"{fig['sync_sites']}; one run's host ms by layer: " +
                  ", ".join(f"{k} {v:.3f}" for k, v in
                            fig["split_ms"].items()) +
                  f" ({fig['executor_calls']} executor calls) {lab}")
        print(f"sql 13a: lineorder's resident stacks [stored B, dense B]: "
              f"{resident} {lab}")
        print(f"sql 13a: cut: the hash fallback's p50s take "
              f"{C23_HASH_ITERS} runs, not 20")

        # -- 13b: the query history, the query log, the counters ------------
        q11 = ssb.QUERIES["Q1.1"]
        api.sql(q11)
        try:
            api.sql("SELECT nosuch FROM lineorder")
        except KeyError:
            pass
        else:
            raise AssertionError("an unknown column did not fail")
        api.query("lineorder", "Count(Row(lo_discount=3))")
        hist = api.sql("SELECT * FROM fb_exec_requests LIMIT 4")
        names = [n for n, _ in hist.schema]
        got = [(r[names.index("query")], r[names.index("language")],
                r[names.index("status")]) for r in hist.data]
        assert got == [
            ("SELECT * FROM fb_exec_requests LIMIT 4", "sql", "running"),
            ("Count(Row(lo_discount=3))", "pql", "complete"),
            ("SELECT nosuch FROM lineorder", "sql", "error"),
            (q11, "sql", "complete")], got
        perf = dict(api.sql("SELECT * FROM fb_performance_counters").data)
        c1 = M.REGISTRY.snapshot()["counters"]
        n_sql = c1.get(M.METRIC_SQL_QUERIES, 0) - c0.get(
            M.METRIC_SQL_QUERIES, 0)
        n_pql = c1.get(M.METRIC_PQL_QUERIES, 0) - c0.get(
            M.METRIC_PQL_QUERIES, 0)
        assert perf[M.METRIC_SQL_QUERIES] >= n_sql > 0
        with open(log_path) as f:
            lines = [json.loads(x) for x in f]
        kinds = [x["kind"] for x in lines if x["kind"] != "slow"]
        assert (kinds.count("sql"), kinds.count("pql")) == (n_sql, n_pql), \
            (kinds.count("sql"), kinds.count("pql"), n_sql, n_pql)
        assert lines[-1]["kind"] == "sql" and lines[-1]["query"] == \
            "SELECT * FROM fb_performance_counters"
        out["history"] = {"statements": n_sql + n_pql, "log_lines":
                          len(lines), "sql_queries_total":
                          perf[M.METRIC_SQL_QUERIES]}
        print(f"sql 13b: fb_exec_requests lists the path's last statements "
              f"with their language and status; the query log holds one "
              f"line per statement ({n_sql} SQL, {n_pql} PQL); "
              f"fb_performance_counters shows sql_queries_total = "
              f"{perf[M.METRIC_SQL_QUERIES]:.0f} {lab}")

        torch.cuda.synchronize()
        launched = KU.launches()
        expected = ["scatter_merge", "bsi_compare", "pair_counts"]
        if launched.get("tape_count", 0):
            expected.append("tape_count")
        if launched.get("ctile_count", 0):
            expected.append("ctile_count")
        report.launched("sql 13a-13b", launched, expected)

        # each launched kernel against its plain version on path 13's own
        # planes (these launches are not counted)
        _sql_kernels(report, api.holder, api.device)
        del api

        # -- 13c: config 23's 3-node phase (bench.py phase 2) ---------------
        out["13c"] = _sql_cluster(report, data, oracles)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"sql 13: launches on 13a-13b {launched}, on 13c "
          f"{out['13c']['launches']} {lab}")
    print("sql 13: bsi_compare (lo_discount BETWEEN 1 AND 3), pair_counts "
          "(the Sum's sign classes x lo_revenue), tape_count (the filter "
          "under _exists) and scatter_merge (the last INSERT's _exists "
          "bits, cleared and set anew) equal their plain versions on the "
          f"single node's planes and on shard 0's owner's {lab}")
    print("sql 13: " + json.dumps(out, default=str))
    print("sql 13: every answer equals ssb.oracle, from the single node "
          "and from two nodes of the cluster; the join plane stayed still "
          "for the no-join queries")
    return out


# ---------------------------------------------------------------------------
# Path 14: observability (bench.py configs 16 and 15, the device profiler
# at full width, the flight recorder)
# ---------------------------------------------------------------------------

C16_PER_SHARD, C15_PER_SHARD = 80_000, 40_000
C16_QUERIES = [
    "Count(Row(f=3))",
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Count(Union(Row(f=2), Row(g=3), Row(f=5)))",
    "Intersect(Row(f=1), Row(g=2))",
]
C15_QUERIES = ["Count(Row(f=3))", "Intersect(Row(f=1), Row(f=2))",
               "TopN(f, n=4)"]
#: paired off/on rounds (bench.py: max(24, QUERY_ITERS))
C16_PAIRS = 24
#: the JAX package's devprof overhead reading (bench.py config 16)
DEVPROF_OVERHEAD_PCT = 3.0
#: devprof's time per launch against the profiler's: within this many us
#: or this share of the profiler's time, whichever is larger
DEVPROF_AGREE_US, DEVPROF_AGREE_REL = 3.0, 0.30
#: the most any family may read of the card's named peak (a share above
#: it counts bytes or operations the kernel does not do)
PEAK_SHARE_PCT = 105.0
#: 14d's rounds of a TopN over path 1's brand stack (4 blocks at full
#: size) built anew under a 64 MiB budget: 3 evictions a round
C14_FLIGHT_ROUNDS = 6


def _median_wall_ms(fn, n: int = 21) -> float:
    return statistics.median(_wall_ms(fn) for _ in range(n))


def _obs_config16(lab) -> dict:
    """14a: bench.py config 16 at its own sizes. Off: no cost evaluation,
    no profile, no profiler event. On: the same results, and a profile
    with positive MFU and GB/s for each of the four query families;
    paired interleaved off/on p50s."""
    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.obs import devprof
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(16)
    api = API()
    api.create_index("c16")
    api.create_field("c16", "f")
    api.create_field("c16", "g")
    f, g = [], []
    for shard in range(2):
        cols = shard * SHARD_WIDTH + np.arange(C16_PER_SHARD)
        f.append(rng.integers(0, 32, C16_PER_SHARD))
        g.append(rng.integers(0, 16, C16_PER_SHARD))
        api.import_bits("c16", "f", rows=f[-1].tolist(), cols=cols.tolist())
        api.import_bits("c16", "g", rows=g[-1].tolist(), cols=cols.tolist())
    api.holder.prewarm("c16")
    f, g = np.concatenate(f), np.concatenate(g)
    cols = np.concatenate([s * SHARD_WIDTH + np.arange(C16_PER_SHARD)
                           for s in range(2)])
    want = [int((f == 3).sum()), int(((f == 1) & (g == 1)).sum()),
            int(((f == 2) | (g == 3) | (f == 5)).sum()),
            cols[(f == 1) & (g == 2)].tolist()]

    def workload():
        return [api.query_json("c16", q) for q in C16_QUERIES]

    assert not devprof.ENABLED, "unset PILOSA_TPU_DEVPROF for path 14"
    evals0, allocs0 = devprof.cost_evals(), devprof.KERNELS.allocations
    events0 = devprof.EVENTS_CREATED
    off = workload()
    got = [r["results"][0] for r in off]
    assert got[:3] == want[:3] and got[3]["columns"] == want[3], \
        "config 16 disagrees with numpy"
    for _ in range(5):
        workload()
    assert devprof.cost_evals() == evals0, "devprof off evaluated costs"
    assert devprof.KERNELS.allocations == allocs0, \
        "devprof off allocated profiles"
    assert devprof.EVENTS_CREATED == events0, "devprof off made events"
    devprof.enable()
    try:
        devprof.reset()
        assert workload() == off, "devprof changed config 16's results"
        off_t, on_t = [], []
        for _ in range(C16_PAIRS):
            devprof.disable()
            off_t.append(_wall_ms(workload))
            devprof.enable()
            on_t.append(_wall_ms(workload))
        profiles = devprof.KERNELS.snapshot()
    finally:
        devprof.disable()
    assert len(profiles) >= len(C16_QUERIES), profiles
    for p in profiles:
        assert p["dispatches"] > 0, p
        assert p.get("mfu_pct", 0) > 0 and p.get("achieved_gbps", 0) > 0, p
    off_ms, on_ms = statistics.median(off_t), statistics.median(on_t)
    pct = (on_ms / off_ms - 1.0) * 100.0
    print(f"14a config 16: off p50 {off_ms:.4f} ms, on p50 {on_ms:.4f} ms "
          f"a round of {len(C16_QUERIES)} queries ({C16_PAIRS} paired "
          f"rounds), overhead {pct:+.2f}%: the JAX package's "
          f"<={DEVPROF_OVERHEAD_PCT:.0f}% reading "
          f"{_bar(pct <= DEVPROF_OVERHEAD_PCT)} {lab}")
    for p in profiles:
        print(f"14a profile {p['family']}: {p['dispatches']} dispatches, "
              f"{p['us_per_dispatch']} us/dispatch, "
              f"{p['achieved_gbps']} GB/s, bw {p.get('bw_util_pct')}%, "
              f"mfu {p.get('mfu_pct')}% {lab}")
    return {"off_ms": off_ms, "on_ms": on_ms, "overhead_pct": pct,
            "families": sorted(p["family"] for p in profiles)}


def _launch_overhead(lab) -> dict:
    """14a: host time of one tape_count call (2 leaves x 196,608 words)
    with the profiler off and on, and the kernel's clock beside its time
    in a profiler trace."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.obs import devprof
    from pilosa_tpu_torch.ops import bitmap as B

    rng = np.random.default_rng(14)
    dev = torch.device("cuda", 0)
    x, y = (_rand_words(rng, (6 * 32768,), dev) for _ in range(2))
    tape = (("and", 0, 1),)

    def host_us(n=2000):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            B.tape_count(tape, [x, y])
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    host_us(200)
    off_us = [host_us()]
    devprof.enable()
    try:
        devprof.reset()
        on_us = [host_us()]
        devprof.disable()
        off_us.append(host_us())
        devprof.enable()
        on_us.append(host_us())
        devprof.KERNELS.snapshot()
        k = devprof.KERNELS
        clock_us = k.other_device_s / k.other_dispatches * 1e6
    finally:
        devprof.disable()
    kernel_ms = _device_ms(lambda: B.tape_count(tape, [x, y]), "tape_",
                           calls=200)
    off, on = statistics.median(off_us), statistics.median(on_us)
    print(f"14a tape_count call: {off:.2f} us host off, {on:.2f} us on "
          f"(+{on - off:.2f} us: a timing slot and the profile's update); "
          f"kernel clock {clock_us:.2f} us, trace {_fmt_ms(kernel_ms)} "
          f"(back-to-back calls) {lab}")
    return {"host_off_us": off, "host_on_us": on, "clock_us": clock_us,
            "kernel_ms": kernel_ms}


def _obs_config15(lab) -> dict:
    """14b: bench.py config 15 at its own sizes: no samples while the
    plane is off; enable_health(interval_ms=10.0) samples, feeds the
    query SLO and keeps results; a threaded phase whose sampler thread
    ``disable_health`` joins."""
    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.obs import metrics as M
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(15)
    api = API()
    api.create_index("c15")
    api.create_field("c15", "f")
    f = []
    for shard in range(2):
        rows = rng.integers(0, 8, C15_PER_SHARD)
        cols = shard * SHARD_WIDTH + np.arange(C15_PER_SHARD)
        api.import_bits("c15", "f", rows=rows.tolist(), cols=cols.tolist())
        f.append(rows)
    counts = np.bincount(np.concatenate(f), minlength=8)

    def workload():
        return [api.query_json("c15", q) for q in C15_QUERIES]

    assert api.health is None
    before = M.REGISTRY.value(M.METRIC_TIMELINE_SAMPLES)
    disabled = workload()
    assert disabled[0]["results"][0] == int(counts[3])
    assert disabled[1]["results"][0]["columns"] == []
    top = disabled[2]["results"][0]["rows"]
    assert [r["count"] for r in top] == sorted(counts, reverse=True)[:4]
    off_ms = _median_wall_ms(workload)
    assert M.REGISTRY.value(M.METRIC_TIMELINE_SAMPLES) == before, \
        "the disabled health plane sampled"
    hp = api.enable_health(interval_ms=10.0)
    try:
        assert workload() == disabled, "the health plane changed results"
        on_ms = _median_wall_ms(workload)
        sampled = len(hp.timeline)
        events = {r["surface"]: r["events_fast"]
                  for r in hp.slo.burn_rates()}
    finally:
        api.disable_health()
    assert sampled > 0, "the health plane never sampled"
    assert events.get("query", 0) > 0, "no query reached the SLO tracker"
    hp = api.enable_health(interval_ms=10.0, start=True)
    thread = hp.timeline._thread
    t_end = time.perf_counter() + 0.3
    while time.perf_counter() < t_end:
        workload()
    threaded = len(hp.timeline)
    api.disable_health()
    thread.join(timeout=5.0)
    assert threaded > 0 and not thread.is_alive() \
        and hp.timeline._thread is None, "the sampler thread outlived it"
    pct = (on_ms / off_ms - 1.0) * 100.0
    print(f"14b config 15: disabled p50 {off_ms:.4f} ms, always-on p50 "
          f"{on_ms:.4f} ms a round of {len(C15_QUERIES)} queries "
          f"({pct:+.2f}%), {sampled} samples, {events.get('query')} query "
          f"SLO events; threaded: {threaded} samples in 0.3 s, thread "
          f"joined {lab}")
    return {"off_ms": off_ms, "on_ms": on_ms, "overhead_pct": pct,
            "samples": sampled, "threaded_samples": threaded}


#: per kernel: the profiler's kernel-name fragment and devprof's family
_DEVPROF_KERNELS = {
    "tape_count": ("tape_", lambda fam: fam.startswith("count/")),
    "pair_counts": ("pc_", lambda fam: "/mm1" in fam),
    "bsi_compare": ("bsi_compare", lambda fam: "/cmp1" in fam),
    "ctile_count": ("ctile_count", lambda fam: "/pop1" in fam),
    "scatter_merge": ("scatter_merge", lambda fam: "/scatter1" in fam),
}


def _profiled_us(fn, fragment: str, calls: int, prep,
                 events: list = None) -> float:
    """Mean microseconds per launch of kernels named ``fragment`` in a
    ``torch.profiler`` trace of ``calls`` calls of ``fn``, each after
    ``prep()``. ``events``, when given, receives every device event of
    the trace as (name, start us, duration us) in start order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prep()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            prep()
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if fragment in e.key]
    n = sum(e.count for e in hits)
    assert n, f"the trace holds no {fragment!r} kernel"
    if events is not None:
        events.extend(sorted(
            ((e.name, e.time_range.start, e.time_range.elapsed_us())
             for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda x: x[1]))
    return sum(e.self_device_time_total for e in hits) / n


def _trace_launches(fragment: str, events: list) -> dict:
    """The launches of kernels named ``fragment`` in ``events`` (from
    :func:`_profiled_us`): each one's duration and start offset from the
    first, in us, and every other device operation that overlaps one of
    them. One long launch and a shift of all of them read apart here."""
    mine = [e for e in events if fragment in e[0]]
    t0 = mine[0][1] if mine else 0.0
    spans = [(s, s + d) for _, s, d in mine]
    others = [(n, round(s - t0, 2), round(d, 2)) for n, s, d in events
              if fragment not in n
              and any(s < b and s + d > a for a, b in spans)]
    return {"launches": [(round(s - t0, 2), round(d, 2))
                         for _, s, d in mine],
            "overlapping": others}


def _devprof_us(fn, match, calls: int, prep):
    """devprof's (us per dispatch, dispatches, bw %, mfu %) over the
    families ``match`` picks, for ``calls`` calls of ``fn``."""
    import torch

    from pilosa_tpu_torch.obs import devprof

    prep()
    fn()
    torch.cuda.synchronize()
    devprof.enable()
    try:
        devprof.reset()
        for _ in range(calls):
            prep()
            fn()
        rows = [r for r in devprof.KERNELS.snapshot() if match(r["family"])]
    finally:
        devprof.disable()
    assert rows, "devprof recorded no dispatch of the family"
    n = sum(r["dispatches"] for r in rows)
    s = sum(r["device_seconds"] for r in rows)
    bw = max(r.get("bw_util_pct", 0.0) for r in rows)
    mfu = max(r.get("mfu_pct", 0.0) for r in rows)
    return s / n * 1e6, n, bw, mfu


def _obs_full_width(report, ssb, bsi, by_date, c1, lab) -> dict:
    """14c: the profiler over the APIs paths 1, 2, 3 and 5 built: each
    kernel's devprof time per launch against the profiler's kernel time
    of the same calls, with L2 flushed before each call, on an idle card
    (a sync first) and on a busy one (a 2 ms spin kernel ahead, so the
    kernel does not wait for the host's launch), within max(3 us, 30%)
    in both; every share of the named card's peaks at most
    PEAK_SHARE_PCT. One call of each through its entry point counts
    toward path 14's launches; the timed runs do not."""
    import torch

    from pilosa_tpu_torch.obs import devprof
    from pilosa_tpu_torch.probes import import_probe as IP

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    spin = int(2e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3)

    def idle():
        flush.zero_()
        torch.cuda.synchronize()

    def busy():
        flush.zero_()
        torch.cuda._sleep(spin)

    city, batch = c1["city"], IP.C1_BATCH
    ids = list(range(batch))
    work = {
        "tape_count": lambda: ssb["api"].query(
            "ssb", 'Count(Intersect(Row(year=1), Row(brand="MFGR#1003")))'),
        "pair_counts": lambda: ssb["api"].query(
            "ssb", "GroupBy(Rows(year), Rows(brand), limit=100)"
                   "TopN(brand, n=10)"),
        "bsi_compare": lambda: bsi["api"].query(
            "b", "Sum(Row(amount > 524288), field=amount)"),
        "ctile_count": lambda: by_date["api"].query(
            "ssb_by_date", "TopN(orderdate, n=10)"),
        # the first config-1 batch again: its bits are set, the merge and
        # count still run
        "scatter_merge": lambda: c1["api"].import_bits(
            "taxi", "city", rows=city[:batch], cols=ids),
    }
    calls = {"scatter_merge": 8}
    out = {}
    for name, fn in work.items():
        fragment, match = _DEVPROF_KERNELS[name]
        n = calls.get(name, 20)
        fn()
        row = {}
        for mode, prep in (("idle", idle), ("busy", busy)):
            events = []
            with _uncounted():
                dp_us, launches, bw, mfu = _devprof_us(fn, match, n, prep)
                tr_us = _profiled_us(fn, fragment, n, prep, events)
            ok = abs(dp_us - tr_us) <= max(DEVPROF_AGREE_US,
                                            DEVPROF_AGREE_REL * tr_us)
            if not ok:
                # F.3: tell one long event from a shift of all of them
                print(f"14c {name} ({mode}) missed: the trace's "
                      f"{fragment!r} launches [start offset us, us] and "
                      f"the device ops overlapping them: "
                      f"{json.dumps(_trace_launches(fragment, events))}")
            row[mode] = {"devprof_us": dp_us, "trace_us": tr_us,
                         "dispatches": launches, "bw_util_pct": bw,
                         "mfu_pct": mfu, "agree": ok}
            print(f"14c {name} ({mode}): devprof {dp_us:.2f} us/dispatch "
                  f"over {launches}, trace {tr_us:.2f} us/launch, within "
                  f"max({DEVPROF_AGREE_US:.0f} us, "
                  f"{DEVPROF_AGREE_REL:.0%}): {_bar(ok)}; bw {bw:.2f}%, "
                  f"mfu {mfu:.4f}% of {devprof.backend_name()} {lab}")
            assert bw <= PEAK_SHARE_PCT and mfu <= PEAK_SHARE_PCT, \
                f"{name}: a share above {PEAK_SHARE_PCT}% of the peak"
        out[name] = row
    del flush
    torch.cuda.empty_cache()
    off = {k: v for k, v in out.items()
           if not (v["idle"]["agree"] and v["busy"]["agree"])}
    assert not off, f"devprof and the profiler disagree: {off}"
    return out


def probe_f3(report, args, n: int) -> list:
    """ROADMAP C's F.3 probe (``python3 chip_smoke.py --f3-probe N``):
    path 2's index built as path 2 builds it, then 14c's busy
    ``bsi_compare`` measurement (20 filtered Sums, each behind a 2 ms
    spin kernel with L2 flushed) taken ``n`` times: devprof's time per
    dispatch, the trace's time per launch, the check's verdict, and
    every traced launch's start offset and duration with the device
    operations overlapping them. Written to ``build/f3_probe.json``."""
    import torch

    bsi = phase_bsi_path(report, args)
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    spin = int(2e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3)

    def busy():
        flush.zero_()
        torch.cuda._sleep(spin)

    def fn():
        return bsi["api"].query("b", "Sum(Row(amount > 524288), "
                                     "field=amount)")

    fragment, match = _DEVPROF_KERNELS["bsi_compare"]
    rows = []
    for i in range(n):
        events = []
        dp_us = _devprof_us(fn, match, 20, busy)[0]
        tr_us = _profiled_us(fn, fragment, 20, busy, events)
        ok = abs(dp_us - tr_us) <= max(DEVPROF_AGREE_US,
                                        DEVPROF_AGREE_REL * tr_us)
        tl = _trace_launches(fragment, events)
        durs = sorted(d for _, d in tl["launches"])
        rows.append({"devprof_us": dp_us, "trace_us": tr_us, "agree": ok,
                     **tl})
        print(f"f3 probe {i}: devprof {dp_us:.2f} us, trace {tr_us:.2f} "
              f"us/launch over {len(durs)} launches (min "
              f"{durs[0]:.2f}, median {durs[len(durs) // 2]:.2f}, max "
              f"{durs[-1]:.2f}), {_bar(ok)}; {len(tl['overlapping'])} "
              f"overlapping device ops" + (
                  "" if ok else f": {json.dumps(tl)}") + f" {report.label}")
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "f3_probe.json"), "w") as f:
        json.dump({"card": report.label, "rows": rows}, f)
    missed = sum(1 for r in rows if not r["agree"])
    print(f"f3 probe: {missed} of {n} busy traces missed the check "
          f"{report.label}")
    return rows


def _obs_flight(ssb, lab) -> dict:
    """14d: under a ManualClock, path 1's brand stack through a budget
    too small to hold it: evictions above the eviction rate fire
    ``eviction_storm``, whose bundle holds the residency and kernels
    probes; the resident-bytes gauge equals ``BUDGET.used`` after every
    charge and release. The budget is restored afterwards."""
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.obs import devprof
    from pilosa_tpu_torch.obs import metrics as M
    from pilosa_tpu_torch.sched.clock import ManualClock

    api, budget = ssb["api"], STK.BUDGET
    checks = {"charge": 0, "release": 0}
    real = {k: getattr(budget, k) for k in checks}

    def checked(kind):
        def call(*a, **kw):
            real[kind](*a, **kw)
            checks[kind] += 1
            for g in (M.METRIC_DEVICE_HBM_RESIDENT_BYTES,
                      M.METRIC_DEVICE_BUDGET_RESIDENT_BYTES):
                assert M.REGISTRY.value(g) == budget.used, (kind, g)
        return call

    cap = budget.cap
    clock = ManualClock()
    hp = api.enable_health(clock=clock, eviction_rate=10.0)
    devprof.enable()
    try:
        for k in checks:
            setattr(budget, k, checked(k))
        budget.cap = 64 << 20
        hp.timeline.sample()
        ev0 = STK.PAGING_STATS["evictions"]
        for _ in range(C14_FLIGHT_ROUNDS):
            _release(api, "ssb")  # each round builds and charges anew
            api.query("ssb", "TopN(brand, n=10)")
        evictions = STK.PAGING_STATS["evictions"] - ev0
        clock.advance(1.0)
        hp.timeline.sample()
        storms = [b for b in hp.flight.bundles()
                  if b["trigger"] == "eviction_storm"]
    finally:
        budget.cap = cap
        for k in checks:
            setattr(budget, k, real[k])
        devprof.disable()
        api.disable_health()
    assert evictions > 10, f"only {evictions} evictions"
    assert storms, "no eviction_storm bundle"
    probes = storms[0]["sample"]["probes"]
    assert probes["residency"]["evictions"] >= evictions, probes["residency"]
    assert probes["kernels"]["enabled"] and probes["kernels"]["kernels"], \
        probes["kernels"]
    print(f"14d flight recorder: {evictions} evictions in 1 s of "
          f"ManualClock -> {storms[0]['reason']!r}; bundle keys "
          f"{sorted(storms[0])}; gauge == BUDGET.used after "
          f"{checks['charge']} charges and {checks['release']} releases "
          f"{lab}")
    return {"evictions": evictions, "reason": storms[0]["reason"],
            "charges": checks["charge"], "releases": checks["release"]}


def phase_observability(report: Report, ssb: dict, bsi: dict, by_date: dict,
                        c1: dict) -> dict:
    """Path 14: bench.py configs 16 and 15, the device profiler over
    paths 1, 2, 3 and 5's full-width APIs, and the flight recorder."""
    from pilosa_tpu_torch.ops import kernel_util as KU

    lab = report.label
    KU.reset_launches()
    _UNCOUNTED.clear()
    out = {"14a": _obs_config16(lab)}
    with _uncounted():  # a microbenchmark, not the path's traffic
        out["14a_launch"] = _launch_overhead(lab)
    out["14b"] = _obs_config15(lab)
    out["14c"] = _obs_full_width(report, ssb, bsi, by_date, c1, lab)
    out["14d"] = _obs_flight(ssb, lab)
    # configs 16 and 15, one entry-point call a kernel in 14c, and 14d
    launched = {k: v - _UNCOUNTED.get(k, 0)
                for k, v in KU.launches().items()}
    report.launched("observability", launched,
                    ("tape_count", "pair_counts", "bsi_compare",
                     "ctile_count", "scatter_merge"))
    for name, row in out["14c"].items():
        report.kernel(name, devprof=row)
    print("observability path: " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------------------
# Path 21: the mesh reduces (parallel/mesh.py) on paths 1 and 2's indexes
# ---------------------------------------------------------------------------

#: kernel launches per block of each reduce, by kernel
MESH_KERNELS = {
    "count": {"tape_count": 1},
    "intersect_count": {"tape_count": 1},
    "row_counts": {"pair_counts": 1},
    "groupby_counts": {"pair_counts": 1},
    "bsi_sum_counts": {"pair_counts": 1, "tape_count": 1},
}
#: parts of those kernels' names in a trace
MESH_TRACE_NAMES = ("tape_", "pc_")
MESH_ITERS = 11
MESH_TRACE_CALLS = 10


def _set_planes(field, shards: int, rows) -> "np.ndarray":
    """Host planes ``uint32[S, len(rows), 32768]`` of a set field's
    standard view, rows in the order given."""
    import numpy as np

    from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

    out = np.zeros((shards, len(rows), WORDS_PER_SHARD), np.uint32)
    for s in range(shards):
        frag = field.fragment(s, "standard")
        if frag is None:
            continue
        for k, r in enumerate(rows):
            if frag.has_row(r):
                out[s, k] = frag.row_plane(r)
    return out


def _bsi_planes(field, shards: int):
    """(``uint32[S, P, 32768]`` BSI planes, exists ``bool[S, 2^20]``,
    values ``int64[S, 2^20]``) from the host fragments, the values
    decoded in numpy."""
    import numpy as np

    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

    frags = [field.bsi_fragment(s) for s in range(shards)]
    depth = max(f.planes.shape[0] for f in frags if f is not None)
    planes = np.zeros((shards, depth, WORDS_PER_SHARD), np.uint32)
    exists = np.zeros((shards, SHARD_WIDTH), bool)
    values = np.zeros((shards, SHARD_WIDTH), np.int64)
    for s, f in enumerate(frags):
        if f is None:
            continue
        planes[s, :f.planes.shape[0]] = f.planes
        bits = np.unpackbits(planes[s].view(np.uint8), bitorder="little"
                             ).reshape(depth, SHARD_WIDTH)
        exists[s] = bits[S.EXISTS].astype(bool)
        mag = np.zeros(SHARD_WIDTH, np.int64)
        for k in range(depth - S.OFFSET):
            mag |= bits[S.OFFSET + k].astype(np.int64) << k
        values[s] = np.where(bits[S.SIGN].astype(bool), -mag, mag)
    return planes, exists, values


def _pack(bits) -> "np.ndarray":
    import numpy as np

    return np.packbits(bits, axis=-1, bitorder="little").view("<u4")


def _mesh_small(report: Report, device) -> dict:
    """The five reduces at the unit tests' widths (8 shards x 512 words
    over 8 virtual devices at col_parallel 1, 2 and 4: blocks of 512,
    256 and 128 words) on the card, against numpy."""
    import numpy as np

    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.parallel import ShardPlacement, analytics_mesh

    rng = np.random.default_rng(21)
    n_s, w = 8, 512
    raw = rng.random((n_s, 9, w * 32)) < 0.3
    planes = _pack(raw)
    cols = np.arange(w * 32)
    bsi, filt, total, count = [], [], 0, 0
    for _ in range(n_s):
        vals = rng.integers(-5000, 5000, cols.size)
        bsi.append(S.encode_values(cols, vals, 14, w))
        keep = rng.random(cols.size) < 0.5
        filt.append(_pack(keep))
        total += int(vals[keep].sum())
        count += int(keep.sum())
    bsi, filt = np.stack(bsi), np.stack(filt)
    out = {}
    for cp in (1, 2, 4):
        pl = ShardPlacement(analytics_mesh([device] * 8, col_parallel=cp))
        got_rows = pl.row_counts(pl.place(planes))
        assert (got_rows == raw.sum(axis=(0, 2))).all(), cp
        assert pl.count(pl.place(planes[:, 0])) == int(raw[:, 0].sum())
        assert pl.intersect_count(pl.place(planes[:, 1]),
                                  pl.place(planes[:, 2])) == \
            int((raw[:, 1] & raw[:, 2]).sum())
        gb = pl.groupby_counts(pl.place(planes[:, :4]),
                               pl.place(planes[:, 4:]))
        want = np.einsum("sgw,srw->gr", raw[:, :4].astype(np.int64),
                         raw[:, 4:].astype(np.int64))
        assert (gb == want).all(), cp
        c, per = pl.bsi_sum_counts(pl.place(bsi), pl.place(filt))
        assert (c, sum(int(per[k]) << k for k in range(14))) == \
            (count, total), cp
        out[cp] = "ok"
    return out


def _mesh_reduce(report: Report, name: str, pl, placed: tuple, want,
                 mesh_label: str, lab: str) -> dict:
    """Check one reduce against ``want`` (bit for bit), then its p50, its
    launches per call (exact, from the counters) and its device ops per
    call in a trace."""
    import numpy as np

    from pilosa_tpu_torch.ops import kernel_util as KU

    fn = getattr(pl, name)
    got = fn(*placed)
    if isinstance(want, tuple):
        ok = got[0] == want[0] and np.array_equal(got[1], want[1])
    else:
        ok = np.array_equal(np.asarray(got), np.asarray(want))
    assert ok, f"mesh {mesh_label} {name} disagrees: {got} != {want}"
    blocks = len(placed[0].flat())
    per_call = {k: v * blocks for k, v in MESH_KERNELS[name].items()}
    with _uncounted():
        before = KU.launches()
        fn(*placed)
        after = KU.launches()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        assert moved == per_call, (name, mesh_label, moved, per_call)
        p50 = statistics.median(_wall_ms(lambda: fn(*placed))
                                for _ in range(MESH_ITERS))
        want_k = MESH_TRACE_CALLS * sum(per_call.values())
        # a trace can lose events (one of an H100 held 5 of 10 launches
        # of groupby_counts; ROADMAP F.2); one that holds under half is
        # taken again, up to twice more, and the retakes are printed
        for retakes in range(3):
            traced = _device_ops(lambda: fn(*placed),
                                 calls=MESH_TRACE_CALLS)
            kern = sum(k for op, (k, _) in traced.items()
                       if any(t in op for t in MESH_TRACE_NAMES))
            if kern >= want_k // 2:
                break
    assert want_k // 2 <= kern <= want_k, \
        f"{name} on {mesh_label}: {kern} kernel events, {want_k} " \
        f"launches: {traced}"
    ops = sum(k for k, _ in traced.values())
    row = {"p50_ms": round(p50, 4), "blocks": blocks,
           "kernels_per_call": sum(per_call.values()),
           "traced_kernels_per_call": kern / MESH_TRACE_CALLS,
           "trace_retakes": retakes,
           "device_ops_per_call": ops / MESH_TRACE_CALLS,
           "bytes_placed": sum(p.nbytes for p in placed)}
    print(f"mesh path: {mesh_label} {name}: p50 {p50:.4f} ms, {blocks} "
          f"blocks x {sum(MESH_KERNELS[name].values())} kernels = "
          f"{sum(per_call.values())} launches a call "
          f"({kern / MESH_TRACE_CALLS:.1f} kernel and "
          f"{ops / MESH_TRACE_CALLS:.1f} device ops a call in a trace, "
          f"{retakes} retakes), "
          f"{row['bytes_placed']} bytes placed {lab}")
    return row


def phase_mesh(report: Report, ssb: dict, bsi: dict, device=None) -> dict:
    """Path 21: the five mesh reduces on path 1's SSB SF-1 index and path
    2's BSI index, placed on a one-device mesh and on a virtual 2 x 2
    mesh over ``cuda:0``, each bit for bit against numpy and the
    executor's own answers."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.parallel import ShardPlacement, analytics_mesh

    lab = report.label
    device = torch.device(device or "cuda:0")
    KU.reset_launches()
    _UNCOUNTED.clear()
    t0 = time.perf_counter()
    out = {"small": _mesh_small(report, device)}

    # -- the executor's answers and numpy's --------------------------------
    api, year_of, brand_of = ssb["api"], ssb["year_of"], ssb["brand_of"]
    names, bid = ssb["names"], ssb["bid"]
    idx = api.holder.index("ssb")
    shards = int(year_of.size // (1 << 20))
    years, brands = 7, len(names)
    key_b = {names[b]: b for b in range(brands)}
    want = {}
    want["count"] = int((year_of == 1).sum())
    want["intersect_count"] = int(((year_of == 1) & (brand_of == 3)).sum())
    want["row_counts"] = np.bincount(brand_of, minlength=brands)
    want["groupby_counts"] = np.bincount(
        year_of * brands + brand_of,
        minlength=years * brands).reshape(years, brands)
    with _uncounted():  # the executor's answers: references, not the path
        ex = {"count": api.query("ssb", "Count(Row(year=1))")[0],
              "intersect_count": api.query(
                  "ssb", 'Count(Intersect(Row(year=1), '
                         'Row(brand="MFGR#1003")))')[0]}
        top = api.query("ssb", f"TopN(brand, n={brands})")[0]
        groups = api.query("ssb", "GroupBy(Rows(year), Rows(brand), "
                                  f"limit={years * brands})")[0]
        vc = bsi["api"].query(
            "b", "Sum(Row(amount > 524288), field=amount)")[0]
    ex["row_counts"] = np.zeros(brands, np.int64)
    for p in top.pairs:
        ex["row_counts"][key_b[p.key]] = p.count
    ex["groupby_counts"] = np.zeros((years, brands), np.int64)
    for g in groups:
        ex["groupby_counts"][g.group[0].row_id,
                             key_b[g.group[1].row_key]] = g.count
    for k in ex:
        assert np.array_equal(np.asarray(ex[k]), np.asarray(want[k])), \
            f"the executor's {k} disagrees with numpy"

    bapi, bshards = bsi["api"], bsi["shards"]
    half = 524288
    bplanes, exists, values = _bsi_planes(
        bapi.holder.index("b").field("amount"), bshards)
    keep = exists & (values > half)
    bfilt = _pack(keep)
    want_sum = (int(values[keep].sum()), int(keep.sum()))
    assert (vc.val, vc.count) == want_sum, (vc, want_sum)
    # numpy's per-plane popcounts under the filter, pos - neg, from the
    # decoded values
    mag_pos = values[keep & (values >= 0)]
    mag_neg = -values[keep & (values < 0)]
    want_per = np.array([int(((mag_pos >> k) & 1).sum())
                         - int(((mag_neg >> k) & 1).sum())
                         for k in range(bplanes.shape[1] - S.OFFSET)],
                        np.int32)

    year_h = _set_planes(idx.field("year"), shards, list(range(years)))
    brand_h = _set_planes(idx.field("brand"), shards,
                          [bid[b] for b in range(brands)])
    prep_s = time.perf_counter() - t0

    meshes = {"1 device": analytics_mesh([device]),
              "2 x 2 virtual": analytics_mesh([device] * 4, col_parallel=2)}
    depth = bplanes.shape[1] - S.OFFSET
    for label, mesh in meshes.items():
        pl = ShardPlacement(mesh)
        rows = {}
        t1 = time.perf_counter()
        py, pb = pl.place(year_h), pl.place(brand_h)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t1
        y1, b3 = pl.place(year_h[:, 1]), pl.place(brand_h[:, 3])
        rows["count"] = _mesh_reduce(report, "count", pl, (y1,),
                                     want["count"], label, lab)
        rows["intersect_count"] = _mesh_reduce(
            report, "intersect_count", pl, (y1, b3),
            want["intersect_count"], label, lab)
        rows["row_counts"] = _mesh_reduce(report, "row_counts", pl, (pb,),
                                          want["row_counts"], label, lab)
        rows["groupby_counts"] = _mesh_reduce(
            report, "groupby_counts", pl, (py, pb), want["groupby_counts"],
            label, lab)
        del py, pb, y1, b3  # the brand placement is 786 MB at SF-1
        pp, pf = pl.place(bplanes), pl.place(bfilt)
        c, per = pl.bsi_sum_counts(pp, pf)
        got_sum = sum(int(per[k]) << k for k in range(depth))
        assert (got_sum, c) == want_sum, (label, got_sum, c, want_sum)
        rows["bsi_sum_counts"] = _mesh_reduce(
            report, "bsi_sum_counts", pl, (pp, pf), (want_sum[1], want_per),
            label, lab)
        del pp, pf
        torch.cuda.empty_cache()
        rows["place_s"] = round(place_s, 3)
        out[label] = rows
    launched = {k: v - _UNCOUNTED.get(k, 0)
                for k, v in KU.launches().items()}
    report.launched("mesh", launched, ("tape_count", "pair_counts"))
    print(f"mesh path: {shards} SSB shards x {years} years x {brands} "
          f"brands and {bshards} BSI shards of depth {depth}; numpy and "
          f"executor answers {prep_s:.2f} s; launches {launched}; every "
          f"reduce matches numpy and the executor bit for bit on both "
          f"meshes {lab}")
    print("mesh path: " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------------------
# Path 15: front ends (a server process on the card; bench.py configs 1
# and 2 loaded and read over HTTP, SQL and framed gRPC; the CLI; a crash)
# ---------------------------------------------------------------------------

FE_C1_ROWS = 1_000_000  # bench.py config 1 (bench.py:163-185)
FE_C2_SHARDS = 10  # bench.py config 2 (bench.py:219-270)
FE_WRITES = 64
FE_IMPORT = 4096
FE_CLIENTS, FE_CLIENT_QUERIES = 16, 32
FE_ITERS = 50
FE_SECRET = "chip-smoke-secret"
FE_PERMS = ('user-groups:\n  "readers":\n    "taxi": "read"\n    "b": "read"\n'
            '  "writers":\n    "taxi": "write"\n    "b": "write"\n'
            'admin: "admins"\n')
FE_TREE = ("Count(Union(Intersect(Row(city=1), Row(device=2)), "
           "Difference(Row(city=5), Row(device=3))))")
FE_SQL_C1 = "SELECT COUNT(*) FROM taxi WHERE SETCONTAINS(city, 3)"
FE_SQL_C2 = "SELECT SUM(amount) FROM b WHERE amount > 524288"


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _fe_call(base, method, path, body=None, ctype="application/json",
             token=None, raw=False):
    """(status, JSON body or raw bytes, headers) of one request."""
    import urllib.error
    import urllib.request

    data = body if body is None or isinstance(body, bytes) \
        else json.dumps(body).encode()
    r = urllib.request.Request(base + path, data=data, method=method)
    r.add_header("Content-Type", ctype)
    if token:
        r.add_header("Authorization", "Bearer " + token)
    try:
        with urllib.request.urlopen(r, timeout=600) as resp:
            code, payload, headers = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        code, payload, headers = e.code, e.read(), e.headers
    return code, (payload if raw else json.loads(payload)), headers


def _fe_ok(base, path, body, token=None, ctype="text/plain"):
    code, out, _ = _fe_call(base, "POST", path, body, ctype, token)
    assert code == 200, f"{path}: HTTP {code}: {out}"
    return out


class _FeServer:
    """``python -m pilosa_tpu_torch server --config <toml>`` in a process
    of its own (spawned, never forked from this CUDA process), with
    ``PILOSA_TPU_DEVPROF=1``; its stderr goes to a file, printed when the
    server fails. ``wait=False`` returns once the process is started;
    :meth:`ready` then waits for ``GET /health``."""

    def __init__(self, base_dir: str, name: str, data_dir: str,
                 auth: bool = False, wait: bool = True):
        port = _free_port()
        self.base = f"http://127.0.0.1:{port}"
        toml = os.path.join(base_dir, f"{name}.toml")
        lines = ['bind = "127.0.0.1"', f"port = {port}",
                 f'data-dir = "{data_dir}"', 'wal-sync = "batch"']
        if auth:
            perms = os.path.join(base_dir, "permissions.yaml")
            with open(perms, "w") as f:
                f.write(FE_PERMS)
            lines += ["[auth]", "enable = true", f'secret = "{FE_SECRET}"',
                      f'permissions-file = "{perms}"']
        with open(toml, "w") as f:
            f.write("\n".join(lines) + "\n")
        self.log_path = os.path.join(base_dir, f"{name}.stderr")
        self.log = open(self.log_path, "w")
        env = dict(os.environ, PILOSA_TPU_DEVPROF="1",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch", "server",
             "--config", toml], env=env, stdout=subprocess.DEVNULL,
            stderr=self.log)
        if wait:
            self.ready()

    def ready(self) -> None:
        try:
            self._wait_health(deadline_s=180.0)
        except BaseException:
            self.kill()
            raise

    def _wait_health(self, deadline_s: float) -> None:
        import urllib.error
        import urllib.request

        end = time.monotonic() + deadline_s
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"server exited {self.proc.returncode}"
                                     f": {self.stderr()}")
            try:
                with urllib.request.urlopen(self.base + "/health",
                                            timeout=5) as r:
                    if r.status == 200:
                        return
            except (urllib.error.URLError, OSError):
                pass
            if time.monotonic() > end:
                raise AssertionError(f"no /health in {deadline_s} s: "
                                     f"{self.stderr()}")
            time.sleep(0.05)

    def stderr(self) -> str:
        self.log.flush()
        with open(self.log_path) as f:
            return f.read()[-4000:]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)
        self.log.close()


def _fe_dispatches(stats: dict) -> dict:
    """Each kernel's dispatches from ``GET /internal/stats/kernels``:
    ``pallas/…/mm1`` is pair_counts, ``cmp1`` bsi_compare, ``scatter1``
    scatter_merge, ``pop1`` ctile_count; tape_count launches in a count
    family or, outside one, in ``other``."""
    names = {"mm1": "pair_counts", "cmp1": "bsi_compare",
             "scatter1": "scatter_merge", "pop1": "ctile_count"}
    out = dict.fromkeys(("tape_count", "pair_counts", "bsi_compare",
                         "scatter_merge", "ctile_count"), 0)
    assert stats.get("enabled"), f"the server's profiler is off: {stats}"
    for k in stats["kernels"]:
        kind, _, rest = k["family"].partition("/")
        if kind == "count":
            out["tape_count"] += k["dispatches"]
        elif kind == "pallas":
            out[names[rest.split("/")[1].split("#")[0]]] += k["dispatches"]
    out["tape_count"] += stats["other"]["dispatches"]
    return out


class _FeOracle:
    """Config 1's records (``city``, ``device``; -1 where a record has no
    bit) and config 2's ``amount``, with every acknowledged write."""

    def __init__(self, city, dev, amount):
        import numpy as np

        self.city, self.dev = city.copy(), dev.copy()
        self.amount = amount
        self.np = np

    def add(self, cols, city=None, dev=None):
        np = self.np
        top = int(max(cols)) + 1
        if top > self.city.size:
            pad = np.full(top - self.city.size, -1, dtype=np.int64)
            self.city = np.concatenate([self.city, pad])
            self.dev = np.concatenate([self.dev, pad])
        if city is not None:
            self.city[cols] = city
        if dev is not None:
            self.dev[cols] = dev

    def answers(self) -> dict:
        np = self.np
        city, dev = self.city, self.dev
        counts = np.bincount(city[city >= 0], minlength=1000)
        pairs = np.bincount(city[(city >= 0) & (dev >= 0)] * 10
                            + dev[(city >= 0) & (dev >= 0)],
                            minlength=10_000)
        groups = [{"group": [{"field": "city", "rowID": int(i // 10)},
                             {"field": "device", "rowID": int(i % 10)}],
                   "count": int(pairs[i])}
                  for i in np.nonzero(pairs)[0][:100]]
        tree = int((((city == 1) & (dev == 2))
                    | ((city == 5) & (dev != 3))).sum())
        big = self.amount[self.amount > 524288]
        return {
            ("taxi", "Count(Row(city=3))"): [int(counts[3])],
            ("taxi", "TopN(city, n=10)"): [{"rows": [
                {"id": i, "count": c} for i, c in _want_top(
                    {i: int(x) for i, x in enumerate(counts)}, 10)],
                "field": "city"}],
            ("taxi", "GroupBy(Rows(city), Rows(device), limit=100)"):
                [groups],
            ("taxi", FE_TREE): [tree],
            ("b", "Sum(Row(amount > 524288), field=amount)"):
                [{"value": int(big.sum()), "count": int(big.size)}],
        }


def _fe_read_all(base, oracle, token=None) -> None:
    """Every 15a read over HTTP, SQL and framed gRPC against the
    oracle."""
    from pilosa_tpu_torch.server import grpc as G
    from pilosa_tpu_torch.server import proto as PR

    want = oracle.answers()
    for (index, q), res in want.items():
        got = _fe_ok(base, f"/index/{index}/query", q.encode(), token)
        assert got["results"] == res, f"{q}: {got} != {res}"
    n3 = want[("taxi", "Count(Row(city=3))")][0]
    s = want[("b", "Sum(Row(amount > 524288), field=amount)")][0]["value"]
    for q, res in ((FE_SQL_C1, [[n3]]), (FE_SQL_C2, [[s]])):
        got = _fe_ok(base, "/sql", q.encode(), token)["data"]
        assert got == res, f"{q}: {got} != {res}"
    code, body, headers = _fe_call(
        base, "POST", "/grpc/pilosa.Pilosa/QueryPQLUnary",
        G.frame(PR._str_field(1, "taxi")
                + PR._str_field(2, "Count(Row(city=3))")),
        "application/grpc", token, raw=True)
    assert code == 200 and headers["grpc-status"] == "0", (code, headers)
    assert PR.decode_table_response(G.unframe(body)[0])[1] == [[n3]]
    code, body, headers = _fe_call(
        base, "POST", "/grpc/pilosa.Pilosa/QuerySQL",
        G.frame(PR._str_field(1, FE_SQL_C2)), "application/grpc", token,
        raw=True)
    assert code == 200 and headers["grpc-status"] == "0", (code, headers)
    assert PR.decode_row_response(G.unframe(body)[0])[1] == [s]


def _fe_load(base, lab) -> tuple:
    """15a's load through the port's Client: config 1 with ``sync_schema``
    and ``import_bits`` (one roaring blob per shard and field), config
    2's ``amount`` with ``import_values``, a shard a request."""
    import numpy as np

    from pilosa_tpu_torch.client import Client, Schema
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    c = Client(base, timeout=600)
    schema = Schema()
    taxi = schema.index("taxi")
    taxi.field("city", type="set")
    taxi.field("device", type="set")
    b = schema.index("b")
    b.field("amount", type="int")
    c.sync_schema(schema)
    rng = np.random.default_rng(1)  # bench_config1's generator
    city = rng.integers(0, 1000, FE_C1_ROWS)
    dev = rng.integers(0, 10, FE_C1_ROWS)
    ids = range(FE_C1_ROWS)
    t0 = time.perf_counter()
    c.import_bits("taxi", "city", list(zip(city.tolist(), ids)))
    t1 = time.perf_counter()
    c.import_bits("taxi", "device", list(zip(dev.tolist(), ids)))
    t2 = time.perf_counter()
    amount = np.random.default_rng(2).integers(0, 1 << 20,
                                               FE_C2_SHARDS * SHARD_WIDTH)
    for s in range(FE_C2_SHARDS):
        lo = s * SHARD_WIDTH
        c.import_values("b", "amount", list(zip(
            range(lo, lo + SHARD_WIDTH),
            amount[lo:lo + SHARD_WIDTH].tolist())))
    t3 = time.perf_counter()
    secs = {"city": t1 - t0, "device": t2 - t1, "amount": t3 - t2}
    print(f"frontends 15a: config 1 ({FE_C1_ROWS:,} records, seed 1) "
          "through Client.import_bits in "
          f"{secs['city']:.3f} + {secs['device']:.3f} s, config 2's amount "
          f"({FE_C2_SHARDS} x 2^20 values, seed 2) through import_values, a "
          f"shard a request, in {secs['amount']:.3f} s {lab}")
    return _FeOracle(city, dev, amount), secs


def _fe_writes(base, oracle) -> dict:
    """64 ``Set`` writes over HTTP, then one JSON import batch, onto the
    resident stacks; each read back."""
    import numpy as np

    n0 = oracle.city.size
    for k in range(FE_WRITES):
        col = n0 + k
        out = _fe_ok(base, "/index/taxi/query",
                     f"Set({col}, city={k % 7})Set({col}, device=7)"
                     .encode())
        assert out["results"] == [True, True], out
        oracle.add([col], city=k % 7, dev=7)
        if k % 16 == 15:
            got = _fe_ok(base, "/index/taxi/query",
                         f"Count(Intersect(Row(city={k % 7}), "
                         f"Row(device=7)))".encode())["results"][0]
            want = int(((oracle.city == k % 7) & (oracle.dev == 7)).sum())
            assert got == want, (got, want)
    cols = np.arange(oracle.city.size, oracle.city.size + FE_IMPORT)
    rows = np.random.default_rng(15).integers(0, 1000, cols.size)
    out = _fe_ok(base, "/index/taxi/import",
                 {"field": "city", "rows": rows.tolist(),
                  "cols": cols.tolist()}, ctype="application/json")
    assert out == {"changed": FE_IMPORT}, out
    oracle.add(cols, city=rows)
    r = int(rows[0])
    got = _fe_ok(base, "/index/taxi/query",
                 f"Count(Row(city={r}))".encode())["results"][0]
    assert got == int((oracle.city == r).sum())
    return {"sets": FE_WRITES, "imported": FE_IMPORT}


def _fe_cli(base, base_dir, lab) -> dict:
    """15b: the CLI against the first server: a CSV field's import and
    export, ``SELECT COUNT(*)`` piped into fbsql, ``chksum`` against
    ``GET /internal/chksum``, and ``backup``."""
    import contextlib
    import io

    import numpy as np

    from pilosa_tpu_torch.ctl import main as ctl

    _fe_ok(base, "/index/csv", {}, ctype="application/json")
    _fe_ok(base, "/index/csv/field/f", {}, ctype="application/json")
    rng = np.random.default_rng(151)
    pairs = sorted({(int(r), int(c)) for r, c in zip(
        rng.integers(0, 8, 300), rng.integers(0, 3 << 20, 300))})
    path = os.path.join(base_dir, "in.csv")
    with open(path, "w") as f:
        f.write("".join(f"{r},{c}\n" for r, c in pairs))
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert ctl(["import", "--host", base, "--index", "csv", "--field",
                    "f", path]) == 0
        assert ctl(["export", "--host", base, "--index", "csv", "--field",
                    "f"]) == 0
    got = sorted(tuple(int(x) for x in line.split(","))
                 for line in out.getvalue().split())
    assert got == pairs, "the CSV round trip changed the field"
    n = _fe_ok(base, "/sql", b"SELECT COUNT(*) FROM taxi")["data"][0][0]
    r = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch", "fbsql", "--host", base],
        input="SELECT COUNT(*) FROM taxi\n", capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__))))
    assert r.returncode == 0 and str(n) in r.stdout.split(), r.stdout
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ctl(["chksum", "--host", base]) == 0
    chk = out.getvalue().strip()
    assert chk == _fe_call(base, "GET", "/internal/chksum")[1]["checksum"]
    tar = os.path.join(base_dir, "backup.tar")
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        assert ctl(["backup", "--host", base, "--output", tar]) == 0
    backup_s = time.perf_counter() - t0
    print(f"frontends 15b: the CLI's CSV import / export of {len(pairs)} "
          f"bits round-trips, fbsql answers COUNT(*) = {n}, chksum equals "
          f"GET /internal/chksum, backup {os.path.getsize(tar):,} B in "
          f"{backup_s:.3f} s {lab}")
    return {"chksum": chk, "tar": tar, "backup_s": backup_s,
            "records": n, "pairs": pairs}


def _fe_p50_ms(conn, method, path, body, n=FE_ITERS, check=None) -> float:
    """Median ms of ``n`` requests over one keep-alive connection."""
    lat = []
    for i in range(n + 5):
        t0 = time.perf_counter()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "text/plain"})
        resp = conn.getresponse()
        data = resp.read()
        if i >= 5:
            lat.append((time.perf_counter() - t0) * 1e3)
        assert resp.status == 200, data
        if check is not None:
            check(json.loads(data))
    return statistics.median(lat)


def _fe_figures(base, oracle, lab) -> dict:
    """15d: keep-alive p50s, the profiled Count's split, 16 concurrent
    clients."""
    import http.client
    import threading
    from urllib.parse import urlsplit

    import numpy as np

    host, port = urlsplit(base).hostname, urlsplit(base).port
    want = oracle.answers()
    count_q = "Count(Row(city=3))"
    gb_q = "GroupBy(Rows(city), Rows(device), limit=100)"
    conn = http.client.HTTPConnection(host, port, timeout=600)
    out = {
        "count_p50_ms": _fe_p50_ms(
            conn, "POST", "/index/taxi/query", count_q.encode(),
            check=lambda r: r["results"] == want[("taxi", count_q)]),
        "groupby_p50_ms": _fe_p50_ms(
            conn, "POST", "/index/taxi/query", gb_q.encode(),
            check=lambda r: r["results"] == want[("taxi", gb_q)]),
        "status_p50_ms": _fe_p50_ms(conn, "GET", "/status", None),
    }
    walls, spans = [], []

    def pql_span(node):
        if node["name"] == "query.pql":
            return node["duration_ns"]
        return next((d for c in node.get("children", [])
                     if (d := pql_span(c)) is not None), None)

    for _ in range(FE_ITERS):
        t0 = time.perf_counter()
        conn.request("POST", "/index/taxi/query?profile=true",
                     body=count_q.encode(),
                     headers={"Content-Type": "text/plain"})
        doc = json.loads(conn.getresponse().read())
        walls.append((time.perf_counter() - t0) * 1e3)
        assert doc["results"] == want[("taxi", count_q)]
        spans.append(pql_span(doc["profile"]) / 1e6)
    conn.close()
    out["profiled_count_p50_ms"] = statistics.median(walls)
    out["query_pql_span_p50_ms"] = statistics.median(spans)
    out["front_end_p50_ms"] = statistics.median(
        w - s for w, s in zip(walls, spans))
    # 16 concurrent clients, each on its own keep-alive connection
    city, dev = oracle.city, oracle.dev
    qs = [(f"Count(Intersect(Row(city={c}), Row(device={d})))",
           int(((city == c) & (dev == d)).sum()))
          for c, d in np.random.default_rng(16).integers(
              0, (1000, 10), (FE_CLIENT_QUERIES, 2)).tolist()]
    errors, answered = [], []

    def client(k):
        try:
            cn = http.client.HTTPConnection(host, port, timeout=600)
            for i in range(FE_CLIENT_QUERIES):
                q, w = qs[(i + k) % len(qs)]
                cn.request("POST", "/index/taxi/query", body=q.encode(),
                           headers={"Content-Type": "text/plain"})
                r = json.loads(cn.getresponse().read())
                assert r["results"] == [w], (q, r, w)
                answered.append(1)
            cn.close()
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(FE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    assert not errors, errors[:3]
    assert len(answered) == FE_CLIENTS * FE_CLIENT_QUERIES
    out["clients_qps"] = len(answered) / wall
    print("frontends 15d: keep-alive p50 Count "
          f"{out['count_p50_ms']:.3f} ms, GroupBy "
          f"{out['groupby_p50_ms']:.3f} ms, GET /status "
          f"{out['status_p50_ms']:.3f} ms; the profiled Count "
          f"{out['profiled_count_p50_ms']:.3f} ms = query.pql "
          f"{out['query_pql_span_p50_ms']:.3f} ms + the front end's "
          f"{out['front_end_p50_ms']:.3f} ms; {FE_CLIENTS} clients x "
          f"{FE_CLIENT_QUERIES} Counts: {out['clients_qps']:.1f} QPS, "
          f"every answer equal to numpy {lab}")
    return out


def _fe_crash(base_dir, data_dir, oracle, backup, lab) -> dict:
    """15c: restart on the SIGKILLed server's data directory with auth
    on; the acknowledged writes and 15a's answers, the auth codes; then
    ``restore --source`` into a third server on an empty directory."""
    import contextlib
    import io

    from pilosa_tpu_torch.ctl import main as ctl
    from pilosa_tpu_torch.server.auth import issue_token

    tok = {g: issue_token(FE_SECRET, [g])
           for g in ("readers", "writers", "admins")}
    # the restore's server starts beside the restart: both wait for
    # their process and the card, not for each other
    third = _FeServer(base_dir, "restore",
                      os.path.join(base_dir, "restored"), wait=False)
    try:
        out = _fe_restart(base_dir, data_dir, oracle, backup, tok)
        third.ready()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            assert ctl(["restore", "--host", third.base, "--source",
                        backup["tar"]]) == 0
        out["restore_s"] = time.perf_counter() - t0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert ctl(["chksum", "--host", third.base]) == 0
        assert buf.getvalue().strip() == backup["chksum"], \
            "restore changed the checksum"
    finally:
        third.kill()
    print("frontends 15c: after SIGKILL every acknowledged write reads "
          "back and every 15a answer is equal, restart to first answer "
          f"{out['restart_to_first_answer_s']:.3f} s; auth codes "
          f"{out['auth_codes']}; restore --source into an empty server in "
          f"{out['restore_s']:.3f} s, chksum equal {lab}")
    return out


def _fe_restart(base_dir, data_dir, oracle, backup, tok) -> dict:
    """The SIGKILLed server's directory under a new process with auth
    on: the acknowledged writes, 15a's answers, the checksum, the auth
    codes."""
    srv = _FeServer(base_dir, "restart", data_dir, auth=True)
    out = {}
    try:
        code, first, _ = _fe_call(srv.base, "POST", "/index/taxi/query",
                                  b"Count(Row(city=3))", "text/plain",
                                  tok["admins"])
        out["restart_to_first_answer_s"] = time.perf_counter() - srv.t0
        assert code == 200, first
        _fe_read_all(srv.base, oracle, tok["admins"])
        n0 = FE_C1_ROWS
        for k in range(FE_WRITES):  # every acknowledged Set
            got = _fe_ok(srv.base, "/index/taxi/query",
                         f"Row(city={k % 7})".encode(), tok["readers"])
            assert n0 + k in got["results"][0]["columns"], k
        assert _fe_call(srv.base, "GET", "/internal/chksum", token=tok[
            "admins"])[1]["checksum"] == backup["chksum"]
        codes = {
            "no token": _fe_call(srv.base, "POST", "/index/taxi/query",
                                 b"Count(Row(city=3))", "text/plain")[0],
            "reader's read": _fe_call(srv.base, "POST", "/index/taxi/query",
                                      b"Count(Row(city=3))", "text/plain",
                                      tok["readers"])[0],
            "reader's write": _fe_call(srv.base, "POST", "/index/taxi/query",
                                       b"Set(5, city=5)", "text/plain",
                                       tok["readers"])[0],
            "writer's new index": _fe_call(srv.base, "POST", "/index/w", {},
                                           token=tok["writers"])[0],
            "admin's chksum": _fe_call(srv.base, "GET", "/internal/chksum",
                                       token=tok["admins"])[0],
        }
        assert codes == {"no token": 401, "reader's read": 200,
                         "reader's write": 403, "writer's new index": 403,
                         "admin's chksum": 200}, codes
        out["auth_codes"] = codes
    finally:
        srv.kill()
    return out


def _fe_kernels(report, data_dir, oracle, pairs, lab) -> None:
    """15e: the first server's data directory opened in-process on the
    card; the kernels against their plain versions on its planes, at the
    shapes the server launched them."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import scatter as SC

    api = API(data_dir)
    taxi = api.holder.index("taxi")
    city = STK.stacked_set(taxi.field("city"), [0], "standard")
    dev = STK.stacked_set(taxi.field("device"), [0], "standard")
    leaves = [city.row_plane(3), dev.row_plane(7)]
    tape = (("and", 0, 1),)
    report.err("tape_count", B.tape_count(tape, leaves),
               B.tape_count_plain(tape, leaves))
    # GroupBy(Rows(city), Rows(device)) as the server's dense GroupBy
    # launches it: each city block as A against each device block as B
    blocks = []
    for _, a_blk in city.iter_blocks():
        row = []
        for _, b_blk in dev.iter_blocks():
            got = G.masked_pair_counts(a_blk, b_blk, None)
            report.err("pair_counts", got, G.pair_counts_plain(a_blk, b_blk))
            row.append(got)
        blocks.append(torch.cat(row, dim=1))
    mat = torch.cat(blocks).cpu().numpy()
    mat = mat[:len(city.row_ids), :len(dev.row_ids)]
    want = np.zeros((1000, 10), dtype=np.int64)
    both = (oracle.city >= 0) & (oracle.dev >= 0)
    np.add.at(want, (oracle.city[both], oracle.dev[both]), 1)
    assert np.array_equal(
        mat, want[np.ix_(city.row_ids, dev.row_ids)]), \
        "the GroupBy's count matrix differs from numpy"
    n_pair = len(blocks) * dev.n_blocks
    amount = STK.stacked_bsi(api.holder.index("b").field("amount"),
                             list(range(FE_C2_SHARDS)))
    got = S.bsi_compare(amount.planes, S.GT, 524288)
    report.err("bsi_compare", got,
               S.bsi_compare_plain(amount.planes, S.GT, 524288))
    assert int(B.tape_count(((("or", 0, 0),)), [got])) == int(
        (oracle.amount > 524288).sum())
    # the JSON import's bits, cleared in a copy of their tiles and set anew
    frag = taxi.field("city").fragment(0)
    cols = np.arange(oracle.city.size - FE_IMPORT, oracle.city.size)
    slots = np.array([frag.row_index[int(r)] for r in oracle.city[cols]])
    addr, masks_np = SC.sort_updates(slots, cols, frag.planes.shape[1])
    t = SC._tile_words(frag.planes.size)
    which, packed, _ = SC.pack_tiles(addr, t)
    tiles = frag.planes.reshape(-1, t)[which].reshape(-1)
    tiles[packed] &= ~masks_np
    flat = torch.from_numpy(tiles.view(np.int32)).to(api.device)
    addr_t = torch.from_numpy(packed.astype(np.int32)).to(api.device)
    masks_t = torch.from_numpy(masks_np.view(np.int32)).to(api.device)
    ours, plain = flat.clone(), flat.clone()
    new_bits = SC.scatter_merge_plain(plain, addr_t, masks_t)
    assert int(new_bits) == cols.size, int(new_bits)
    report.err("scatter_merge", SC.scatter_merge_(ours, addr_t, masks_t),
               new_bits)
    report.err("scatter_merge", ours, plain)
    # the CSV field's compressed blocks, counted as Rows(f) counted them
    # in the server (StackedSet.row_counts: one zeroed output, each
    # block's rows at its offset)
    csv = api.holder.index("csv")
    f = STK.stacked_set(csv.field("f"), sorted(csv.shards()), "standard")
    held = [(bi, f._ensure_block(bi)) for bi in range(f.n_blocks)]
    held = [(bi, b) for bi, b in held if isinstance(b, C.CompressedBlock)]
    assert held, "the CSV field's stack holds no compressed block"
    cbs, offs = [b for _, b in held], [bi * f.block_rows for bi, _ in held]
    outs = [torch.zeros(f.cap, dtype=torch.int32, device=api.device)
            for _ in range(2)]
    report.err("ctile_count", C.ctile_count_blocks(cbs, None, outs[0], offs),
               C.ctile_count_blocks_plain(cbs, None, outs[1], offs))
    rows = np.array([r for r, _ in pairs])
    want_rows = np.bincount(rows, minlength=max(f.row_ids) + 1)[f.row_ids]
    assert np.array_equal(f.row_counts().cpu().numpy()[:len(f.row_ids)],
                          want_rows), "the CSV field's row counts differ"
    torch.cuda.synchronize()
    n_cb = len(cbs)
    del api, city, dev, amount, f, held, cbs, outs
    print("frontends 15e: tape_count (city=3 AND device=7), pair_counts "
          "(each city block against each device block as the GroupBy "
          f"launches it, launches: {n_pair}; the 1,000 x 10 matrix equals "
          f"numpy), bsi_compare (amount > 524288 over {FE_C2_SHARDS} "
          f"shards), scatter_merge (the JSON import's {FE_IMPORT:,} bits, "
          "cleared in a copy and set anew) and ctile_count (the CSV "
          f"field's compressed blocks: {n_cb}) equal their plain versions "
          f"on the first server's planes {lab}")


def phase_frontends(report: Report) -> dict:
    """Path 15: the front ends. A server process on the card loads
    bench.py configs 1 and 2 through the port's Client and answers over
    HTTP, SQL and framed gRPC (15a); the CLI against it (15b); figures
    (15d); a SIGKILL, a restart with auth, a restore (15c); the kernels
    on its planes (15e)."""
    import shutil

    lab = report.label
    base_dir = os.path.abspath(os.path.join("build", "chip_smoke_frontend"))
    shutil.rmtree(base_dir, ignore_errors=True)
    os.makedirs(base_dir)
    data_dir = os.path.join(base_dir, "data")
    t_phase = time.perf_counter()
    out = {}
    try:
        srv = _FeServer(base_dir, "first", data_dir)
        try:
            out["start_s"] = time.perf_counter() - srv.t0
            info = _fe_call(srv.base, "GET", "/info")[1]
            import torch

            want_dev = f"cuda:0 {torch.cuda.get_device_name(0)}"
            assert info["devices"][0] == want_dev and "H100" in want_dev, \
                f"/info names {info['devices']}, not the H100"
            oracle, out["load_s"] = _fe_load(srv.base, lab)
            _fe_read_all(srv.base, oracle)
            out["writes"] = _fe_writes(srv.base, oracle)
            _fe_read_all(srv.base, oracle)
            print("frontends 15a: /info names "
                  f"{info['devices'][0]}; Count, TopN, GroupBy, the Count "
                  "tree and the Sum over HTTP, the counts as SQL and as "
                  "framed gRPC (QueryPQLUnary, QuerySQL) equal numpy before "
                  f"and after {FE_WRITES} Sets and a {FE_IMPORT}-bit JSON "
                  f"import {lab}")
            backup = _fe_cli(srv.base, base_dir, lab)
            out["cli"] = {k: v for k, v in backup.items()
                          if k not in ("tar", "pairs")}
            out["figures"] = _fe_figures(srv.base, oracle, lab)
            stats = _fe_call(srv.base, "GET", "/internal/stats/kernels")[1]
            launched = _fe_dispatches(stats)
        finally:
            srv.kill()  # SIGKILL after the last acknowledged write
        report.launched("frontends 15", launched,
                        ("tape_count", "pair_counts", "scatter_merge",
                         "bsi_compare", "ctile_count"))
        out["launches"] = launched
        out["15c"] = _fe_crash(base_dir, data_dir, oracle, backup, lab)
        _fe_kernels(report, data_dir, oracle, backup["pairs"], lab)
    finally:
        shutil.rmtree(base_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"frontends 15: the server's dispatches (GET "
          f"/internal/stats/kernels) {launched} {lab}")
    print("frontends 15: " + json.dumps(out, default=str))
    return out


#: path 16a's queries; path 1 answers them on its single node too
CL_SSB_QUERIES = (
    "Count(Row(year=3))",
    'Count(Intersect(Row(year=3), Row(brand="MFGR#1007")))',
    "TopN(brand, n=10)",
    "GroupBy(Rows(year), Rows(brand), limit=100)",
    "GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)",
)
CL_HALF = 524288
#: path 16b's queries over config 2's amount
CL_BSI_QUERIES = (
    f"Count(Row(amount > {CL_HALF}))",
    f"Sum(Row(amount > {CL_HALF}), field=amount)",
    "Min(field=amount)",
    "Max(field=amount)",
    "Percentile(field=amount, nth=50)",
    "Percentile(field=amount, nth=99)",
)
CL_SETS = 64
CL_IMPORT = 4096
CL_CLIENTS = 8


class _ClOracle:
    """Path 16a's numpy oracle over the generator's (year, brand) of
    every column, in the shape the checks compare: counts, (key, count)
    pairs, (year, brand key, count) groups."""

    def __init__(self, year_of, brand_of, names, bid):
        self.year_of, self.brand_of = year_of, brand_of
        self.names, self.bid = names, bid

    def answers(self) -> dict:
        import numpy as np

        y, b, names = self.year_of, self.brand_of, self.names
        years, brands = 7, len(names)
        table = np.bincount(y * brands + b,
                            minlength=years * brands).reshape(years, brands)
        groups = sorted((yy, self.bid[bb], names[bb], int(table[yy, bb]))
                        for yy in range(years) for bb in range(brands)
                        if table[yy, bb])[:100]
        groups = [(yy, key, c) for yy, _, key, c in groups]
        counts = np.bincount(b, minlength=brands)
        top = sorted((-int(c), self.bid[bb], names[bb])
                     for bb, c in enumerate(counts) if c)[:10]
        top = [(key, -c) for c, _, key in top]
        q = CL_SSB_QUERIES
        return {q[0]: [int((y == 3).sum())],
                q[1]: [int(((y == 3) & (b == 7)).sum())],
                q[2]: [top], q[3]: [groups], q[4]: [groups, top]}


def _cl_held(node, index: str) -> list:
    """The shards whose data ``node`` holds (``Index.shards`` answers
    [0] for an index without data)."""
    idx = node.holder.index(index)
    return sorted(set().union(*[f.shards() for f in idx.fields.values()]))


def _cl_shape(res) -> list:
    """A PQL result list in the oracle's shape."""
    out = []
    for r in res:
        if isinstance(r, list):  # GroupBy
            out.append([(g.group[0].row_id, g.group[1].row_key, g.count)
                        for g in r])
        elif hasattr(r, "pairs"):  # TopN
            out.append([(p.key, p.count) for p in r.pairs])
        elif hasattr(r, "val"):
            out.append((r.val, r.count))
        else:
            out.append(r)
    return out


def _cl_ssb(c, lab, shards: int = 6) -> dict:
    """16a: config 3 through the coordinator, one shard's columns a
    call."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    co = c.coordinator
    rng = np.random.default_rng(3)  # bench_config3's generator
    years, brands = 7, 1000
    n = shards * SHARD_WIDTH
    year_of = rng.integers(0, years, n)
    brand_of = rng.integers(0, brands, n)
    names = np.array([f"MFGR#{1000 + b}" for b in range(brands)])
    cols = np.arange(n, dtype=np.int64)
    co.create_index("ssb")
    co.create_field("ssb", "year", {"type": "mutex"})
    co.create_field("ssb", "brand", {"type": "mutex", "keys": True})
    # the brand keys, created through the coordinator's translator in
    # sorted order: the ids path 1's bulk import gave them, so its
    # single-node answers compare as they are
    t0 = time.perf_counter()
    bid_of = co.executor.translator.field_keys(
        "ssb", "brand", names.tolist(), create=True)
    keys_s = time.perf_counter() - t0
    bid = {b: bid_of[names[b]] for b in range(brands)}
    t0 = time.perf_counter()
    secs = []
    for s in range(shards):
        sl = slice(s * SHARD_WIDTH, (s + 1) * SHARD_WIDTH)
        ts = time.perf_counter()
        co.import_bits("ssb", "year", rows=year_of[sl], cols=cols[sl])
        co.import_bits("ssb", "brand", cols=cols[sl],
                       row_keys=names[brand_of[sl]])
        secs.append(round(time.perf_counter() - ts, 3))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    held = {node.node.id: _cl_held(node, "ssb") for node in c.nodes}
    assert sum(1 for h in held.values() if h) >= 2, \
        f"the shards are not spread: {held}"
    assert sorted(s for h in held.values() for s in h) == \
        list(range(shards)), held
    keys = {node.node.id: len(node.holder.index("ssb").field("brand")
                              .translate.key_to_id) for node in c.nodes}
    primary = co.snapshot().partition_nodes(0)[0].id
    assert keys[primary] == brands and \
        sum(keys.values()) == brands, keys
    print(f"cluster 16a: the {brands:,} brand keys created through the "
          f"coordinator's translator in {keys_s:.3f} s; config 3 ({n:,} "
          f"columns, seed 3) through co.import_bits, a shard a call (year, "
          f"then brand by key, which looks the keys up), in {load_s:.3f} s "
          f"(per shard {secs}); shards per node {held}; "
          f"brand keys each node's primaries created {keys} (the field "
          f"keys' primary is {primary}) {lab}")
    oracle = _ClOracle(year_of, brand_of, names, bid)
    return {"oracle": oracle, "keys_s": keys_s, "load_s": load_s,
            "held": held, "keys": keys, "n": n}


def _cl_check_ssb(c, oracle, single=None) -> None:
    """Every 16a query from every node against the oracle (and path 1's
    single-node answers, when given)."""
    want = oracle.answers()
    for node in c.nodes:
        for q in CL_SSB_QUERIES:
            got = node.query("ssb", q)
            assert _cl_shape(got) == want[q], f"{q} on {node.node.id}"
            if single is not None:
                assert got == single[q], \
                    f"{q} on {node.node.id} differs from path 1's answer"


def _cl_clients(c, index, queries) -> int:
    """CL_CLIENTS threads ask ``queries`` of every node at once; each
    answer must equal the serial one. Returns the requests made."""
    from concurrent.futures import ThreadPoolExecutor

    work = [(k % len(c.nodes), q) for k, q in
            enumerate(list(queries) * len(c.nodes))]
    serial = [c[n].query(index, q) for n, q in work]

    def client(k):
        return [c[n].query(index, q) for n, q in work[k::CL_CLIENTS]]

    with ThreadPoolExecutor(max_workers=CL_CLIENTS) as pool:
        got = list(pool.map(client, range(CL_CLIENTS)))
    for k in range(CL_CLIENTS):
        assert got[k] == serial[k::CL_CLIENTS], \
            f"a concurrent answer differs from the serial one (client {k})"
    return len(work)


def _cl_bsi(c, lab, shards: int = FE_C2_SHARDS) -> dict:
    """16b: config 2's amount through co.import_values, a shard a call;
    the BSI queries against numpy, with the fan-outs each Percentile
    took."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    co = c.coordinator
    amount = np.random.default_rng(2).integers(0, 1 << 20,
                                               shards * SHARD_WIDTH)
    co.create_index("b")
    co.create_field("b", "amount", {"type": "int"})
    t0 = time.perf_counter()
    for s in range(shards):
        lo = s * SHARD_WIDTH
        co.import_values("b", "amount",
                         cols=np.arange(lo, lo + SHARD_WIDTH),
                         values=amount[lo:lo + SHARD_WIDTH])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    big = amount[amount > CL_HALF]
    lo_v, hi_v = int(amount.min()), int(amount.max())
    ordered = np.sort(amount)
    q = CL_BSI_QUERIES
    want = {q[0]: [big.size], q[1]: [(int(big.sum()), big.size)],
            q[2]: [(lo_v, int((amount == lo_v).sum()))],
            q[3]: [(hi_v, int((amount == hi_v).sum()))],
            q[4]: [_percentile_oracle(ordered, 50)],
            q[5]: [_percentile_oracle(ordered, 99)]}
    fans = {}
    ex = co.executor
    real = ex._fan_shards

    def counted(*a, **kw):
        fans[cur] = fans.get(cur, 0) + 1
        return real(*a, **kw)

    ex._fan_shards = counted
    try:
        for cur in q:
            got = co.query("b", cur)
            assert _cl_shape(got) == want[cur], f"{cur} disagrees: {got}"
    finally:
        del ex._fan_shards
    for node in c.nodes:
        assert node.query("b", q[0]) == want[q[0]], node.node.id
    held = {node.node.id: len(_cl_held(node, "b")) for node in c.nodes}
    print(f"cluster 16b: config 2's amount ({shards} x 2^20 values, seed "
          f"2) through co.import_values, a shard a call, in {load_s:.3f} s; "
          f"shards per node {held}; Count, Sum, Min, Max and Percentile "
          f"nth=50 and 99 equal numpy; fan-outs per query {fans} {lab}")
    return {"load_s": load_s, "fanouts": fans}


def _cl_writes(c, ssb, lab) -> dict:
    """16c: 64 Sets and one 4,096-bit import through node 1, read back
    from node 2 on the resident stacks."""
    import numpy as np

    from pilosa_tpu_torch.ops import kernel_util as KU

    o = ssb["oracle"]
    rng = np.random.default_rng(16)
    before = KU.launches()
    n = ssb["n"]
    set_cols = rng.choice(n, CL_SETS, replace=False)
    set_rows = rng.integers(0, 7, CL_SETS)
    for col, row in zip(set_cols.tolist(), set_rows.tolist()):
        assert c[1].query("ssb", f"Set({col}, year={row})") == \
            [bool(o.year_of[col] != row)]
        o.year_of[col] = row
    imp_cols = np.sort(rng.choice(n, CL_IMPORT, replace=False))
    imp_rows = rng.integers(0, 7, CL_IMPORT)
    c[1].import_bits("ssb", "year", rows=imp_rows, cols=imp_cols)
    o.year_of[imp_cols] = imp_rows
    _cl_check_ssb(c, o)  # from every node, node2 included
    after = KU.launches()
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v - before.get(k, 0)}
    assert delta.get("scatter_merge", 0) > 0, \
        f"the owners launched no scatter_merge: {delta}"
    print(f"cluster 16c: {CL_SETS} Sets and one {CL_IMPORT:,}-bit import "
          "through node1, read back from every node (node2 among them), "
          "equal to the oracle with the writes applied; launches "
          f"{delta} {lab}")
    return {"imp": (imp_rows, imp_cols), "launches": delta}


def _cl_legs(prof) -> tuple:
    """(cluster.leg ms, rpc.post_internal_query ms) of a profile tree."""
    legs, rpcs = [], []

    def walk(sp):
        if sp.get("name") == "cluster.leg":
            legs.append(sp["duration_ns"] / 1e6)
        elif sp.get("name") == "rpc.post_internal_query":
            rpcs.append(sp["duration_ns"] / 1e6)
        for ch in sp.get("children", ()):
            walk(ch)

    walk(prof)
    return [round(x, 3) for x in legs], [round(x, 3) for x in rpcs]


def _cl_syncs(fn) -> tuple:
    """(the host waits for copies back, the implicit syncs) inside
    ``fn``, counted over every node and thread of the process: each
    leg's executor waits once on its copies (``_wait_copies``, an event
    wait, which the sync debug mode does not report)."""
    from pilosa_tpu_torch.pql import executor as EX

    waits = [0]
    wait0 = EX._wait_copies

    def wait(ev):
        if ev is not None:
            waits[0] += 1
        return wait0(ev)

    EX._wait_copies = wait
    try:
        _, syncs = _implicit_syncs(fn)
    finally:
        EX._wait_copies = wait0
    return waits[0], syncs


def _cl_leg_split(c, pql) -> dict:
    """One remote GroupBy leg taken apart on the host, each step alone
    and serially: the serving node's execute and wire encoding, the
    response's JSON bytes, the coordinator's decode, and the whole leg
    over loopback HTTP; then the coordinator's merge of both legs."""
    import json as _json

    from pilosa_tpu_torch.pql import result as R
    from pilosa_tpu_torch.pql.parser import parse

    co = c.coordinator
    out = {}
    parts = []
    for node in c.nodes[1:]:
        shards = _cl_held(node, "ssb")
        t0 = time.perf_counter()
        wire = node.query_remote("ssb", pql, shards)
        serve_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        body = _json.dumps({"results": wire}).encode()
        encode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = _json.loads(body)["results"]
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        part = R.result_from_wire(back[0])
        from_wire_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        co.client.query_node(node.node, "ssb", pql, shards)
        leg_ms = (time.perf_counter() - t0) * 1e3
        parts.append(part)
        out[node.node.id] = {
            "groups": len(part), "bytes": len(body),
            "serve_ms": round(serve_ms, 3), "encode_ms": round(encode_ms, 3),
            "decode_ms": round(decode_ms, 3),
            "from_wire_ms": round(from_wire_ms, 3),
            "http_leg_ms": round(leg_ms, 3)}
    call = parse(pql).calls[0]
    t0 = time.perf_counter()
    co.executor._reduce(co.holder.index("ssb"), call, parts)
    out["merge_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    return out


def _cl_figures(c, report, lab) -> dict:
    """16e: warm p50s from the coordinator, the RPCs and syncs of each
    query, the profiled GroupBy's legs beside its wall time, and one
    GroupBy leg taken apart."""
    co = c.coordinator
    out = {"p50_ms": {}, "rpcs": {}, "syncs": {}}
    for index, qs in (("ssb", CL_SSB_QUERIES), ("b", CL_BSI_QUERIES)):
        legs = sum(1 for node in c.nodes if _cl_held(node, index))
        for q in qs:
            reps = 5 if q.startswith(("Percentile", "GroupBy")) else 11
            out["p50_ms"][q] = round(statistics.median(
                _wall_ms(lambda: co.query(index, q)) for _ in range(reps)),
                3)
            before = dict(co.client.op_counts)
            waits, syncs = _cl_syncs(lambda: co.query(index, q))
            out["rpcs"][q] = {k: v - before.get(k, 0)
                              for k, v in co.client.op_counts.items()
                              if v - before.get(k, 0)}
            out["syncs"][q] = {"waits": waits, "implicit": len(syncs),
                               "per_leg": round((waits + len(syncs))
                                                / legs, 2),
                               "sites": sorted(set(syncs))}
    gb = CL_SSB_QUERIES[3]
    t0 = time.perf_counter()
    prof = co.query_json("ssb", gb, profile=True)["profile"]
    wall = (time.perf_counter() - t0) * 1e3
    legs_ms, rpc_ms = _cl_legs(prof)
    assert legs_ms and rpc_ms, "the profile holds no remote leg"
    out["profile"] = {"wall_ms": round(wall, 3),
                      "root_ms": round(prof["duration_ns"] / 1e6, 3),
                      "cluster.leg": legs_ms,
                      "rpc.post_internal_query": rpc_ms}
    out["leg_split"] = _cl_leg_split(c, gb)
    single = report.notes.get("ssb_p50_ms")
    for q in CL_SSB_QUERIES + CL_BSI_QUERIES:
        print(f"cluster 16e: {q}: warm p50 {out['p50_ms'][q]} ms from the "
              f"coordinator, RPCs {out['rpcs'][q]}, host waits and implicit "
              f"syncs over all legs {out['syncs'][q]} {lab}")
    print(f"cluster 16e: the profiled {gb}: wall {wall:.3f} ms, root span "
          f"{out['profile']['root_ms']} ms, cluster.leg spans {legs_ms} ms, "
          f"rpc.post_internal_query spans {rpc_ms} ms {lab}")
    print(f"cluster 16e: one {gb} leg at a time, split on the host "
          f"{out['leg_split']} {lab}")
    print(f"cluster 16e: path 1's single-node p50 of "
          f"{CL_SSB_QUERIES[4]} "
          f"{single if single is None else round(single, 3)} ms against "
          f"the cluster's {out['p50_ms'][CL_SSB_QUERIES[4]]} ms {lab}")
    return out


def _cl_kernels(report, c, ssb, writes, lab) -> None:
    """16f: the kernels against their plain versions on the nodes' own
    planes, at the shapes the cluster's legs launch them."""
    import torch

    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    node = next(n for n in c.nodes if _cl_held(n, "ssb"))
    idx = node.holder.index("ssb")
    shards = _cl_held(node, "ssb")
    year = STK.stacked_set(idx.field("year"), shards, "standard")
    brand = STK.stacked_set(idx.field("brand"), shards, "standard")
    b1007 = ssb["oracle"].bid[7]
    leaves = [year.row_plane(3), brand.row_plane(b1007)]
    tape = (("and", 0, 1),)
    got = B.tape_count(tape, leaves)
    report.err("tape_count", got, B.tape_count_plain(tape, leaves))
    # the node's GroupBy leg: its year block against each brand block
    n_pair = 0
    for _, a_blk in year.iter_blocks():
        for _, b_blk in brand.iter_blocks():
            report.err("pair_counts", G.masked_pair_counts(a_blk, b_blk,
                                                           None),
                       G.pair_counts_plain(a_blk, b_blk))
            n_pair += 1
    bnode = next(n for n in c.nodes if _cl_held(n, "b"))
    amount = STK.stacked_bsi(bnode.holder.index("b").field("amount"),
                             _cl_held(bnode, "b"))
    report.err("bsi_compare", S.bsi_compare(amount.planes, S.GT, CL_HALF),
               S.bsi_compare_plain(amount.planes, S.GT, CL_HALF))
    # 16c's import batch on one owner: its bits cleared in a copy of
    # their tiles and set anew
    imp_rows, imp_cols = writes["imp"]
    snap = c.coordinator.snapshot()
    shard = next(s for s in shards
                 if snap.shard_nodes("ssb", s)[0].id == node.node.id
                 and ((imp_cols // SHARD_WIDTH) == s).any())
    sel = (imp_cols // SHARD_WIDTH) == shard
    new_bits = _scatter_check(report, idx.field("year").fragment(shard),
                              imp_rows[sel], imp_cols[sel] - shard *
                              SHARD_WIDTH, node.device)
    assert new_bits == int(sel.sum()), new_bits
    torch.cuda.synchronize()
    print(f"cluster 16f: on {node.node.id}'s planes (shards {shards}) "
          f"tape_count (year=3 AND brand=MFGR#1007: {int(got)}), "
          f"pair_counts (its year block against its {brand.n_blocks} brand "
          f"blocks, {n_pair} launches), bsi_compare (amount > {CL_HALF} "
          f"on {bnode.node.id}'s stack), scatter_merge (16c's "
          f"{int(sel.sum())} bits of shard {shard}) equal their plain "
          f"versions bit for bit {lab}")


def _scatter_check(report, frag, rows, pos, device) -> int:
    """``scatter_merge`` against its plain version on ``frag``'s packed
    tiles: the bits of (``rows``, ``pos``) cleared in a copy of their
    tiles and set anew by each; returns the new bits counted."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import scatter as SC

    slots = np.array([frag.row_index[int(r)] for r in rows])
    addr, masks_np = SC.sort_updates(slots, pos, frag.planes.shape[1])
    t = SC._tile_words(frag.planes.size)
    which, packed, _ = SC.pack_tiles(addr, t)
    tiles = frag.planes.reshape(-1, t)[which].reshape(-1)
    tiles[packed] &= ~masks_np
    flat = torch.from_numpy(tiles.view(np.int32)).to(device)
    addr_t = torch.from_numpy(packed.astype(np.int32)).to(device)
    masks_t = torch.from_numpy(masks_np.view(np.int32)).to(device)
    ours, plain = flat.clone(), flat.clone()
    new_bits = SC.scatter_merge_plain(plain, addr_t, masks_t)
    report.err("scatter_merge", SC.scatter_merge_(ours, addr_t, masks_t),
               new_bits)
    report.err("scatter_merge", ours, plain)
    return int(new_bits)


def _fo_reads(node, want) -> None:
    """16d's reads from ``node``: each row's Count and ``TopN(f, n=3)``
    against numpy's ``bincount`` ``want``."""
    for r in range(len(want)):
        assert node.query("fo", f"Count(Row(f={r}))") == [int(want[r])], \
            f"Count(Row(f={r})) on {node.node.id}"
    top = sorted(((-int(v), r) for r, v in enumerate(want)))[:3]
    got = node.query("fo", "TopN(f, n=3)")[0]
    assert [(p.id, p.count) for p in got.pairs] == \
        [(r, -v) for v, r in top], "TopN disagrees"


def _cl_failover(lab, device, shards: int = 4, keep: bool = False) -> dict:
    """16d: a 3-node cluster with 2 replicas over 4 shards; a paused node
    leaves it DEGRADED: reads through the replicas, writes refused, then
    NORMAL again. The nodes' clients share an unarmed ``FaultPlan``;
    with ``keep`` the cluster stays open for path 17c and comes back as
    ``"cluster"`` with the plan, the column rows and the bincount."""
    import numpy as np

    from pilosa_tpu_torch.cluster import (ClusterStateError, FaultPlan,
                                          LocalCluster, STATE_DEGRADED,
                                          STATE_NORMAL)
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rows = 7
    rng = np.random.default_rng(4)
    f_of = rng.integers(0, rows, shards * SHARD_WIDTH)
    plan = FaultPlan(seed=4)  # unarmed: path 17c arms it
    c = LocalCluster(3, replica_n=2, fault_plan=plan, device=device)
    kept = False
    try:
        co = c.coordinator
        co.create_index("fo")
        co.create_field("fo", "f", {"type": "mutex"})
        t0 = time.perf_counter()
        for s in range(shards):
            sl = slice(s * SHARD_WIDTH, (s + 1) * SHARD_WIDTH)
            co.import_bits("fo", "f", rows=f_of[sl],
                           cols=np.arange(sl.start, sl.stop))
        load_s = time.perf_counter() - t0
        want = np.bincount(f_of, minlength=rows)

        def reads(node):
            _fo_reads(node, want)

        reads(co)
        c.pause(1)
        assert co.state() == STATE_DEGRADED, co.state()
        reads(co)
        reads(c[2])
        try:
            co.query("fo", "Set(5, f=1)")
        except ClusterStateError:
            pass
        else:
            raise AssertionError("a write was accepted while DEGRADED")
        c.unpause(1)
        assert co.state() == STATE_NORMAL, co.state()
        assert co.query("fo", "Set(5, f=1)") == [bool(f_of[5] != 1)]
        want[f_of[5]] -= 1
        want[1] += 1
        f_of[5] = 1
        for node in c.nodes:
            reads(node)
        kept = keep
    finally:
        if not kept:
            c.close()
    print(f"cluster 16d: 3 nodes, 2 replicas, {shards} x 2^20 columns "
          f"loaded in {load_s:.3f} s; node1 paused: DEGRADED, Counts and "
          "TopN equal numpy through the replicas, a write refused "
          "(ClusterStateError); unpaused: NORMAL, the write accepted and "
          f"read back from every node {lab}")
    out = {"load_s": load_s}
    if keep:
        out["cluster"] = {"c": c, "plan": plan, "f_of": f_of, "want": want}
    return out


def phase_cluster(report: Report, device: str = "cuda:0",
                  shards: tuple = (6, FE_C2_SHARDS, 4),
                  keep_16d: bool = False) -> dict:
    """Path 16: the cluster core. Three nodes in this process on the card
    load bench.py configs 3 and 2 through the coordinator (16a, 16b),
    take routed writes (16c), answer with a node paused (16d); figures
    (16e) and the kernels on the nodes' planes (16f). ``device`` and the
    shards of configs 3, 2 and 16d's index are the card's and the
    configs' own; a dry run on the CPU passes ``"cpu"`` and fewer. With
    ``keep_16d`` 16d's cluster stays open for path 17 (``"16d_cluster"``
    of the result, which the caller closes)."""
    import gc

    import torch

    from pilosa_tpu_torch.cluster import LocalCluster
    from pilosa_tpu_torch.ops import kernel_util as KU

    lab = report.label
    t_phase = time.perf_counter()
    out = {}
    KU.reset_launches()
    c = LocalCluster(3, replica_n=1, device=device)
    try:
        assert all(n.device == torch.device(device) for n in c.nodes)
        ssb = _cl_ssb(c, lab, shards[0])
        _cl_check_ssb(c, ssb["oracle"], report.notes.get("ssb_single"))
        out["16a"] = {k: ssb[k]
                      for k in ("keys_s", "load_s", "held", "keys")}
        # the Counts, the TopN and one GroupBy
        out["16a"]["clients"] = _cl_clients(c, "ssb", CL_SSB_QUERIES[:4])
        print("cluster 16a: every query from every node equals numpy and "
              f"path 1's single-node answers; {CL_CLIENTS} concurrent "
              f"clients ({out['16a']['clients']} requests) equal the serial "
              f"answers {lab}")
        out["16b"] = _cl_bsi(c, lab, shards[1])
        writes = _cl_writes(c, ssb, lab)
        out["16c"] = writes["launches"]
        torch.cuda.synchronize()
        launched = KU.launches()
        report.launched("cluster 16", launched,
                        ("tape_count", "pair_counts", "scatter_merge",
                         "bsi_compare"))
        out["launches"] = launched
        print(f"cluster 16: launches on the path (16a-16c) {launched}; "
              f"ctile_count {launched.get('ctile_count', 0)} {lab}")
        out["16e"] = _cl_figures(c, report, lab)
        _cl_kernels(report, c, ssb, writes, lab)
    finally:
        c.close()
        del c
        gc.collect()
        torch.cuda.empty_cache()
    out["16d"] = _cl_failover(lab, device, shards[2], keep=keep_16d)
    kept = out["16d"].pop("cluster", None)
    out["seconds"] = time.perf_counter() - t_phase
    print("cluster 16: " + json.dumps(out, default=str))
    if kept is not None:
        out["16d_cluster"] = kept
    return out


# ---------------------------------------------------------------------------
# Path 17: fan-out resilience and leg batching (bench.py configs 9 and 14,
# a straggler, a breaker and a batched wave on 16d's full-width cluster)
# ---------------------------------------------------------------------------

C9_PER_SHARD = 50_000  # bench.py config 9 (bench.py:614-695)
C14_PER_SHARD = 40_000  # bench.py config 14 (bench.py:1085-1200)
C9_ITERS = 20  # bench.py: max(QUERY_ITERS, 5)
C14_WAVES = 3
C14_QUERIES = 64
#: 17c's breaker: open on the first failure, for long enough to read
#: through the veto, sample every timeline and ask for the cluster stats
C17_OPEN_MS = 2000.0
C17_WAVE = 64


def _barrier_wave(node, index, batch):
    """Every (pql, shards, want) of ``batch`` from its own thread,
    released at once through a barrier as bench.py config 14 runs them;
    each answer must equal its ``want``. Per-query seconds."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    barrier = threading.Barrier(len(batch))

    def one(entry):
        pql, subset, want = entry
        barrier.wait()
        t0 = time.perf_counter()
        r = node.query(index, pql, shards=subset)
        dt = time.perf_counter() - t0
        assert r == [want], f"{pql} over {subset}: {r} != [{want}]"
        return dt

    with ThreadPoolExecutor(max_workers=len(batch)) as pool:
        return list(pool.map(one, batch))


def _phase_print(tag, lab, path="resilience", **figs) -> None:
    print(f"{path} {tag}: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in figs.items()) + f" {lab}")


def _res_config9(report, device, lab) -> dict:
    """17a: bench.py config 9 as ``bench_config9`` builds it: a 3-node,
    2-replica cluster under ``FaultPlan(seed=9)``, 6 shards x 50,000
    records of an 8-row set field from seed 9, ``Count(Row(f=3))`` 20
    times healthy, 20 unhedged under a delay of one owner, 20 warm with
    resilience on and 20 hedged under the same delay; every answer equal
    to the no-fault answer and to numpy; at least one hedge won. The
    owner's fragment of the last shard holds ``scatter_merge`` against
    its plain version."""
    import numpy as np

    from pilosa_tpu_torch.cluster import FaultPlan, LocalCluster
    from pilosa_tpu_torch.obs.metrics import MetricsRegistry
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(9)
    plan = FaultPlan(seed=9)
    c = LocalCluster(3, replica_n=2, fault_plan=plan, device=device)
    try:
        co = c.coordinator
        co.create_index("c9")
        co.create_field("c9", "f")
        f_all = []
        t0 = time.perf_counter()
        for shard in range(6):
            rows = rng.integers(0, 8, C9_PER_SHARD)
            cols = shard * SHARD_WIDTH + np.arange(C9_PER_SHARD)
            co.import_bits("c9", "f", rows=rows.tolist(), cols=cols.tolist())
            f_all.append(rows)
        load_s = time.perf_counter() - t0
        q = "Count(Row(f=3))"
        want = co.query("c9", q)
        assert want == [int(np.bincount(np.concatenate(f_all),
                                        minlength=8)[3])], want
        victim = next(n.node.id for n in c.nodes[1:]
                      if n.holder.index("c9").shards())

        def timed():
            r, s = _synced_s(lambda: co.query("c9", q))
            assert r == want, (r, want)
            return s

        healthy = [timed() for _ in range(C9_ITERS)]
        delay_s = min(max(10 * statistics.median(healthy), 0.25), 2.0)
        plan.delay(victim, delay_s)
        unhedged = [timed() for _ in range(C9_ITERS)]
        plan.clear()
        reg = MetricsRegistry()
        co.enable_resilience(registry=reg, hedge_min_ms=1.0,
                             breaker_threshold=1 << 30)
        warm = [timed() for _ in range(C9_ITERS)]
        plan.delay(victim, delay_s)
        hedged = [timed() for _ in range(C9_ITERS)]
        plan.clear()
        co.disable_resilience()
        hedges = _counters(reg, "cluster_hedges_total")
        wins = _counters(reg, "cluster_hedge_wins_total")
        assert wins >= 1, f"no hedge won under the straggler ({hedges})"
        owner = next(n for n in c.nodes if 5 in _cl_held(n, "c9"))
        frag = owner.holder.index("c9").field("f").fragment(5)
        with _uncounted():
            new_bits = _scatter_check(report, frag, f_all[5],
                                      np.arange(C9_PER_SHARD), owner.device)
        assert new_bits == C9_PER_SHARD, new_bits
    finally:
        c.close()
    out = {"load_s": load_s, "delay_s": delay_s, "hedges": hedges,
           "wins": wins, "victim": victim, "owner": owner.node.id}
    for name, lat in (("healthy", healthy), ("unhedged", unhedged),
                      ("warm", warm), ("hedged", hedged)):
        out[f"{name}_p50_ms"] = _pct_ms(lat, 0.5)
        out[f"{name}_p99_ms"] = _pct_ms(lat, 0.99)
    _phase_print("17a", lab, **out)
    print(f"resilience 17a: config 9: 6 x {C9_PER_SHARD} records; "
          f"{4 * C9_ITERS} reads equal the no-fault answer {want} and "
          f"numpy; {victim} delayed {delay_s:.3f} s; {hedges:.0f} hedges, "
          f"{wins:.0f} won; scatter_merge equals its plain version on "
          f"{out['owner']}'s shard-5 planes {lab}")
    return out


def _batch_tape_check(report, node, index, queries, counts, lab) -> dict:
    """On a serving node, one batch of config 14's queries (their shards
    cut to the ones ``node`` holds) through ``query_remote_batch``: every
    slot equals numpy, and every ``tape_count`` launch of the batch
    equals its plain version on the same stacked planes and
    ``ShardMask`` plane."""
    held = set(_cl_held(node, index))
    entries, want = [], []
    for pql, subset, _ in queries:
        mine = [s for s in subset if s in held]
        if mine:
            row = int(pql.split("=")[1].rstrip(")"))
            entries.append({"index": index, "query": pql, "shards": mine})
            want.append(int(sum(counts[s][row] for s in mine)))
    entries, want = entries[:32], want[:32]
    got = []
    n = _tapped(report, lambda: got.extend(node.query_remote_batch(entries)))
    assert [g["results"][0]["data"] for g in got] == want, (got, want)
    print(f"resilience 17b: a {len(entries)}-query batch served by "
          f"{node.node.id} (shards {sorted(held)}): every slot equals "
          f"numpy; {n['tape_count']} tape_count launches for the batch, "
          f"{n['masked']} under a ShardMask, each equal to its plain "
          f"version {lab}")
    return {"batch": len(entries), "launches": n["tape_count"],
            "masked": n["masked"]}


def _res_config14(report, device, lab) -> dict:
    """17b: bench.py config 14 as ``bench_config14`` builds it: 64
    mixed-shard Counts over 6 shards x 40,000 records, released through a
    barrier, 3 waves unbatched, then 3 batched; every answer equal to the
    bincount oracle, the batched pass at least 8x fewer node RPCs and
    none on ``/internal/query``; then the chaos wave (every batch RPC to
    one owner delayed 0.3 s, hedging on); then a batch on a serving node
    against the plain ``tape_count``."""
    import numpy as np

    from pilosa_tpu_torch.cluster import FaultPlan, LocalCluster
    from pilosa_tpu_torch.obs.metrics import MetricsRegistry
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(14)
    plan = FaultPlan(seed=14)  # unarmed until the chaos wave
    c = LocalCluster(3, replica_n=2, fault_plan=plan, device=device)
    try:
        co = c.coordinator
        co.create_index("c14")
        co.create_field("c14", "f")
        counts = []
        t0 = time.perf_counter()
        for shard in range(6):
            rows = rng.integers(0, 8, C14_PER_SHARD)
            cols = shard * SHARD_WIDTH + np.arange(C14_PER_SHARD)
            co.import_bits("c14", "f", rows=rows.tolist(),
                           cols=cols.tolist())
            counts.append(np.bincount(rows, minlength=8))
        load_s = time.perf_counter() - t0
        queries = []
        for i in range(C14_QUERIES):
            row = i % 8
            subset = sorted(int(s) for s in rng.choice(
                6, size=int(rng.integers(2, 6)), replace=False))
            queries.append((f"Count(Row(f={row}))", subset,
                            int(sum(counts[s][row] for s in subset))))
        co.query("c14", queries[0][0], shards=queries[0][1])
        sent0 = dict(co.client.op_counts)
        unbatched = []
        for _ in range(C14_WAVES):
            unbatched += _barrier_wave(co, "c14", queries)
        solo = co.client.op_counts.get("query", 0) - sent0.get("query", 0)
        co.enable_cluster_batch()
        sent0 = dict(co.client.op_counts)
        batched = []
        for _ in range(C14_WAVES):
            batched += _barrier_wave(co, "c14", queries)
        rpcs = co.client.op_counts.get("query_batch", 0) - \
            sent0.get("query_batch", 0)
        assert co.client.op_counts.get("query", 0) == \
            sent0.get("query", 0), \
            "batched pass leaked legs onto the solo /internal/query RPC"
        cut = solo / max(rpcs, 1)
        assert rpcs > 0 and cut >= 8.0, \
            f"coalescer only cut node RPCs {cut:.1f}x ({solo} vs {rpcs})"
        reg = MetricsRegistry()
        co.enable_resilience(registry=reg, hedge_min_ms=30.0,
                             timeout_min_ms=5000.0,
                             breaker_threshold=1 << 30)
        for _ in range(2):
            _barrier_wave(co, "c14", queries[:16])
        victim = next(n.node.id for n in c.nodes[1:]
                      if n.holder.index("c14").shards())
        plan.delay(victim, 0.3, op="query_batch")
        chaos = _barrier_wave(co, "c14", queries[:16])
        plan.clear()
        co.disable_resilience()
        co.disable_cluster_batch()
        hedges = _counters(reg, "cluster_hedges_total")
        with _uncounted():
            check = _batch_tape_check(report, c.nodes[int(victim[-1])],
                                      "c14", queries, counts, lab)
    finally:
        c.close()
    out = {"load_s": load_s, "solo_rpcs": solo, "batch_rpcs": rpcs,
           "rpc_cut": cut, "hedges": hedges, "victim": victim,
           "unbatched_p50_ms": _pct_ms(unbatched, 0.5),
           "unbatched_p99_ms": _pct_ms(unbatched, 0.99),
           "batched_p50_ms": _pct_ms(batched, 0.5),
           "batched_p99_ms": _pct_ms(batched, 0.99),
           "chaos_p50_ms": _pct_ms(chaos, 0.5),
           "chaos_p99_ms": _pct_ms(chaos, 0.99), "batch_check": check}
    _phase_print("17b", lab, **{k: v for k, v in out.items()
                                if k != "batch_check"})
    print(f"resilience 17b: config 14: {C14_WAVES} waves of "
          f"{C14_QUERIES} mixed-shard Counts unbatched and batched equal "
          f"the bincount oracle; node RPCs {solo} -> {rpcs} ({cut:.1f}x, "
          f"bench.py's 8x bar met), none batched on /internal/query; the "
          f"chaos wave ({victim}'s batches delayed 0.3 s, {hedges:.0f} "
          f"hedges) equals the oracle {lab}")
    return out


def _remote_primary(co, index: str) -> str:
    """A node other than ``co`` that is the first owner of some shard of
    ``index`` in the coordinator's assignment: its legs are primaries."""
    ex = co.executor
    by_node = ex._assign(ex._snapshot_fn(), index,
                         sorted(ex._shards_fn(index)), set())
    return next(nid for nid in sorted(by_node) if nid != ex.node_id)


def _res_straggler(c, plan, want, lab) -> dict:
    """17c.1: one owner of 16d's cluster delayed; with hedging on, the
    Counts and the TopN equal numpy and hedges win."""
    from pilosa_tpu_torch.obs.metrics import MetricsRegistry

    co = c.coordinator
    victim = _remote_primary(co, "fo")
    reg = MetricsRegistry()
    co.enable_resilience(registry=reg, hedge_min_ms=1.0,
                         breaker_threshold=1 << 30)
    try:
        healthy = [_synced_s(lambda: _fo_reads(co, want))[1]
                   for _ in range(3)]
        delay_s = min(max(10 * statistics.median(healthy) / 8, 0.25), 2.0)
        plan.delay(victim, delay_s)
        straggled = [_synced_s(lambda: _fo_reads(co, want))[1]
                     for _ in range(3)]
    finally:
        plan.clear()
        co.disable_resilience()
    hedges = _counters(reg, "cluster_hedges_total")
    wins = _counters(reg, "cluster_hedge_wins_total")
    assert hedges >= 1 and wins >= 1, (hedges, wins)
    out = {"victim": victim, "delay_s": delay_s, "hedges": hedges,
           "wins": wins, "healthy_reads_s": statistics.median(healthy),
           "straggled_reads_s": statistics.median(straggled)}
    _phase_print("17c straggler", lab, **out)
    return out


def _res_breaker(c, plan, want, lab) -> dict:
    """17c.2: ``plan.drop`` of one owner: the reads fail over and the
    breaker opens; with membership up again, the reads are vetoed to the
    replicas with no RPC to the node; the coordinator's flight recorder
    holds the breaker events and one ``breaker_open`` bundle, and ``GET
    /internal/stats/cluster`` returns every node's window; after
    ``plan.clear()`` and ``breaker_open_ms`` one half-open probe closes
    the breaker and marks the node up."""
    import urllib.request

    from pilosa_tpu_torch.cluster.resilience import (
        BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN)

    co = c.coordinator
    victim = _remote_primary(co, "fo")
    ups, transitions = [], []
    mark_up = co._mark_up
    co._mark_up = lambda nid: (ups.append(nid), mark_up(nid))
    planes = [n.enable_health() for n in c.nodes]
    res = co.enable_resilience(
        hedge=False, breaker_threshold=1, breaker_open_ms=C17_OPEN_MS,
        on_breaker_transition=lambda n, f, t: transitions.append((n, f, t)))
    try:
        _fo_reads(co, want)  # fault-free
        plan.drop(victim, first=plan.seen(victim))
        _fo_reads(co, want)  # the failing leg fails over to the replicas
        t_open = time.monotonic()  # the breaker opened before this
        assert res.breaker.state(victim) == BREAKER_OPEN
        # the server never died: membership sees it again, and only the
        # breaker keeps the reads away from it
        c.disco.up(victim)
        seen = plan.seen(victim)
        _fo_reads(co, want)
        assert plan.seen(victim) == seen, "a vetoed node got an RPC"
        for p in planes:
            p.timeline.sample()
        bundles = [b for b in co.health.flight.bundles()
                   if b["trigger"] == "breaker_open"]
        assert len(bundles) == 1, co.health.flight.summaries()
        events = [e for e in co.health.flight.events()
                  if e["kind"] == "breaker" and e["node"] == victim]
        assert [e["to"] for e in events] == [BREAKER_OPEN], events
        with urllib.request.urlopen(
                co.node.uri + "/internal/stats/cluster?window=60",
                timeout=30) as r:
            stats = json.loads(r.read())
        assert sorted(stats["nodes"]) == sorted(n.node.id for n in c.nodes)
        assert stats["nodes"][victim] == {"enabled": False,
                                          "error": "breaker open"}
        live = [n for n, w in stats["nodes"].items() if w.get("samples")]
        assert len(live) == 2, stats["nodes"].keys()
        plan.clear()
        time.sleep(max(0.0, C17_OPEN_MS / 1e3 - (time.monotonic() - t_open))
                   + 0.05)
        _fo_reads(co, want)  # the half-open probe closes the breaker
        assert res.breaker.state(victim) == BREAKER_CLOSED
        assert [(f, t) for n, f, t in transitions if n == victim] == [
            (BREAKER_CLOSED, BREAKER_OPEN), (BREAKER_OPEN, BREAKER_HALF_OPEN),
            (BREAKER_HALF_OPEN, BREAKER_CLOSED)], transitions
        assert ups == [victim], ups
    finally:
        plan.clear()
        del co._mark_up
        co.disable_resilience()
        for n in c.nodes:
            n.disable_health()
    out = {"victim": victim, "vetoed_rpcs": 0,
           "bundle": bundles[0]["reason"],
           "stats_nodes_reporting": stats["cluster"]["nodes_reporting"],
           "transitions": [f"{f}->{t}" for n, f, t in transitions
                           if n == victim]}
    print(f"resilience 17c breaker: {victim} dropped: reads fail over, "
          f"breaker {' , '.join(out['transitions'])}; while open the reads "
          f"equal numpy with no RPC to {victim}; flight recorder: "
          f"{len(events)} breaker event, one breaker_open bundle "
          f"({out['bundle']!r}); /internal/stats/cluster: "
          f"{sorted(stats['nodes'])}, {victim} 'breaker open', "
          f"{out['stats_nodes_reporting']} nodes reporting; _mark_up ran "
          f"for {ups} {lab}")
    return out


def _res_batched_wave(c, f_of, lab) -> dict:
    """17c.3: a 64-way batched wave of mixed-shard Counts over 16d's
    4 x 2^20 columns, each equal to numpy."""
    import numpy as np

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    co = c.coordinator
    rng = np.random.default_rng(17)
    shards = len(f_of) // SHARD_WIDTH
    per = [np.bincount(f_of[s * SHARD_WIDTH:(s + 1) * SHARD_WIDTH],
                       minlength=7) for s in range(shards)]
    batch = []
    for i in range(C17_WAVE):
        row = i % 7
        subset = sorted(int(s) for s in rng.choice(
            shards, size=int(rng.integers(2, shards)), replace=False))
        batch.append((f"Count(Row(f={row}))", subset,
                      int(sum(per[s][row] for s in subset))))
    co.enable_cluster_batch()
    try:
        sent0 = dict(co.client.op_counts)
        lat = _barrier_wave(co, "fo", batch)
        rpcs = {k: v - sent0.get(k, 0) for k, v in co.client.op_counts.items()
                if v - sent0.get(k, 0)}
    finally:
        co.disable_cluster_batch()
    assert rpcs.get("query", 0) == 0, rpcs
    out = {"queries": C17_WAVE, "rpcs": rpcs, "p50_ms": _pct_ms(lat, 0.5),
           "p99_ms": _pct_ms(lat, 0.99)}
    _phase_print("17c batched wave", lab, **out)
    return out


def _res_full_width(report, kept, lab) -> dict:
    """17c: 16d's cluster (3 nodes, 2 replicas, 4 x 2^20 columns of a
    7-row mutex ``f``) under a straggler, an open breaker and a batched
    wave; ``pair_counts`` (the TopN's row counts) against its plain
    version on a node's ``f`` block."""
    import torch

    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops.bitmap import device_ones

    c, plan, want = kept["c"], kept["plan"], kept["want"]
    out = {"straggler": _res_straggler(c, plan, want, lab),
           "breaker": _res_breaker(c, plan, want, lab),
           "batched": _res_batched_wave(c, kept["f_of"], lab)}
    node = next(n for n in c.nodes[1:] if _cl_held(n, "fo"))
    st = STK.stacked_set(node.holder.index("fo").field("f"),
                         _cl_held(node, "fo"), "standard")
    n_blk = 0
    with _uncounted():
        for _, blk in st.iter_blocks():
            if isinstance(blk, torch.Tensor):
                ones = device_ones(blk.shape[-1], blk.device).reshape(1, -1)
                report.err("pair_counts", G.pair_counts(ones, blk),
                           G.pair_counts_plain(ones, blk))
                n_blk += 1
    print(f"resilience 17c: pair_counts (the TopN's row counts) equals "
          f"its plain version on {node.node.id}'s {n_blk} f block(s) {lab}")
    return out


def phase_resilience(report: Report, kept: dict,
                     device: str = "cuda:0") -> dict:
    """Path 17: fan-out resilience and leg batching. (17c) 16d's
    full-width cluster, handed over open by path 16, under a straggler,
    an open breaker and a 64-way batched wave, then closed; (17a)
    bench.py config 9; (17b) bench.py config 14. ``device`` is the
    card's; a dry run on the CPU passes ``"cpu"``."""
    import gc

    import torch

    from pilosa_tpu_torch.ops import kernel_util as KU

    lab = report.label
    t_phase = time.perf_counter()
    out = {}
    torch.cuda.synchronize()
    KU.reset_launches()
    _UNCOUNTED.clear()
    try:
        t0 = time.perf_counter()
        out["17c"] = _res_full_width(report, kept, lab)
        out["17c"]["seconds"] = time.perf_counter() - t0
    finally:
        kept["c"].close()
        kept.clear()
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["17a"] = _res_config9(report, device, lab)
    out["17a"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["17b"] = _res_config14(report, device, lab)
    out["17b"]["seconds"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = {k: v - _UNCOUNTED.get(k, 0) for k, v in KU.launches().items()}
    report.launched("resilience 17", launched,
                    ("tape_count", "scatter_merge"))
    out["launches"] = launched
    out["seconds"] = time.perf_counter() - t_phase
    print(f"resilience 17: launches on the path {launched}; steps "
          + ", ".join(f"{k} {out[k]['seconds']:.2f} s"
                      for k in ("17c", "17a", "17b"))
          + f"; {out['seconds']:.2f} s {lab}")
    print("resilience 17: " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------------------
# Path 18: gossip, SWIM membership and replica catch-up (bench.py config 10
# and a lagging replica at 16d's width)
# ---------------------------------------------------------------------------

C10_PER_SHARD = 20_000  # bench.py config 10 (bench.py:712-786)
C10_TRIALS = 8
C10_TTL_MS = 300.0
C10_INTERVAL_MS = 10.0
C10_BAIL_S = 5.0
#: 18b: 16d's width (4 x 2^20 columns, a 7-row mutex field), from seed 18
C18_SHARDS = 4
C18_ROWS = 7
#: the row changes node 2 misses while it is away, and those that land
#: at its peer after the peer's snapshot (they reach node 2 in the tail)
C18_LAG = 100_000
C18_LATE = 4096
C18_WAIT_S = 15.0
C18_ITERS = 21


def _gossip_counters(reg) -> dict:
    return {k: _counters(reg, k) for k in (
        "gossip_rounds_total", "gossip_deltas_sent_total",
        "gossip_deltas_applied_total", "gossip_piggybacks_total")}


def _gossip_config10(device, lab) -> dict:
    """18a: bench.py config 10 as ``bench_config10`` builds it: a 2-node
    cluster, 4 shards x 20,000 records of an 8-row field from seed 10;
    ``Count(Row(f=3))`` of a remote shard cached on the coordinator, the
    owner written directly, the coordinator polled until it reads the
    write. 8 trials with a TTL-only leg cache (300 ms), then 8 with
    gossip-keyed caching at ``ttl_ms=0`` (10 ms rounds on their threads,
    3 rounds to converge first). Every read is at least the count before
    the trial's write, a window ends at the count after it; the gossip
    p50 is below the TTL p50 and no window hits the 5 s bail."""
    import numpy as np

    from pilosa_tpu_torch.cluster import LocalCluster
    from pilosa_tpu_torch.obs.metrics import MetricsRegistry
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(10)
    reg = MetricsRegistry()
    c = LocalCluster(2, device=device)
    try:
        co = c.coordinator
        co.create_index("c10")
        co.create_field("c10", "f")
        f_all = []
        for shard in range(4):
            rows = rng.integers(0, 8, C10_PER_SHARD)
            cols = shard * SHARD_WIDTH + np.arange(C10_PER_SHARD)
            co.import_bits("c10", "f", rows=rows.tolist(),
                           cols=cols.tolist())
            f_all.append(rows)
        owner = next(n for n in c.nodes[1:]
                     if n.holder.index("c10").shards())
        shard = sorted(owner.holder.index("c10").shards())[0]
        q = "Count(Row(f=3))"
        start = int(np.bincount(np.concatenate(f_all), minlength=8)[3])
        assert co.query("c10", q) == [start]
        next_col = [shard * SHARD_WIDTH + C10_PER_SHARD]
        reads = [0]

        def stale_window() -> float:
            want = co.query("c10", q)[0] + 1
            col, next_col[0] = next_col[0], next_col[0] + 1
            owner.api.import_bits("c10", "f", rows=[3], cols=[col])
            owner._announce_shards("c10")
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < C10_BAIL_S:
                got = co.query("c10", q)[0]
                reads[0] += 1
                assert got >= want - 1, (got, want)
                if got >= want:
                    assert got == want, (got, want)
                    return time.perf_counter() - t0
                time.sleep(0.002)
            return C10_BAIL_S

        co.enable_cache(ttl_ms=C10_TTL_MS, registry=MetricsRegistry())
        ttl = [stale_window() for _ in range(C10_TRIALS)]
        co.disable_cache()
        c.enable_gossip(interval_ms=C10_INTERVAL_MS, start=True,
                        registry=reg)
        c.run_gossip_rounds(3)
        co.enable_cache(ttl_ms=0, registry=MetricsRegistry())
        gossip = [stale_window() for _ in range(C10_TRIALS)]
        final = co.query("c10", q)[0]
    finally:
        c.close()
    assert final == start + 2 * C10_TRIALS, (final, start)
    out = {"ttl_p50_ms": _pct_ms(ttl, 0.5), "ttl_p99_ms": _pct_ms(ttl, 0.99),
           "gossip_p50_ms": _pct_ms(gossip, 0.5),
           "gossip_p99_ms": _pct_ms(gossip, 0.99), "reads": reads[0],
           "owner": owner.node.id, "shard": shard, **_gossip_counters(reg)}
    assert max(gossip) < C10_BAIL_S, gossip
    assert out["gossip_p50_ms"] < out["ttl_p50_ms"], out
    _phase_print("18a", lab, "gossip", **out)
    print(f"gossip 18a: config 10: 4 x {C10_PER_SHARD} records; "
          f"{2 * C10_TRIALS} writes on {owner.node.id} (shard {shard}), "
          f"{reads[0]} polled reads, none below the count before its "
          f"write; stale window p50 {out['gossip_p50_ms']:.3f} ms with "
          f"gossip against {out['ttl_p50_ms']:.3f} ms with a "
          f"{C10_TTL_MS:.0f} ms TTL {lab}")
    return out


def _rc_reads(node, want) -> None:
    """18b's reads from ``node``: each row's Count and ``TopN(f)``
    against numpy's bincount ``want``."""
    for r in range(len(want)):
        assert node.query("rc", f"Count(Row(f={r}))") == [int(want[r])], \
            f"Count(Row(f={r})) on {node.node.id}"
    got = node.query("rc", "TopN(f)")[0]
    top = sorted((-int(v), r) for r, v in enumerate(want) if v)
    assert [(p.id, p.count) for p in got.pairs] == \
        [(r, -v) for v, r in top], f"TopN on {node.node.id}"


def _wait_s(pred, what: str, reads=None) -> float:
    """Seconds until ``pred()`` holds (``reads()`` between polls)."""
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < C18_WAIT_S, f"{what} never held"
        if reads is not None:
            reads()
        time.sleep(0.01)
    return time.perf_counter() - t0


def _tapped(report, fn) -> dict:
    """Run ``fn`` with every ``tape_count``, ``pair_counts``,
    ``ctile_count``, ``scatter_merge`` and ``bsi_compare`` launch held
    against its plain version on the same inputs; returns each kernel's
    launches, and ``masked``, the ``tape_count`` launches under a
    ``ShardMask`` plane. ``scatter_merge`` works in place: its tiles are
    copied before the launch, and the plain version runs on the copy at
    once (the staging tiles are reused by the next launch)."""
    import torch

    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import scatter as SC
    from pilosa_tpu_torch.pql import executor as EX

    calls = {"tape_count": [], "pair_counts": [], "ctile_count": [],
             "scatter_merge": [], "bsi_compare": []}
    orig_t, orig_p, orig_c = B.tape_count, G.pair_counts, C.ctile_count_blocks
    orig_s, orig_b = SC.scatter_merge_, S.bsi_compare

    def tap_t(tape, leaves, mask=None):
        out = orig_t(tape, leaves, mask)
        calls["tape_count"].append(((tape, list(leaves), mask), out))
        return out

    def tap_p(a, b):
        out = orig_p(a, b)
        calls["pair_counts"].append(((a, b), out))
        return out

    def tap_c(blocks, filt=None, out=None, offsets=None):
        # the counts land in ``out`` at ``offsets``: keep what it held
        before = out.clone() if out is not None else None
        got = orig_c(blocks, filt, out, offsets)
        calls["ctile_count"].append(((list(blocks), filt, before, offsets),
                                     got.clone()))
        return got

    def tap_s(flat, addr, masks, out=None):
        # held at once: the staging tiles are reused by the next launch
        before = flat.clone()
        got = orig_s(flat, addr, masks, out=out)
        with _uncounted():
            count = SC.scatter_merge_plain(before, addr, masks)
            report.err("scatter_merge",
                       torch.cat([got.reshape(1), flat.reshape(-1)]),
                       torch.cat([count.reshape(1), before.reshape(-1)]))
        calls["scatter_merge"].append(None)
        return got

    def tap_b(planes, op, value, value2=None):
        out = orig_b(planes, op, value, value2)
        calls["bsi_compare"].append(((planes, op, value, value2), out))
        return out

    # the executor and the BSI ops call pair_counts by the name they
    # imported: tap it there too
    sites = [(B, "tape_count", tap_t), (C, "ctile_count_blocks", tap_c),
             (SC, "scatter_merge_", tap_s), (S, "bsi_compare", tap_b)] + [
        (mod, "pair_counts", tap_p) for mod in (G, EX, S)
        if getattr(mod, "pair_counts", None) is orig_p]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, tap in sites:
        setattr(mod, name, tap)
    try:
        fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)

    plain = {"tape_count": B.tape_count_plain,
             "pair_counts": G.pair_counts_plain,
             "ctile_count": C.ctile_count_blocks_plain,
             "bsi_compare": S.bsi_compare_plain}
    with _uncounted():
        for name, fn_plain in plain.items():
            for args, out in calls[name]:
                report.err(name, out, fn_plain(*args))
    n = {name: len(got) for name, got in calls.items()}
    n["masked"] = sum(1 for args, _ in calls["tape_count"]
                      if args[2] is not None)
    return n


def _gossip_lagging(report, device, base, lab) -> dict:
    """18b: a 3-node, 2-replica cluster with a data directory a node,
    index ``rc`` with a 7-row mutex field over 4 x 2^20 columns drawn as
    16d draws it (seed 18); gossip (its defaults, on threads), membership
    (its defaults), resilience and the health plane on every node, the
    nodes' clients without retries (the chaos drives' client). Node 2
    is paused and falls silent: the time until the coordinator's
    ``live_ids`` drops it, reads equal numpy throughout, the
    coordinator's breaker for node 2 reaches node 1 as a prewarm. Node
    2's shards then change on their other owners; node 2 comes back (the
    time until it is alive again at the coordinator), ``lagging`` names
    each of its shards, and ``catch_up`` repairs them, while writes land
    at the peer after its snapshot (they arrive in the WAL tail). Node
    2's planes equal its peer's; its reads and the coordinator's equal
    numpy; its breaker was gossiped open, then closed; a second
    catch-up is empty. The cluster stays open for 18c."""
    import base64

    import numpy as np

    from pilosa_tpu_torch.cluster import InternalClient, LocalCluster
    from pilosa_tpu_torch.obs import metrics as M
    from pilosa_tpu_torch.obs.metrics import MetricsRegistry
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.storage.store import export_shard_arrays

    rng = np.random.default_rng(18)
    f_of = rng.integers(0, C18_ROWS, C18_SHARDS * SHARD_WIDTH)
    greg = MetricsRegistry()
    regs = [MetricsRegistry() for _ in range(3)]
    c = LocalCluster(3, replica_n=2, base_path=base, device=device,
                     client_factory=lambda i: InternalClient(retries=0))
    out = {}
    try:
        co, n2 = c.coordinator, c[2]
        co.create_index("rc")
        co.create_field("rc", "f", {"type": "mutex"})
        t0 = time.perf_counter()
        for s in range(C18_SHARDS):
            sl = slice(s * SHARD_WIDTH, (s + 1) * SHARD_WIDTH)
            co.import_bits("rc", "f", rows=f_of[sl],
                           cols=np.arange(sl.start, sl.stop))
        out["load_s"] = time.perf_counter() - t0
        snap = co.snapshot()
        mine = [s for s in range(C18_SHARDS)
                if "node2" in [n.id for n in snap.shard_nodes("rc", s)]]
        assert mine, "placement put no shard of rc on node2"
        c.enable_gossip(start=True, registry=greg)
        c.enable_membership()
        for i, node in enumerate(c.nodes):
            node.enable_resilience(registry=regs[i])
            node.enable_health()
        want = np.bincount(f_of, minlength=C18_ROWS)
        _wait_s(lambda: all(len(n.gossip.state.digest()) == 3
                            for n in c.nodes), "gossip convergence")
        _rc_reads(co, want)

        # node 2 stops: its listener closes and it sends nothing more
        t_pause = time.perf_counter()
        c.pause(2)
        n2.gossip.stop()
        _rc_reads(co, want)  # its legs fail over; its breaker opens
        k = [0]

        def poll_read():
            r = k[0] % C18_ROWS
            k[0] += 1
            assert co.query("rc", f"Count(Row(f={r}))") == [int(want[r])]

        _wait_s(lambda: "node2" not in co.disco.live_ids(),
                "node2 confirmed", poll_read)
        out["detect_s"] = time.perf_counter() - t_pause
        out["breaker"] = co.resilience.breaker.state("node2")
        _wait_s(lambda: regs[1].value(M.METRIC_GOSSIP_BREAKER_PREWARMS,
                                      node="node2") >= 1,
                "node1's prewarm")
        out["prewarms"] = regs[1].value(M.METRIC_GOSSIP_BREAKER_PREWARMS,
                                        node="node2")
        out["timeout_s"] = co.membership.suspect_timeout_s(3)

        # node 2's shards change on their other owners while it is away
        def write_peers(cols, rows):
            for s in mine:
                sel = cols // SHARD_WIDTH == s
                for n in snap.shard_nodes("rc", s):
                    if n.id != "node2":
                        c[int(n.id[4:])].api.import_bits(
                            "rc", "f", rows=rows[sel], cols=cols[sel])
            f_of[cols] = rows

        lag = np.concatenate([rng.choice(SHARD_WIDTH, C18_LAG // len(mine),
                                         replace=False) + s * SHARD_WIDTH
                              for s in mine])
        write_peers(lag, rng.integers(0, C18_ROWS, lag.size))
        for n in c.nodes[:2]:
            n._announce_shards("rc")
        want = np.bincount(f_of, minlength=C18_ROWS)
        _rc_reads(co, want)

        t0 = time.perf_counter()
        c.unpause(2)
        n2.gossip.start()
        out["rejoin_s"] = _wait_s(
            lambda: (co.membership.status_of("node2") == "alive"
                     and "node2" in co.disco.live_ids()), "node2 rejoined")
        out["incarnation"] = n2.membership.incarnation
        probe = co.health.timeline.sample()["probes"]["membership"]
        out["probe"] = probe
        assert probe["enabled"] and probe["down"] == 0, probe

        rm = n2.enable_recovery()
        _wait_s(lambda: sorted(set().union(*rm.lagging("rc").values()))
                == mine, "node2's lag seen")
        out["lagging"] = {o: sorted(s) for o, s in rm.lagging("rc").items()}
        states = []
        record = n2.gossip.record_breaker
        n2.gossip.record_breaker = \
            lambda t, st: (states.append((t, st)), record(t, st))[1]
        late = np.concatenate([rng.choice(SHARD_WIDTH, C18_LATE // len(mine),
                                          replace=False) + s * SHARD_WIDTH
                               for s in mine])
        late_rows = rng.integers(0, C18_ROWS, late.size)
        fetch = n2.client.recovery_snapshot
        snap_bytes = [0]

        def snapshot_then_write(node, index, shard, token=None):
            got = fetch(node, index, shard, token=token)
            snap_bytes[0] += len(base64.b64decode(got.get("npz", "")))
            if "late" not in out:  # lands after the first snapshot
                t_w = time.perf_counter()
                write_peers(late, late_rows)
                out["late_write_ms"] = (time.perf_counter() - t_w) * 1e3
                out["late"] = int(late.size)
            return got

        replayed = {}
        replay = n2.holder.replay_records

        def counted_replay(idx, recs):
            before = KU.launches()
            n = replay(idx, recs)
            for k_, v in KU.launches().items():
                replayed[k_] = replayed.get(k_, 0) + v - before.get(k_, 0)
            replayed["records"] = replayed.get("records", 0) + n
            return n

        n2.client.recovery_snapshot = snapshot_then_write
        n2.holder.replay_records = counted_replay
        try:
            summary = rm.catch_up("rc")
        finally:
            n2.client.recovery_snapshot = fetch
            del n2.holder.replay_records
            n2.gossip.record_breaker = record
        summary["snapshot_bytes"] = snap_bytes[0]
        summary["replayed"] = replayed
        out["catch_up"] = summary
        assert summary["shards"] == len(mine) and summary["records"] > 0, \
            summary
        assert replayed.get("scatter_merge", 0) >= 1, replayed
        assert states == [("node2", "open"), ("node2", "closed")], states
        want = np.bincount(f_of, minlength=C18_ROWS)
        for s in mine:
            peer = next(n for n in snap.shard_nodes("rc", s)
                        if n.id != "node2")
            a = export_shard_arrays(n2.holder.index("rc"), s)
            b = export_shard_arrays(
                c[int(peer.id[4:])].holder.index("rc"), s)
            assert sorted(a) == sorted(b), (s, sorted(a), sorted(b))
            for key in a:
                assert np.array_equal(a[key], b[key]), (s, key)
        out["read_launches"] = _tapped(report, lambda: _rc_reads(n2, want))
        assert out["read_launches"]["pair_counts"] >= 1, out["read_launches"]
        _rc_reads(co, want)
        again = rm.catch_up("rc")
        assert again["shards"] == 0, again
        frag = n2.holder.index("rc").field("_exists").fragment(mine[0])
        pos = late[late // SHARD_WIDTH == mine[0]] % SHARD_WIDTH
        with _uncounted():
            _scatter_check(report, frag, np.zeros(pos.size, np.int64), pos,
                           n2.device)
    except BaseException:
        c.close()
        raise
    _phase_print("18b", lab, "gossip", load_s=out["load_s"],
                 detect_s=out["detect_s"], timeout_s=out["timeout_s"],
                 rejoin_s=out["rejoin_s"], prewarms=out["prewarms"],
                 incarnation=out["incarnation"])
    s = out["catch_up"]
    print(f"gossip 18b: node2 (shards {mine}) paused and silent: dropped "
          f"from the coordinator's live_ids after {out['detect_s']:.3f} s "
          f"(suspect timeout {out['timeout_s']:.3f} s), the coordinator's "
          f"breaker {out['breaker']}, {out['prewarms']:.0f} prewarm(s) on "
          f"node1; {C18_LAG} row changes on its peers; back alive after "
          f"{out['rejoin_s']:.3f} s at incarnation {out['incarnation']}; "
          f"membership probe {out['probe']}; lagging {out['lagging']}; "
          f"catch-up: {s['shards']} shard(s), {s['records']} records, "
          f"{s['bytes']} tail bytes, {s['snapshot_bytes']} snapshot bytes, "
          f"{s['queued']} queued, {s['lag_ms']:.3f} ms (of which "
          f"{out['late_write_ms']:.3f} ms is the script's own write of "
          f"{out['late']} changes at the peer); replay launches "
          f"{s['replayed']}; planes equal the peer's, reads equal numpy "
          f"from node2 and the coordinator "
          f"({out['read_launches']['tape_count']} tape_count and "
          f"{out['read_launches']['pair_counts']} pair_counts launches on "
          f"node2's reads, all nodes, equal their plain versions), "
          f"breaker gossiped open then closed, a second catch-up empty; "
          f"scatter_merge equals its plain version on the replayed "
          f"_exists tiles {lab}")
    out["cluster"] = c
    return out


def _gossip_cost(c, greg, lab) -> dict:
    """18c: on 18b's cluster, the coordinator's ``Count(Row(f=3))`` p50
    with the gossip envelope on its requests and with it off
    (``piggyback=False``), in turns; the envelope's JSON bytes a
    request; the anti-entropy round's ms (``gossip_round_ms``: the
    bucket that holds the median and the mean); the coordinator's
    entries and known origins."""
    co = c.coordinator
    agent = co.gossip
    sizes = []
    wrap = co.client._piggyback

    def measured(node, payload):
        out = wrap(node, payload)
        if "gossip" in out:
            sizes.append(len(json.dumps(out["gossip"])))
        return out

    co.client._piggyback = measured
    lat = {"on": [], "off": []}
    try:
        for turn in ("on", "off", "off", "on"):
            co.client.gossip = agent if turn == "on" else None
            for _ in range(C18_ITERS):
                lat[turn].append(_synced_s(
                    lambda: co.query("rc", "Count(Row(f=3))"))[1])
    finally:
        co.client.gossip = agent
        co.client._piggyback = wrap
    h = greg.histogram("gossip_round_ms")
    acc, p50_le = 0, None
    for le, n in sorted(h["buckets"].items()):
        acc += n
        if p50_le is None and acc * 2 >= h["count"]:
            p50_le = le
    out = {"on_p50_ms": _pct_ms(lat["on"], 0.5),
           "off_p50_ms": _pct_ms(lat["off"], 0.5),
           "envelope_bytes": statistics.mean(sizes) if sizes else 0.0,
           "requests": len(sizes), "round_p50_le_ms": p50_le,
           "round_mean_ms": h["sum"] / max(1, h["count"]),
           "rounds": h["count"], "entries": len(agent.state),
           "origins": len(agent.state.digest())}
    _phase_print("18c", lab, "gossip", **out)
    return out


def phase_gossip(report: Report, device: str = "cuda:0") -> dict:
    """Path 18: gossip, SWIM membership and replica catch-up. (18a)
    bench.py config 10; (18b) a lagging replica at 16d's width; (18c)
    what gossip costs on 18b's cluster. ``device`` is the card's; a dry
    run on the CPU passes ``"cpu"``."""
    import gc
    import shutil

    import torch

    from pilosa_tpu_torch.ops import kernel_util as KU

    lab = report.label
    t_phase = time.perf_counter()
    base = os.path.abspath(os.path.join("build", "chip_smoke_gossip"))
    shutil.rmtree(base, ignore_errors=True)
    out = {}
    torch.cuda.synchronize()
    KU.reset_launches()
    _UNCOUNTED.clear()
    try:
        t0 = time.perf_counter()
        out["18a"] = _gossip_config10(device, lab)
        out["18a"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lagging = _gossip_lagging(report, device, base, lab)
        c = lagging.pop("cluster")
        try:
            out["18b"] = lagging
            out["18b"]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["18c"] = _gossip_cost(c, c.coordinator.gossip.registry, lab)
            out["18c"]["seconds"] = time.perf_counter() - t0
        finally:
            c.close()
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(base, ignore_errors=True)
    torch.cuda.synchronize()
    launched = {k: v - _UNCOUNTED.get(k, 0) for k, v in KU.launches().items()}
    report.launched("gossip 18", launched, ("tape_count", "scatter_merge"))
    out["launches"] = launched
    out["seconds"] = time.perf_counter() - t_phase
    print(f"gossip 18: launches on the path {launched}; steps "
          + ", ".join(f"{k} {out[k]['seconds']:.2f} s"
                      for k in ("18a", "18b", "18c"))
          + f"; {out['seconds']:.2f} s {lab}")
    print("gossip 18: " + json.dumps(out, default=str))
    return out


MT_N = 400_000  # bench.py config 18 (bench.py:1539-1745)
MT_ITERS = 40  # bench.py: max(10, QUERY_ITERS * 2)
MT_SUITE = ("GroupBy(Rows(city), Rows(device), limit=100)",
            "Count(Intersect(Row(city=7), Row(device=3)))",
            "TopN(city, n=5)")
MT_WB = ("alpha", "bravo", "charlie")
#: config 18's host-speed bar: a well-behaved tenant's p99 under the
#: abuser against its p99 without it
MT_P99_BAR = 1.5
SOAK_N = 200_000  # bench.py config 22 (bench.py:2353-2830)
SOAK_STANDING_S = 6.0
SOAK_RAMP = ((0.7, 2.0), (1.3, 2.0), (2.4, 2.5))
#: config 22's host-speed bar: saturated interactive good-put against
#: the standing soak's
SOAK_GOODPUT_BAR = 0.5


def _http(uri, path, data=None, tenant=None, ctype=None):
    """One request to ``uri``: (status, JSON body, headers)."""
    import urllib.error
    import urllib.request

    r = urllib.request.Request(uri + path, data=data)
    if tenant is not None:
        r.add_header("X-Tenant", tenant)
    if ctype is not None:
        r.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _mt_numpy(city, dev) -> list:
    """Config 18's suite as numpy answers it, in the shape ``_mt_shape``
    gives the JSON results."""
    import numpy as np

    pairs = np.zeros((50, 8), dtype=np.int64)
    np.add.at(pairs, (city, dev), 1)
    groups = [((int(a), int(b)), int(pairs[a, b]))
              for a in range(50) for b in range(8) if pairs[a, b]][:100]
    counts = np.bincount(city, minlength=50)
    top = sorted(range(50), key=lambda r: (-counts[r], r))[:5]
    return [groups, int(((city == 7) & (dev == 3)).sum()),
            [(r, int(counts[r])) for r in top]]


def _mt_shape(results) -> list:
    gb, cnt, top = results
    return [[((e["group"][0]["rowID"], e["group"][1]["rowID"]), e["count"])
             for e in gb[0]], cnt[0],
            [(p["id"], p["count"]) for p in top[0]["rows"]]]


def _tenant_seconds(reg) -> dict:
    return {t: row["device_seconds"]
            for t, row in reg.stats_json()["tenants"].items()}


def _tenants_config18(report, device, base, lab) -> dict:
    """19a: bench.py config 18 as ``bench_config18`` builds it: a 3-node,
    2-replica cluster (a data directory a node) under ``FaultPlan(seed=
    18)``'s 2 ms delays at probability 0.2 on node1 / node2 queries;
    400,000 records of ``city`` (50 rows) and ``device`` (8 rows), seed
    18; the three-query suite over HTTP with ``X-Tenant``, 40 timed runs
    a query. Off: the oracle (numpy's counts too), no tenant scope
    entered. On (tenants, health, schedulers; ``mallory`` capped at 5 qps
    and 400 rows/s): each well-behaved tenant's baseline p99. Abuser:
    two threads of ``mallory`` imports, erroring queries and reads on
    another index while the tenants re-run; the devprof tables on for
    this window. Hard asserts as bench.py makes them; the 1.5x p99 bar
    printed met / missed."""
    import threading
    import urllib.request

    import numpy as np

    from pilosa_tpu_torch.cluster import LocalCluster
    from pilosa_tpu_torch.cluster.resilience import FaultPlan
    from pilosa_tpu_torch.obs import devprof
    from pilosa_tpu_torch.obs import tenants as tenants_mod

    rng = np.random.default_rng(18)
    city = rng.integers(0, 50, MT_N)
    dev = rng.integers(0, 8, MT_N)
    plan = (FaultPlan(seed=18)
            .delay("node1", 0.002, prob=0.2, op="query")
            .delay("node2", 0.002, prob=0.2, op="query"))
    out = {}
    with LocalCluster(3, replica_n=2, base_path=os.path.join(base, "c18"),
                      fault_plan=plan, device=device) as c:
        co = c.coordinator
        uri = co.node.uri

        def run_suite(tenant):
            results, times = [], []
            for q in MT_SUITE:
                st, body, _ = _http(uri, "/index/mt/query", q.encode(),
                                    tenant)  # warm
                assert st == 200, body
                for _ in range(MT_ITERS):
                    t0 = time.perf_counter()
                    st, body, _ = _http(uri, "/index/mt/query", q.encode(),
                                        tenant)
                    times.append(time.perf_counter() - t0)
                    assert st == 200, body
                results.append(body["results"])
            return results, float(np.percentile(times, 99)) * 1e3

        t0 = time.perf_counter()
        co.create_index("mt")
        co.create_field("mt", "city", {"type": "set"})
        co.create_field("mt", "device", {"type": "set"})
        cols = list(range(MT_N))
        co.import_bits("mt", "city", rows=city.tolist(), cols=cols)
        co.import_bits("mt", "device", rows=dev.tolist(), cols=cols)
        out["load_s"] = time.perf_counter() - t0

        scope0 = tenants_mod.SCOPE_COUNT
        assert co.tenants is None
        oracle, out["off_p99_ms"] = run_suite(None)
        assert tenants_mod.SCOPE_COUNT == scope0, \
            "tenant context touched while the plane is disabled"
        assert _mt_shape(oracle) == _mt_numpy(city, dev), \
            "config 18's suite disagrees with numpy"

        regs = c.enable_tenants()
        c.enable_health()
        for node in c.nodes:
            node.enable_scheduler()
        regs[0].set_quota("mallory", qps=5.0, ingest_rows_s=400.0)
        baseline = {}
        for t in MT_WB:
            res, baseline[t] = run_suite(t)
            assert res == oracle, f"tenant {t} diverged with plane on"

        co.create_index("abuse")
        co.create_field("abuse", "f", {"type": "set"})
        stop = threading.Event()
        stats = {"attempts": 0, "rejected": 0, "retry_after": 0}
        imp = json.dumps({"field": "f", "rows": [1] * 200,
                          "cols": list(range(200))}).encode()

        def abuser():
            k = 0
            while not stop.is_set():
                k += 1
                if k % 4 == 0:
                    st, _, h = _http(uri, "/index/abuse/import", imp,
                                     "mallory", "application/json")
                elif k % 3 == 0:
                    st, _, h = _http(uri, "/index/abuse/query",
                                     b"Row(missing=1)", "mallory")
                else:
                    st, _, h = _http(uri, "/index/abuse/query", b"Row(f=1)",
                                     "mallory")
                stats["attempts"] += 1
                if st == 429:
                    stats["rejected"] += 1
                    if h.get("Retry-After"):
                        stats["retry_after"] += 1
                    time.sleep(0.02)
                else:
                    time.sleep(0.005)

        # the same window on both clocks: the tenants' device seconds and
        # devprof's device time from here to the end of the abuse
        before = _tenant_seconds(co.tenants)
        was = devprof.ENABLED
        devprof.enable()
        devprof.reset()
        threads = [threading.Thread(target=abuser, daemon=True)
                   for _ in range(2)]
        for th in threads:
            th.start()
        while stats["attempts"] < 50:
            time.sleep(0.005)
        busy = {}
        for t in MT_WB:
            res, busy[t] = run_suite(t)
            assert res == oracle, f"tenant {t} diverged under abuse"
        co.health.timeline.sample()
        stop.set()
        for th in threads:
            th.join(timeout=30)
        after = _tenant_seconds(co.tenants)
        kstats = devprof.stats_json()
        if not was:
            devprof.disable()
        prof_s = sum(k["device_seconds"] for k in kstats["kernels"]) \
            + kstats["other"]["device_seconds"]

        assert stats["rejected"] > 0, "abuser was never rejected"
        assert stats["retry_after"] > 0, "429s carried no Retry-After"
        burn = co.health.slo.tenant_burn_rates()
        alerting = {r["tenant"] for r in burn if r["alerting"]}
        assert "mallory" in alerting, f"abuser not burning (rows: {burn})"
        assert not (alerting & set(MT_WB)), \
            f"well-behaved tenant burning: {alerting}"
        st, tj, _ = _http(uri, "/internal/tenants")
        assert st == 200 and tj["enabled"]
        assert set(MT_WB) | {"mallory"} <= set(tj["tenants"]), \
            sorted(tj["tenants"])
        assert tj["tenants"]["mallory"]["rejected"] > 0
        with urllib.request.urlopen(uri + "/metrics", timeout=30) as resp:
            prom = resp.read().decode()
        assert "slo_burn_rate{" in prom and 'tenant="mallory"' in prom, \
            "per-tenant burn gauges missing from /metrics"
        bundles = co.health.flight.summaries()
        assert any(b["trigger"] == "tenant_burn" for b in bundles), \
            f"no tenant_burn flight bundle (got {bundles})"

        # the path's kernels against their plain versions at its shapes:
        # one run of the suite (tape_count, pair_counts) and the abuser's
        # 200-bit import on its owner's tiles (scatter_merge)
        def one_suite():
            for q in MT_SUITE:
                st, body, _ = _http(uri, "/index/mt/query", q.encode(),
                                    "alpha")
                assert st == 200, body

        out["checked"] = _tapped(report, one_suite)
        assert out["checked"]["tape_count"] >= 1, out["checked"]
        assert out["checked"]["pair_counts"] >= 1, out["checked"]
        owner = next(n for n in c.nodes if 0 in _cl_held(n, "abuse"))
        frag = owner.holder.index("abuse").field("f").fragment(0)
        with _uncounted():
            new_bits = _scatter_check(report, frag, np.ones(200, np.int64),
                                      np.arange(200), owner.device)
        assert new_bits == 200, new_bits

    bars = {t: {"baseline_p99_ms": baseline[t], "busy_p99_ms": busy[t],
                "bar_ms": MT_P99_BAR * baseline[t],
                "met": busy[t] <= MT_P99_BAR * baseline[t]} for t in MT_WB}
    dev_s = {t: after.get(t, 0.0) - before.get(t, 0.0)
             for t in (*MT_WB, "mallory")}
    out.update(bars=bars, abuser=stats, tenants_tracked=tj["tracked"],
               device_seconds=dev_s, devprof_device_s=prof_s,
               tenants_over_devprof=sum(dev_s.values()) / max(prof_s, 1e-12))
    for t in MT_WB:
        b = bars[t]
        print(f"tenants 19a: {t} p99 {b['busy_p99_ms']:.3f} ms under the "
              f"abuser, {b['baseline_p99_ms']:.3f} ms without it; bar "
              f"{MT_P99_BAR}x = {b['bar_ms']:.3f} ms: "
              f"{'met' if b['met'] else 'missed'} {lab}")
    print("tenants 19a: device seconds while the abuser ran, by tenant "
          + ", ".join(f"{t} {s:.6f}" for t, s in dev_s.items())
          + f" (sum {sum(dev_s.values()):.6f} s) beside devprof's device "
          f"time of the same window {prof_s:.6f} s "
          f"({kstats['other']['dispatches']} launches outside a family) "
          f"{lab}")
    _phase_print("19a", lab, "tenants", load_s=out["load_s"],
                 attempts=stats["attempts"], rejected=stats["rejected"],
                 retry_after=stats["retry_after"],
                 tracked=tj["tracked"], checked=out["checked"])
    return out


def _degrade_config22(report, device, base, lab) -> dict:
    """19b: bench.py config 22 as ``bench_config22`` builds it: a 3-node,
    2-replica cluster (a data directory a node) under ``FaultPlan(seed=
    22)`` with gossip, tenants, schedulers (``max_queue=32``, adaptive
    window), caches and the health plane (100 ms samples on a thread, a
    5 s fast window); 200,000 records of ``f`` (40 rows) and ``g`` (200
    rows) over columns below 2^22, seed 22; a stream index. Off is free;
    the concurrent capacity of 16 closed-loop probes; the ladder at
    bench.py's thresholds; a 6 s open-loop soak from 100,000 synthetic
    tenants under a ChaosSchedule (delay, drop, heal, pause and unpause
    of node 2); the write oracle; the 0.7x / 1.3x / 2.4x ramp; recovery;
    the bounded tables. Hard asserts as bench.py makes them; the 50%
    good-put bar printed met / missed."""
    import itertools
    import threading
    import urllib.request

    import numpy as np

    from pilosa_tpu_torch.cluster import LocalCluster
    from pilosa_tpu_torch.cluster.resilience import FaultPlan
    from pilosa_tpu_torch.loadgen import (
        ChaosSchedule, KIND_BULK_IMPORT, KIND_INTERACTIVE, KIND_SQL,
        OpenLoopDriver, ScenarioMix, SyntheticTenants,
    )
    from pilosa_tpu_torch.pql import executor as pqlx
    from pilosa_tpu_torch.pql import programs as progs
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    fault_seed = 22
    rng = np.random.default_rng(22)
    base_rows = rng.integers(0, 40, SOAK_N)
    base_cols = rng.integers(0, 1 << 22, SOAK_N)
    g_rows = rng.integers(0, 200, SOAK_N)
    plan = FaultPlan(seed=fault_seed)
    out = {}
    with LocalCluster(3, replica_n=2, base_path=os.path.join(base, "c22"),
                      fault_plan=plan, device=device) as c, \
            contextlib.ExitStack() as stops:
        co = c.coordinator
        uri = co.node.uri
        c.enable_gossip()
        c.enable_tenants()
        for node in c.nodes:
            node.enable_scheduler(max_queue=32, adaptive_window=True)
            node.enable_cache()
        c.enable_health(interval_ms=100, slo_fast_window_s=5.0, start=True)
        # the samplers' threads stop before the cluster closes
        stops.callback(lambda: [n.disable_health() for n in c.nodes])

        def req(path, data=None, tenant=None):
            return _http(uri, path, data, tenant)

        t0 = time.perf_counter()
        st, body, _ = req("/index/soak", b'{"options": {}}')
        assert st == 200, body
        for fname in ("f", "g"):
            st, body, _ = req(f"/index/soak/field/{fname}",
                              b'{"options": {"type": "set"}}')
            assert st == 200, body
        co.import_bits("soak", "f", rows=base_rows.tolist(),
                       cols=base_cols.tolist())
        co.import_bits("soak", "g", rows=g_rows.tolist(),
                       cols=base_cols.tolist())
        oracle = {r: set() for r in range(40)}
        for r, cc in zip(base_rows.tolist(), base_cols.tolist()):
            oracle[r].add(cc)
        st, _, _ = req("/index/streamidx", b'{"options": {}}')
        assert st == 200
        svc = co.api.enable_stream("streamidx", batch_rows=64,
                                   queue_depth=4, max_backlog_rows=2048)
        svc.start(0.02)
        stops.callback(co.api.disable_stream)
        out["load_s"] = time.perf_counter() - t0

        # ---- off is free ------------------------------------------------
        for i in range(10):
            st, body, _ = req("/index/soak/query",
                              f"Count(Row(f={i % 40}))".encode())
            assert st == 200, body
            want = len(oracle[i % 40])
            assert body["results"] == [want], (body, want)
        st, body, _ = req("/sql", b"SELECT COUNT(*) FROM soak")
        assert st == 200, body
        with urllib.request.urlopen(uri + "/metrics", timeout=30) as resp:
            metrics_text = resp.read().decode()
        assert "degrade_" not in metrics_text, \
            "degrade metrics moved while the plane was disabled"
        for node in c.nodes:
            assert node.cache.stats()["stale_serves"] == 0

        for a, b in ((1, 2), (3, 4)):
            req("/index/soak/query",
                f"Count(Intersect(Row(f={a}), Row(g={b})))".encode())
        req("/index/soak/query", b"Row(f=1)")

        t0 = time.perf_counter()
        cap_iters = 24
        for i in range(cap_iters):
            st, body, _ = req(
                "/index/soak/query",
                f"Count(Intersect(Row(f={i % 40}), "
                f"Row(g={100 + i})))".encode())
            assert st == 200, body
        qps_base = cap_iters / max(time.perf_counter() - t0, 1e-6)
        cap_out = {}

        def cap_worker(tid, stop_at):
            n = 0
            while time.perf_counter() < stop_at:
                st, _b, _h = req(
                    "/index/soak/query",
                    f"Count(Intersect(Row(f={n % 40}), "
                    f"Row(g={tid})))".encode())
                if st == 200:
                    n += 1
            cap_out[tid] = n

        stop_at = time.perf_counter() + 1.2
        cap_threads = [threading.Thread(target=cap_worker, args=(t, stop_at))
                       for t in range(16)]
        t0 = time.perf_counter()
        for th in cap_threads:
            th.start()
        for th in cap_threads:
            th.join()
        qps_conc = max(qps_base, sum(cap_out.values())
                       / max(time.perf_counter() - t0, 1e-6))
        print(f"degrade 19b: capacity {qps_base:.3f}/s sequential, "
              f"{sum(cap_out.values())} answers from 16 clients in 1.2 s; "
              f"the ramp scales off {qps_conc:.3f}/s {lab}")

        c.enable_degrade(
            queue_shed=0.30, queue_brownout=0.55, queue_saturate=0.80,
            burn_shed=60.0, burn_brownout=90.0, burn_saturate=130.0,
            miss_rate_brownout=1e9, eviction_rate_shed=1e9,
            exit_ratio=0.6, up_hold=1, down_hold=2, min_dwell_s=0.25)

        lock = threading.Lock()
        first_degrade_shed = {}
        missing_retry_after = [0]
        #: (kind, status, the error's first words) -> answers that were
        #: neither 200 nor 429
        failures = {}
        unacked = []
        acked_new = []

        def note_shed(body, headers):
            msg = str(body.get("error", ""))
            if "Retry-After" not in headers:
                with lock:
                    missing_retry_after[0] += 1
            if "degrade" in msg:
                pri = "batch" if "batch" in msg else "interactive"
                with lock:
                    first_degrade_shed.setdefault(pri, time.monotonic())

        def failed(kind, st, body):
            key = f"{kind} {st} {str(body.get('error', ''))[:60]}"
            with lock:
                failures[key] = failures.get(key, 0) + 1
            return "error"

        def answer(st, body, hdr, kind=KIND_INTERACTIVE):
            if st == 200:
                return {"outcome": "ok", "stale": bool(body.get("stale"))}
            if st == 429:
                note_shed(body, hdr)
                return "shed"
            return failed(kind, st, body)

        def execute(op):
            oid = op.op_id
            if op.kind == KIND_INTERACTIVE:
                return answer(*req("/index/soak/query",
                                   f"Count(Row(f={oid % 40}))".encode(),
                                   op.tenant))
            if op.kind == KIND_SQL:
                return answer(*req("/sql", b"SELECT COUNT(*) FROM soak",
                                   op.tenant), kind=KIND_SQL)
            if op.kind == KIND_BULK_IMPORT:
                row, col = oid % 40, 4_200_000 + oid
                payload = json.dumps({"field": "f", "rows": [row],
                                      "cols": [col]}).encode()
                st, body, hdr = req("/index/soak/import", payload, op.tenant)
                if st == 200:
                    with lock:
                        oracle[row].add(col)
                        acked_new.append((row, col))
                    return "ok"
                with lock:
                    unacked.append((row, col))
                if st == 429:
                    note_shed(body, hdr)
                    return "shed"
                return failed(op.kind, st, body)
            if op.kind == "stream_push":
                svc.push([{"id": 1000 + oid}])  # AdmissionError -> shed
                return "ok"
            st, body, hdr = req("/index/soak/query", b"Count(Row(f=0))",
                                f"t{(oid * 7919) % 100_000:07d}")
            if st == 429:
                note_shed(body, hdr)
                return "shed"
            return "ok" if st == 200 else "error"

        ramp_i = itertools.count()

        def execute_ramp(op):
            if op.kind == KIND_INTERACTIVE:
                i = next(ramp_i)
                if i % 3 == 0:
                    return answer(*req("/sql", b"SELECT COUNT(*) FROM soak",
                                       op.tenant), kind=KIND_SQL)
                a, b = i % 40, 25 + (i // 40) % 175
                return answer(*req(
                    "/index/soak/query",
                    f"Count(Intersect(Row(f={a}), Row(g={b})))".encode(),
                    op.tenant))
            return execute(op)

        poll_stop = threading.Event()
        poll_samples = []
        stale_seen = [False]
        stale_probe_col = [5_000_000]

        def poll_loop():
            while not poll_stop.is_set():
                try:
                    st, d, _ = req("/internal/degrade")
                    sig = d.get("signals", {})
                    poll_samples.append(
                        (time.monotonic(), int(d.get("level", 0)),
                         float(sig.get("fast_burn", 0.0)),
                         float(sig.get("queue_frac", 0.0))))
                    if d.get("level", 0) >= 2 and not stale_seen[0]:
                        stale_probe_col[0] += 1
                        co.import_bits("soak", "f", rows=[0],
                                       cols=[stale_probe_col[0]])
                        with lock:
                            oracle[0].add(stale_probe_col[0])
                        st, body, _ = req("/sql",
                                          b"SELECT COUNT(*) FROM soak")
                        if st == 200 and body.get("stale"):
                            stale_seen[0] = True
                except Exception:
                    pass
                poll_stop.wait(0.04)

        poller = threading.Thread(target=poll_loop, daemon=True)
        poller.start()
        try:
            # ---- the standing soak with chaos and membership churn -----
            standing_rate = min(60.0, max(8.0, 0.35 * qps_base))
            s = SOAK_STANDING_S
            chaos = (ChaosSchedule(plan=plan, cluster=c)
                     .delay(0.1 * s, "node1", 0.002, prob=0.3, op="query")
                     .drop(0.25 * s, "node2", prob=0.1, op="query")
                     .heal(0.45 * s)
                     .pause(0.50 * s, 2)
                     .unpause(0.75 * s, 2))
            tenants = SyntheticTenants(100_000, seed=22)
            driver = OpenLoopDriver(execute, rate_per_s=standing_rate,
                                    duration_s=s, tenants=tenants,
                                    seed=fault_seed, arrivals="poisson",
                                    max_workers=16, chaos=chaos)
            soak_t0 = time.monotonic()
            rep_std = driver.run()
            soak_t1 = time.monotonic()
            plan.heal()
            # bench.py heals here, but FaultPlan.heal removes partition
            # rules only: the soak's 10% drop on node2 would stay armed
            # through the ramp, where a leg dropped on all three tries
            # marks node2 down for good (nothing marks it up without
            # membership) and every later write answers 412
            plan.clear()
            print(f"degrade 19b: after the soak the cluster is "
                  f"{co.state()}, live {sorted(co.disco.live_ids())}; "
                  f"{rep_std.summary()}; failures {failures} {lab}")
            std_window = [x for x in poll_samples
                          if soak_t0 <= x[0] <= soak_t1]
            std_max_level = max((x[1] for x in std_window), default=0)
            std_max_burn = max((x[2] for x in std_window), default=0.0)
            assert std_max_level < 2, (
                f"standing load should not pass SHED_BATCH (saw level "
                f"{std_max_level}; level, burn, queue: "
                f"{[x[1:] for x in std_window if x[1]]}; "
                f"{rep_std.summary()})")
            assert std_max_burn < 60.0, (
                f"SLO fast burn unbounded under standing load: "
                f"{std_max_burn:.1f}x")
            ok_frac = rep_std.ok / max(rep_std.total, 1)
            assert ok_frac >= 0.5, rep_std.summary()
            goodput_std = rep_std.count("ok", kind=KIND_INTERACTIVE) / s
            p99_std_ms = rep_std.latency_quantile(
                0.99, kind=KIND_INTERACTIVE) * 1e3

            # ---- redrive un-acked writes, hold the write oracle --------
            deadline = time.monotonic() + 25.0
            while time.monotonic() < deadline:
                if poll_samples and poll_samples[-1][1] == 0:
                    break
                time.sleep(0.1)
            with lock:
                pending = list(unacked)
                unacked.clear()
            for row, col in pending:
                payload = json.dumps({"field": "f", "rows": [row],
                                      "cols": [col]}).encode()
                acked = False
                for _ in range(80):
                    st, body, hdr = req("/index/soak/import", payload)
                    if st == 200:
                        acked = True
                        with lock:
                            oracle[row].add(col)
                            acked_new.append((row, col))
                        break
                    wait = hdr.get("Retry-After")
                    time.sleep(min(0.5, float(wait) if wait else 0.1))
                assert acked, f"write ({row},{col}) never ACKed after heal"

            def rows_equal():
                for row in range(40):
                    st, body, _ = req("/index/soak/query",
                                      f"Row(f={row})".encode())
                    assert st == 200 and not body.get("stale"), body
                    got = set(body["results"][0]["columns"])
                    assert got == oracle[row], (
                        f"row {row}: cluster has {len(got)} cols, oracle "
                        f"{len(oracle[row])} (diff "
                        f"{len(got ^ oracle[row])})")

            rows_equal()

            # ---- the overload ramp: order, brownout, recovery ----------
            ramp_mix = ScenarioMix({KIND_INTERACTIVE: 0.8,
                                    KIND_BULK_IMPORT: 0.2})
            ramp_reps = []
            ramp_t0 = time.monotonic()
            for factor, dur in SOAK_RAMP:
                d = OpenLoopDriver(execute_ramp,
                                   rate_per_s=max(20.0, factor * qps_conc),
                                   duration_s=dur, mix=ramp_mix,
                                   tenants=tenants, seed=fault_seed + 1,
                                   arrivals="uniform", max_workers=32)
                ramp_reps.append(d.run())
            ramp_t1 = time.monotonic()
            ramp_window = [x for x in poll_samples
                           if ramp_t0 <= x[0] <= ramp_t1 + 1.0]
            max_level = max((x[1] for x in ramp_window), default=0)
            ramp_seen = {
                "rates": [max(20.0, f * qps_conc) for f, _ in SOAK_RAMP],
                "reports": [r.summary() for r in ramp_reps],
                "max_queue_frac": max((x[3] for x in ramp_window),
                                      default=0.0),
                "max_fast_burn": max((x[2] for x in ramp_window),
                                     default=0.0),
                "state": co.state(), "failures": failures}
            print(f"degrade 19b: ramp {json.dumps(ramp_seen)} {lab}")
            assert max_level == 3, (
                f"2.4x overload never saturated the ladder (max level "
                f"{max_level}; qps_conc {qps_conc:.0f}/s, qps_base "
                f"{qps_base:.0f}/s)")
            t_sat = min(x[0] for x in ramp_window if x[1] == 3)
            assert any(x[0] < t_sat and x[1] in (1, 2)
                       for x in ramp_window), \
                "ladder jumped to SATURATED without passing SHED_BATCH/" \
                "BROWNOUT"
            with lock:
                t_batch = first_degrade_shed.get("batch")
                t_inter = first_degrade_shed.get("interactive")
            assert t_batch is not None, "no batch work was ever shed"
            assert t_inter is not None, "saturation never shed interactive"
            assert t_batch < t_inter, \
                "ladder order violated: interactive shed before batch"
            assert missing_retry_after[0] == 0, \
                f"{missing_retry_after[0]} 429s lacked Retry-After"
            stale_ramp = sum(r.stale for r in ramp_reps)
            assert stale_seen[0] or stale_ramp, \
                "brownout never served a stale-tagged read"
            sat_rep = ramp_reps[-1]
            goodput_sat = sat_rep.count("ok", kind=KIND_INTERACTIVE) \
                / SOAK_RAMP[-1][1]

            deadline = time.monotonic() + 25.0
            recovered = False
            t_rec = time.monotonic()
            while time.monotonic() < deadline:
                if poll_samples and poll_samples[-1][1] == 0:
                    recovered = True
                    break
                time.sleep(0.1)
            assert recovered, "ladder never recovered to NORMAL after load"
            recovery_s = time.monotonic() - t_rec
        finally:
            poll_stop.set()
            poller.join(timeout=5)

        # ---- the bounded tables ------------------------------------------
        caps = {}
        for node in c.nodes:
            assert len(node.scheduler._tenant_vtime) <= 256
            cs = node.cache.stats()
            assert cs["entries"] <= node.cache.max_entries
        reg = co.tenants
        caps["tenant_rows"] = len(reg._stats)
        assert len(reg._stats) <= reg.max_tracked + 1, \
            f"tenant registry unbounded: {len(reg._stats)} rows"
        caps["programs"] = len(progs._PROGRAMS)
        assert len(progs._PROGRAMS) <= progs._PROGRAMS_CAP
        caps["mask_planes"] = len(pqlx._MASK_PLANES)
        assert len(pqlx._MASK_PLANES) <= pqlx._MASK_CAP
        caps["flight"] = len(co.api.health.flight.summaries())
        assert caps["flight"] <= 16
        probe = co.degrade.probe()
        assert probe["transitions"] >= 2, probe

        # the path's kernels against their plain versions at its shapes:
        # the soak's Intersect Counts (tape_count) and its acknowledged
        # single-bit imports on shard 4's owner (scatter_merge)
        def counts():
            for a, b in ((1, 2), (3, 4), (5, 120)):
                st, body, _ = req(
                    "/index/soak/query",
                    f"Count(Intersect(Row(f={a}), Row(g={b})))".encode())
                assert st == 200, body

        out["checked"] = _tapped(report, counts)
        assert out["checked"]["tape_count"] >= 1, out["checked"]
        new = [(r, col) for r, col in acked_new
               if col // SHARD_WIDTH == 4]
        assert new, "no acknowledged import on shard 4"
        owner = next(n for n in c.nodes if 4 in _cl_held(n, "soak"))
        frag = owner.holder.index("soak").field("f").fragment(4)
        with _uncounted():
            _scatter_check(report, frag,
                           np.array([r for r, _ in new], np.int64),
                           np.array([col % SHARD_WIDTH for _, col in new]),
                           owner.device)

    met = goodput_sat >= SOAK_GOODPUT_BAR * goodput_std
    out.update(qps_base=qps_base, qps_conc=qps_conc,
               standing_rate=standing_rate, ok=rep_std.ok,
               shed=rep_std.shed, errors=rep_std.errors,
               total=rep_std.total, ok_frac=ok_frac,
               goodput_std=goodput_std, p99_std_ms=p99_std_ms,
               std_max_level=std_max_level, std_max_burn=std_max_burn,
               max_level=max_level, stale_seen=stale_seen[0],
               stale_ramp=stale_ramp, goodput_sat=goodput_sat,
               goodput_met=met, recovery_s=recovery_s,
               transitions=probe["transitions"], caps=caps,
               chaos=chaos.fired(), acked_new=len(acked_new),
               redriven=len(pending),
               ramp=[{"ok": r.ok, "shed": r.shed, "errors": r.errors,
                      "stale": r.stale, "total": r.total}
                     for r in ramp_reps])
    print(f"degrade 19b: saturated interactive good-put "
          f"{goodput_sat:.3f}/s against {goodput_std:.3f}/s standing; bar "
          f"{SOAK_GOODPUT_BAR:.0%} = {SOAK_GOODPUT_BAR * goodput_std:.3f}/s: "
          f"{'met' if met else 'missed'} {lab}")
    _phase_print("19b", lab, "degrade", load_s=out["load_s"],
                 qps_base=qps_base, qps_conc=qps_conc,
                 standing_rate=standing_rate, ok_frac=ok_frac,
                 p99_std_ms=p99_std_ms, std_max_burn=std_max_burn,
                 max_level=max_level, transitions=probe["transitions"],
                 recovery_s=recovery_s, checked=out["checked"])
    return out


def phase_tenants(report: Report, device: str = "cuda:0") -> dict:
    """Path 19: tenants and graceful degradation. (19a) bench.py config
    18; (19b) bench.py config 22. ``device`` is the card's; a dry run on
    the CPU passes ``"cpu"``. Data dirs under ``build/chip_smoke_tenants``,
    removed at the end."""
    import gc
    import shutil
    import threading

    import torch

    from pilosa_tpu_torch.ops import kernel_util as KU

    lab = report.label
    t_phase = time.perf_counter()
    base = os.path.abspath(os.path.join("build", "chip_smoke_tenants"))
    shutil.rmtree(base, ignore_errors=True)
    out = {}
    # what the earlier paths leave in this process: host-speed bars and
    # the ramp's capacity reading depend on it
    t0 = time.perf_counter()
    gc.collect()
    print(f"tenants 19: at the start {threading.active_count()} threads, "
          f"{len(gc.get_objects())} tracked objects (a full collection "
          f"{time.perf_counter() - t0:.3f} s), "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB on the card "
          f"{lab}")
    try:
        for tag, fn, expected in (
                ("19a", _tenants_config18,
                 ("tape_count", "pair_counts", "scatter_merge")),
                ("19b", _degrade_config22, ("tape_count", "scatter_merge"))):
            torch.cuda.synchronize()
            KU.reset_launches()
            _UNCOUNTED.clear()
            t0 = time.perf_counter()
            out[tag] = fn(report, device, base, lab)
            out[tag]["seconds"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            launched = {k: v - _UNCOUNTED.get(k, 0)
                        for k, v in KU.launches().items()}
            report.launched(f"tenants {tag}", launched, expected)
            # every kernel the path launched was held against its plain
            # version at the path's shapes
            checked = {**out[tag]["checked"], "scatter_merge": 1}
            for name, n in launched.items():
                assert not n or checked.get(name, 0) >= 1, \
                    f"{tag} launched {name} {n} times, held none"
            out[tag]["launches"] = launched
            print(f"tenants {tag}: launches on the path {launched} {lab}")
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"tenants 19: steps "
          + ", ".join(f"{k} {out[k]['seconds']:.2f} s"
                      for k in ("19a", "19b"))
          + f"; {out['seconds']:.2f} s {lab}")
    print("tenants 19: " + json.dumps(out, default=str))
    return out


C19_SETS = 4_800  # bench.py config 19 (bench.py:1887-2063)
C19_BATCH = 8
C19_SHARDS = 12
C19_ROWS = 16
C19_BAR_S = 5.0  # bench's measurement window
C20B_CONFIG3_SHARDS = 6  # bench.py config 3's lineorder (bench.py:1746-1790)
#: 20b keeps the first 3 of config 3's 6 shards at their width: the whole
#: script passed 1,100 s with all 6 on a slow host
C20B_SHARDS = 3
C20B_BATCHES = 8  # import batches a shard a field: 16 ops a shard log
C20B_TAIL = 64
C20B_READS = 60
#: 20b's Count trees, each with its numpy mask over (year, brand)
C20B_COUNTS = (
    ("Count(Row(year=3))", lambda y, b: y == 3),
    ("Count(Intersect(Row(year=3), Row(brand=7)))",
     lambda y, b: (y == 3) & (b == 7)),
    ("Count(Union(Row(brand=1), Row(brand=2), Row(year=6)))",
     lambda y, b: (b == 1) | (b == 2) | (y == 6)),
    ("Count(Difference(Row(year=1), Row(brand=5)))",
     lambda y, b: (y == 1) & (b != 5)),
)


def _dax_counters() -> dict:
    """The DAX plane's counters in the process registry."""
    from pilosa_tpu_torch.obs import metrics as M

    reg = M.REGISTRY
    h = reg.histogram(M.METRIC_DAX_REPLAY_SECONDS) or {"sum": 0.0,
                                                       "count": 0}
    return {"pushes": sum(reg.value(M.METRIC_DAX_DIRECTIVE_PUSHES,
                                    method=m, outcome=o)
                          for m in ("full", "diff", "reset")
                          for o in ("applied", "stale", "failed")),
            "resyncs": reg.value(M.METRIC_DAX_FULL_RESYNCS),
            "prewarm_stacks": reg.value(M.METRIC_DAX_PREWARM_STACKS),
            "replay_ops": reg.value(M.METRIC_DAX_REPLAY_OPS),
            "replay_s": h["sum"], "shard_loads": h["count"]}


def _dax_moved(before: dict) -> dict:
    now = _dax_counters()
    return {k: now[k] - before[k] for k in now}


def _tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _s, files in os.walk(root) for f in files)


def _dax_resident(comp) -> int:
    """Device bytes of one computer's cached stacks in the budget."""
    from pilosa_tpu_torch.core import stacked as STK

    return STK.holder_resident_bytes(comp.api.holder)


def _dax_write_stages():
    """20b's host stages of a write window, for ``_StageClock``: the
    queryer's and the computer's split by shard, the writelog, the apply,
    the kernel with its parity check, and the snapshots."""
    import numpy as np

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.dax.computer import Computer
    from pilosa_tpu_torch.dax.queryer import Queryer
    from pilosa_tpu_torch.dax.storage import Snapshotter, WriteLogger
    from pilosa_tpu_torch.ops import scatter as SC
    from pilosa_tpu_torch.storage import store

    return [
        ("Queryer.import_bits (split by shard)", Queryer, "import_bits"),
        ("Queryer.query (route, HTTP, JSON)", Queryer, "query"),
        ("Computer.import_bits (split by shard)", Computer, "import_bits"),
        ("Computer.query_remote (parse, apply)", Computer, "query_remote"),
        ("writelog append (JSON, framing)", WriteLogger, "append"),
        ("writelog commit (fsync)", WriteLogger, "commit"),
        ("API.import_bits (apply)", API, "import_bits"),
        ("scatter (host)", SC, "scatter_new_bits_bulk"),
        ("scatter_merge and its parity check", SC, "scatter_merge_"),
        ("snapshot export", store, "export_shard_arrays"),
        ("snapshot compression (np.savez_compressed)", np,
         "savez_compressed"),
        ("snapshot write (fsync, rename)", Snapshotter, "write")]


def _dax_resume_stages():
    """The host stages of a directive that loads shards: the snapshot's
    read and install, the prewarm's stacks, the rest of the directive.
    The tail replay is the ``dax_replay_seconds`` histogram's growth
    less the snapshot's read and install."""
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.dax.computer import Computer
    from pilosa_tpu_torch.dax.storage import Snapshotter
    from pilosa_tpu_torch.storage import store

    return [("snapshot read", Snapshotter, "latest"),
            ("snapshot install", store, "install_shard_arrays"),
            ("prewarm", STK, "stacked_set"), ("prewarm", STK, "stacked_bsi"),
            ("directive (rest)", Computer, "apply_directive")]


def _dax_window(stages, fn) -> dict:
    """Run one window of 20b: its seconds to a device sync, its host
    seconds split by ``stages`` (each stage's own time; ``rest`` is the
    window's less theirs), and the card's busy time from devprof: the
    kernels' device seconds and the uploads' seconds over the window."""
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.obs import devprof

    c0, up0 = _dax_counters(), dict(STK.UPLOAD_STATS)
    was = devprof.ENABLED
    devprof.enable()
    devprof.reset()
    clock = _StageClock(stages)
    try:
        _, wall = _synced_s(fn)
    finally:
        clock.close()
        kstats = devprof.stats_json()
        if not was:
            devprof.disable()
    split = dict(clock.own)
    split["rest"] = wall - sum(split.values())
    kern_s = sum(k["device_seconds"] for k in kstats["kernels"]) \
        + kstats["other"]["device_seconds"]
    h2d = kstats["h2d"]
    moved = _dax_moved(c0)
    return {"wall_s": wall, "split_s": split, "calls": dict(clock.calls),
            "kernel_s": kern_s, "kernel_share": kern_s / wall,
            "h2d_s": h2d["seconds"], "h2d_bytes": h2d["bytes"],
            "h2d_share": h2d["seconds"] / wall,
            "upload_bytes": STK.UPLOAD_STATS["bytes"] - up0["bytes"],
            "counters": moved}


def _dax_resume(w: dict) -> dict:
    """A resume window's figures: the shards loaded, the snapshot's read
    and install, the tail replay, the prewarm (host seconds; its uploads
    are the window's)."""
    sp = w["split_s"]
    c = w["counters"]
    read, inst = sp.get("snapshot read", 0.0), sp.get("snapshot install",
                                                     0.0)
    return {"loads": c["shard_loads"], "read_s": read, "install_s": inst,
            "replay_s": c["replay_s"] - read - inst,
            "replay_ops": c["replay_ops"],
            "prewarm_s": sp.get("prewarm", 0.0),
            "prewarm_stacks": c["prewarm_stacks"],
            "prewarm_bytes": w["upload_bytes"], "wall_s": w["wall_s"]}


def _fmt_window(w: dict) -> str:
    return (f"{w['wall_s']:.3f} s: host "
            + ", ".join(f"{k} {v:.3f} s" for k, v in
                        sorted(w["split_s"].items(), key=lambda kv: -kv[1]))
            + f"; the card busy in kernels {w['kernel_s']:.4f} s "
            f"({100 * w['kernel_share']:.2f}%), in uploads {w['h2d_s']:.4f}"
            f" s ({100 * w['h2d_share']:.2f}%, {w['h2d_bytes']:,} B)")


def _dax_release(*apis) -> None:
    """Free the stacks of finished APIs (and their budget entries): the
    path's later steps and the card start clean."""
    from pilosa_tpu_torch.storage.recovery import abandon_holder

    for api in apis:
        abandon_holder(api.holder)


def _dax_config19(report, device, base, lab) -> dict:
    """20a: bench.py config 19 as ``bench_config19`` builds it, at its
    full size, on the card. Hard asserts as bench.py makes them; its two
    host-speed bars (the fresh owner's p99 within 2x the warm one, floor
    2 ms; the measurement within 5 s of the directive) printed met /
    missed. Then ``Count(Row(v > 0))`` and ``Sum(field=v)`` on the
    replayed computer against the oracle."""
    import copy

    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.dax.computer import Computer
    from pilosa_tpu_torch.dax.directive import (Directive, METHOD_FULL,
                                                METHOD_RESET)
    from pilosa_tpu_torch.dax.harness import DaxCluster
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(19)
    out = {"retries": 0, "reads": 0, "acked_sets": 0, "acked_values": 0}
    secs = {}
    c0 = _dax_counters()
    t_step = time.perf_counter()
    with _uncounted():
        oracle = API(device=device)
        oracle.create_index("e", {})
        oracle.create_field("e", "f", {"type": "set"})
        oracle.create_field("e", "v", {"type": "int"})
    cluster = DaxCluster(3, shared_dir=os.path.join(base, "c19"),
                         dead_after_s=1.0, snapshot_every=64, serving=True,
                         device=device)
    fields = [{"name": "f", "options": {"type": "set"}},
              {"name": "v", "options": {"type": "int"}}]
    cluster.controller.create_table("e", {}, fields=fields)
    alive = {0, 1, 2}

    def ask(q, shards=None):
        with _uncounted():
            return oracle.query("e", q, shards=shards)

    def beat():
        for i in alive:
            cluster.controller.checkin(cluster.computers[i].node.id)

    def retry(fn, what, tries=300):
        last = None
        for _ in range(tries):
            try:
                return fn()
            except Exception as exc:  # noqa: BLE001 — the chaos window
                last = exc
                out["retries"] += 1
                beat()
                cluster.step()
                time.sleep(0.02)
        raise AssertionError(f"{what} never recovered: {last!r}")

    check = None
    try:
        # -- phase 1: mixed load with a kill, a silence, a scale-up -----
        cols = rng.integers(0, 4096, C19_SETS)
        rowv = rng.integers(0, C19_ROWS, C19_SETS)
        shardv = rng.integers(0, C19_SHARDS, C19_SETS)
        n_batches = C19_SETS // C19_BATCH
        kill_at, silence_at, grow_at = (int(n_batches * f)
                                        for f in (0.3, 0.5, 0.7))
        for bi in range(n_batches):
            if bi == kill_at:
                cluster.kill(0)
                alive.discard(0)
            if bi == silence_at:
                cluster.silence(1)
                alive.discard(1)
            if bi == grow_at:
                cluster.scale_up()
                alive.add(len(cluster.computers) - 1)
            lo = bi * C19_BATCH
            pql = "".join(
                f"Set({int(shardv[i]) * SHARD_WIDTH + int(cols[i])},"
                f" f={int(rowv[i])})" for i in range(lo, lo + C19_BATCH))
            retry(lambda: cluster.queryer.query("e", pql), "write batch")
            out["acked_sets"] += C19_BATCH
            with _uncounted():
                oracle.query("e", pql)  # mirror once the fleet acked
            if bi % 12 == 5:
                vc = [int(shardv[lo]) * SHARD_WIDTH + k for k in range(12)]
                vv = [int(x) for x in rng.integers(-50, 50, 12)]
                retry(lambda: cluster.queryer.import_values("e", "v", vc,
                                                            vv),
                      "value import")
                with _uncounted():
                    oracle.import_values("e", "v", cols=vc, values=vv)
                out["acked_values"] += 12
            if bi % 10 == 7:
                q = f"Count(Row(f={bi % C19_ROWS}))"
                got = retry(lambda: cluster.queryer.query("e", q),
                            "read")[0]
                assert got == ask(q)[0], (bi, got)
                out["reads"] += 1
            beat()
            if bi % 10 == 0:
                cluster.step()
        dead = {cluster.computers[0].node.id, cluster.computers[1].node.id}
        assert dead <= cluster.controller.dead, \
            f"a dead computer is still live: {cluster.controller.dead}"
        torch.cuda.synchronize()
        secs["load"] = time.perf_counter() - t_step
        out["after_load"] = _dax_moved(c0)

        # -- phase 2: a RESET behind the controller forces a FULL resync -
        t_step = time.perf_counter()
        live = cluster.controller.live_ids()
        victim = next(c for c in cluster.computers if c.node.id in live)
        c1 = _dax_counters()
        victim.apply_directive(Directive(
            version=0, method=METHOD_RESET, schema=[],
            assigned=[]).to_json())
        cluster.controller.create_field("e", "aux", {"type": "set"})
        with _uncounted():
            oracle.create_field("e", "aux", {"type": "set"})
        out["reset"] = _dax_moved(c1)
        assert out["reset"]["resyncs"] > 0, \
            "restarted computer was not rebuilt via a FULL resync"
        q = "Count(Row(f=3))"
        assert retry(lambda: cluster.queryer.query("e", q),
                     "post-resync read")[0] == ask(q)[0]
        out["reads"] += 1
        torch.cuda.synchronize()
        secs["reset"] = time.perf_counter() - t_step

        # -- phase 3: warm handoff, fresh owner p99 against the warm ------
        def p99(pool, tag):
            pairs = [(r, s) for s in pool for r in range(2 * C19_ROWS)]
            times = []
            for i in range(min(60, len(pairs))):  # distinct: cache misses
                r, s = pairs[i]
                t0 = time.perf_counter()
                got = retry(lambda: cluster.queryer.query(
                    "e", f"Count(Row(f={r}))", shards=[s]), tag)[0]
                times.append((time.perf_counter() - t0) * 1e3)
                assert got == ask(f"Count(Row(f={r}))", [s])[0], (tag, r, s)
                out["reads"] += 1
            return float(np.percentile(times, 99))

        t_step = time.perf_counter()
        assign = cluster.controller.assignment()
        out["warm_p99_ms"] = p99(sorted({s for (_, s) in assign}),
                                 "warm read")
        c2 = _dax_counters()
        new_shards = []
        for _ in range(3):  # jump hash may (rarely) move nothing
            t_dir = time.perf_counter()
            cluster.scale_up()
            alive.add(len(cluster.computers) - 1)
            new_id = cluster.computers[-1].node.id
            new_shards = sorted(
                s for (_, s), nid in cluster.controller.assignment().items()
                if nid == new_id)
            if new_shards:
                break
        assert new_shards, "scale-up moved no shards after 3 attempts"
        out["handoff"] = _dax_moved(c2)
        assert out["handoff"]["prewarm_stacks"] > 0, \
            "new owner acked without prewarming the hot fields"
        out["fresh_p99_ms"] = p99(new_shards, "fresh read")
        out["within_s"] = time.perf_counter() - t_dir
        out["moved_shards"] = len(new_shards)
        out["bar_p99_met"] = out["fresh_p99_ms"] <= \
            2.0 * max(out["warm_p99_ms"], 2.0)
        out["bar_window_met"] = out["within_s"] <= C19_BAR_S
        secs["handoff"] = time.perf_counter() - t_step

        # -- phase 4: zero loss, every shard replayed into a fresh node ---
        t_step = time.perf_counter()
        shards_all = sorted(cluster.controller.shards_of("e"))
        assert len(shards_all) == C19_SHARDS, shards_all
        c3 = _dax_counters()
        check = Computer("c19-check", cluster.dir, device=device)
        res = check.apply_directive(Directive(
            version=1, method=METHOD_FULL,
            schema=copy.deepcopy(cluster.controller.schema),
            assigned=[("e", s) for s in shards_all]).to_json())
        assert res["applied"], res
        torch.cuda.synchronize()
        out["replay"] = _dax_moved(c3)
        out["replay_wall_s"] = time.perf_counter() - t_step
        got, want = check.api.checksum(), oracle.checksum()
        assert got == want, \
            "writes acked by the elastic fleet were lost: replayed " \
            f"checksum {got!r} != oracle {want!r}"
        out["checksum"] = got
        # the replayed node's BSI reads: bsi_compare and the Sum's kernels
        for q in ("Count(Row(v > 0))", "Sum(field=v)"):
            got = check.api.query("e", q)[0]
            want = ask(q)[0]
            if q.startswith("Sum"):
                got, want = (got.val, got.count), (want.val, want.count)
            assert got == want, (q, got, want)
            out[q] = got
        torch.cuda.synchronize()
        secs["zero_loss"] = time.perf_counter() - t_step
        out["resident_bytes"] = {c.node.id: _dax_resident(c)
                                 for c in cluster.computers + [check]}
        out["log_bytes"] = _tree_bytes(os.path.join(cluster.dir, "wl"))
        out["snapshot_bytes"] = _tree_bytes(os.path.join(cluster.dir,
                                                         "snap"))
        out["counters"] = _dax_moved(c0)
    finally:
        cluster.close()
        if check is not None:
            check.close()
        _dax_release(oracle, *(c.api for c in cluster.computers),
                     *([check.api] if check is not None else []))
    out["seconds_by_step"] = secs
    bar = lambda ok: "met" if ok else "MISSED"  # noqa: E731
    print(f"dax 20a: config 19 at full size ({C19_SETS:,} Sets in "
          f"{C19_SETS // C19_BATCH} batches over {C19_SHARDS} shards, seed "
          f"19): {out['acked_sets']:,} Sets and {out['acked_values']} values "
          f"acked after {out['retries']} retries through a kill, a silence "
          f"and a scale-up; {out['reads']} reads, each the oracle's; "
          f"directive pushes {out['counters']['pushes']:.0f}, resyncs "
          f"{out['counters']['resyncs']:.0f} (the RESET's "
          f"{out['reset']['resyncs']:.0f}), prewarm stacks "
          f"{out['counters']['prewarm_stacks']:.0f} (the handoff's "
          f"{out['handoff']['prewarm_stacks']:.0f}); the replay of all "
          f"{C19_SHARDS} shards {out['replay']['replay_ops']:.0f} ops, "
          f"dax_replay_seconds {out['replay']['replay_s']:.3f} s over "
          f"{out['replay']['shard_loads']:.0f} shard loads "
          f"({out['replay_wall_s']:.3f} s wall), checksum equal; warm p99 "
          f"{out['warm_p99_ms']:.2f} ms, fresh p99 "
          f"{out['fresh_p99_ms']:.2f} ms on {out['moved_shards']} moved "
          f"shards: the 2x bar {bar(out['bar_p99_met'])}, window "
          f"{out['within_s']:.2f} s: the {C19_BAR_S:.0f} s bar "
          f"{bar(out['bar_window_met'])}; Count(Row(v > 0)) "
          f"{out['Count(Row(v > 0))']}, Sum(field=v) "
          f"{out['Sum(field=v)']} on the replayed node, the oracle's; log "
          f"{out['log_bytes']:,} B, snapshots {out['snapshot_bytes']:,} B; "
          f"resident bytes {out['resident_bytes']}; steps "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f" {lab}")
    return out


def _dax_ssb(report, device, base, lab) -> dict:
    """20b: the DAX plane at SSB SF-1 width: the first ``C20B_SHARDS``
    shards of config 3's lineorder (6 x 2^20 columns drawn from seed 3,
    as ``bench_config3`` draws them), ``year`` x 7 and ``brand`` x 1,000
    mutex by row id, through ``Queryer.import_bits``."""
    import copy

    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.dax.computer import Computer
    from pilosa_tpu_torch.dax.directive import Directive, METHOD_FULL
    from pilosa_tpu_torch.dax.harness import DaxCluster
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(3)  # bench_config3's generator
    years, brands = 7, 1000
    n = C20B_SHARDS * SHARD_WIDTH
    year_of = rng.integers(0, years, C20B_CONFIG3_SHARDS * SHARD_WIDTH)[:n]
    brand_of = rng.integers(0, brands,
                            C20B_CONFIG3_SHARDS * SHARD_WIDTH)[:n]
    cols = np.arange(n, dtype=np.int64)
    out, secs = {}, {}
    schema = [{"name": "year", "options": {"type": "mutex"}},
              {"name": "brand", "options": {"type": "mutex"}}]
    c0 = _dax_counters()
    t_step = time.perf_counter()
    with _uncounted():
        oracle = API(device=device)
        oracle.create_index("ssb", {})
        for f in schema:
            oracle.create_field("ssb", f["name"], f["options"])
        oracle.import_bits("ssb", "year", rows=year_of, cols=cols)
        oracle.import_bits("ssb", "brand", rows=brand_of, cols=cols)
        torch.cuda.synchronize()
    secs["oracle"] = time.perf_counter() - t_step
    cluster = DaxCluster(3, shared_dir=os.path.join(base, "ssb"),
                         snapshot_every=8, serving=True, device=device)
    cluster.controller.create_table("ssb", {}, fields=schema)
    qy = cluster.queryer

    def want_of(q, shards=None):
        """numpy's answer to one of 20b's reads."""
        y, b = year_of, brand_of
        if shards is not None:
            keep = np.isin(cols // SHARD_WIDTH, shards)
            y, b = y[keep], b[keep]
        if q.startswith("GroupBy"):
            table = np.bincount(y * brands + b, minlength=years * brands)
            nz = np.flatnonzero(table)[:100]
            return [(int(k // brands), int(k % brands), int(table[k]))
                    for k in nz]
        if q.startswith("TopN"):
            cnt = np.bincount(b, minlength=brands)
            return sorted((-int(c), r) for r, c in enumerate(cnt) if c)[:10]
        return int(dict(C20B_COUNTS)[q](y, b).sum())

    def shape(q, res):
        if q.startswith("GroupBy"):
            return [(g.group[0].row_id, g.group[1].row_id, g.count)
                    for g in res]
        if q.startswith("TopN"):
            return [(-p.count, p.id) for p in res.pairs]
        return res

    def check_reads(shards=None):
        for q in (("GroupBy(Rows(year), Rows(brand), limit=100)",
                   "TopN(brand, n=10)") + tuple(q for q, _ in C20B_COUNTS)):
            got = qy.query("ssb", q, shards=shards)[0]
            assert shape(q, got) == want_of(q, shards), (q, shards)

    check = None
    try:
        # -- load: 8 batches a shard a field through the queryer ----------
        per = SHARD_WIDTH // C20B_BATCHES

        def load():
            changed = 0
            for s in range(C20B_SHARDS):
                for bi in range(C20B_BATCHES):
                    sl = slice(s * SHARD_WIDTH + bi * per,
                               s * SHARD_WIDTH + (bi + 1) * per)
                    for f, rows in (("year", year_of), ("brand", brand_of)):
                        changed += qy.import_bits(
                            "ssb", f, rows=rows[sl].tolist(),
                            cols=cols[sl].tolist())
            return changed

        changed = []
        out["load"] = _dax_window(_dax_write_stages(),
                                  lambda: changed.append(load()))
        secs["load"] = out["load"]["wall_s"]
        out["load_changed"] = changed[0]
        snaps = {s: max(int(name.split(".")[1])
                        for name in os.listdir(
                            os.path.join(cluster.dir, "snap", "ssb"))
                        if name.startswith(f"{s}."))
                 for s in range(C20B_SHARDS)}
        assert all(v >= 2 * C20B_BATCHES for v in snaps.values()), snaps
        out["snapshot_versions"] = snaps
        # -- the log tail: 64 Sets of year, mirrored to numpy -------------
        tc = rng.integers(0, n, C20B_TAIL)
        ty = rng.integers(0, years, C20B_TAIL)

        def tail():
            for c, y in zip(tc.tolist(), ty.tolist()):
                qy.query("ssb", f"Set({c}, year={y})")
                with _uncounted():
                    oracle.query("ssb", f"Set({c}, year={y})")
                year_of[c] = y

        out["tail"] = _dax_window(_dax_write_stages(), tail)
        secs["tail"] = out["tail"]["wall_s"]
        # -- reads through the queryer against numpy ----------------------
        t_step = time.perf_counter()
        check_reads()
        torch.cuda.synchronize()
        secs["reads"] = time.perf_counter() - t_step
        held = {}
        for (t, s), nid in cluster.controller.assignment().items():
            held.setdefault(nid, []).append(s)
        out["held"] = {k: sorted(v) for k, v in held.items()}
        # -- kill the busiest computer: time to a correct answer ----------
        victim = max(held, key=lambda k: (len(held[k]), k))
        vi = next(i for i, c in enumerate(cluster.computers)
                  if c.node.id == victim)
        lost = sorted(held[victim])
        t_kill = time.perf_counter()
        w = _dax_window(_dax_resume_stages(), lambda: cluster.kill(vi))
        q = "Count(Row(year=3))"
        got = qy.query("ssb", q, shards=lost)[0]
        out["kill_to_answer_s"] = time.perf_counter() - t_kill
        assert got == want_of(q, lost), (got, lost)
        out["kill"] = {"victim": victim, "shards": lost,
                       "owners": _dax_resume(w), "window": w}
        check_reads()
        secs["kill"] = time.perf_counter() - t_kill
        # -- scale up: directive to ack, prewarm, fresh against warm ------
        t_step = time.perf_counter()
        new_shards, grown, ack_s = [], None, None
        for _ in range(3):  # jump hash may move nothing: grow again
            new = cluster.spawn()
            t_push = new.clock.now()
            w = _dax_window(_dax_resume_stages(),
                            cluster.controller.rebalance)
            new_shards = sorted(
                s for (_, s), nid in
                cluster.controller.assignment().items()
                if nid == new.node.id)
            if new_shards:
                grown, ack_s = w, new.directive_at - t_push
                break
        assert new_shards, "scale-up moved no shards after 3 attempts"
        assert grown["counters"]["prewarm_stacks"] > 0, \
            "the new owner acked without prewarming"
        warm_shard = next(
            s for (_, s), nid in
            sorted(cluster.controller.assignment().items())
            if nid != new.node.id)

        def p99(shard):
            """Distinct reads, so every one misses the cache."""
            sl = slice(shard * SHARD_WIDTH, (shard + 1) * SHARD_WIDTH)
            want = np.bincount(brand_of[sl], minlength=brands)
            times = []
            for r in range(C20B_READS):
                t0 = time.perf_counter()
                got = qy.query("ssb", f"Count(Row(brand={r}))",
                               shards=[shard])[0]
                times.append((time.perf_counter() - t0) * 1e3)
                assert got == int(want[r]), (shard, r)
            return float(np.percentile(times, 99))

        out["scale_up"] = {
            "node": new.node.id, "shards": new_shards,
            "directive_to_ack_s": ack_s, "stage": _dax_resume(grown),
            "window": grown, "fresh_shard": new_shards[0],
            "warm_shard": warm_shard, "fresh_p99_ms": p99(new_shards[0]),
            "warm_p99_ms": p99(warm_shard)}
        check_reads()
        torch.cuda.synchronize()
        secs["scale_up"] = time.perf_counter() - t_step
        # -- zero loss: every shard replayed into a fresh computer --------
        t_step = time.perf_counter()
        check = Computer("ssb-check", cluster.dir, device=device)
        d = Directive(
            version=1, method=METHOD_FULL,
            schema=copy.deepcopy(cluster.controller.schema),
            assigned=[("ssb", s) for s in range(C20B_SHARDS)]).to_json()
        res = []
        w = _dax_window(_dax_resume_stages(),
                        lambda: res.append(check.apply_directive(d)))
        assert res[0]["applied"], res
        out["replay"] = {"stage": _dax_resume(w), "window": w}
        got, want = check.api.checksum(), oracle.checksum()
        assert got == want, \
            f"20b lost acked writes: {got!r} != oracle {want!r}"
        out["checksum"] = got
        secs["zero_loss"] = time.perf_counter() - t_step
        out["resident_bytes"] = {c.node.id: _dax_resident(c)
                                 for c in cluster.computers + [check]}
        out["log_bytes"] = _tree_bytes(os.path.join(cluster.dir, "wl"))
        out["snapshot_bytes"] = _tree_bytes(os.path.join(cluster.dir,
                                                         "snap"))
        out["counters"] = _dax_moved(c0)
    finally:
        cluster.close()
        if check is not None:
            check.close()
        _dax_release(oracle, *(c.api for c in cluster.computers),
                     *([check.api] if check is not None else []))
    out["seconds_by_step"] = secs
    k, up, rp = out["kill"], out["scale_up"], out["replay"]["stage"]
    ow = k["owners"]
    print(f"dax 20b: config 3's lineorder, its first {C20B_SHARDS} of "
          f"{C20B_CONFIG3_SHARDS} shards ({n:,} columns, seed 3) on a "
          f"3-computer fleet with snapshot_every=8: loaded through "
          f"Queryer.import_bits ({C20B_BATCHES} batches a shard a field) in "
          f"{secs['load']:.2f} s, snapshot versions "
          f"{out['snapshot_versions']}, {C20B_TAIL} Sets as the tail in "
          f"{secs['tail']:.2f} s; GroupBy, TopN and {len(C20B_COUNTS)} "
          f"Count trees equal numpy before the kill, after it and after "
          f"the scale-up; shards per computer {out['held']}; killed "
          f"{k['victim']} (shards {k['shards']}): first correct answer "
          f"over them {out['kill_to_answer_s']:.3f} s after the kill; the "
          f"new owners: {ow['loads']} shards, snapshot read "
          f"{ow['read_s']:.3f} s and install {ow['install_s']:.3f} s, tail "
          f"replay {ow['replay_s']:.3f} s ({ow['replay_ops']:.0f} ops), "
          f"prewarm {ow['prewarm_s']:.3f} s ({ow['prewarm_stacks']:.0f} "
          f"stacks, {ow['prewarm_bytes']:,} B uploaded); scale-up "
          f"{up['node']} took shards {up['shards']}, directive to ack "
          f"{up['directive_to_ack_s']:.3f} s, prewarm stacks "
          f"{up['stage']['prewarm_stacks']:.0f}, prewarm PCIe bytes "
          f"{up['stage']['prewarm_bytes']:,}; p99 of {C20B_READS} distinct "
          f"reads: fresh shard {up['fresh_shard']} "
          f"{up['fresh_p99_ms']:.2f} ms, warm shard {up['warm_shard']} "
          f"{up['warm_p99_ms']:.2f} ms; all {C20B_SHARDS} shards replayed "
          f"into a fresh computer in {rp['wall_s']:.3f} s (snapshot read "
          f"{rp['read_s']:.3f} s, install {rp['install_s']:.3f} s, "
          f"{rp['replay_ops']:.0f} tail ops in {rp['replay_s']:.3f} s), "
          f"checksum equal to the oracle's; log {out['log_bytes']:,} B, "
          f"snapshots {out['snapshot_bytes']:,} B on disk; resident bytes "
          f"{out['resident_bytes']}; steps "
          + ", ".join(f"{k_} {v:.2f} s" for k_, v in secs.items())
          + f" {lab}")
    for name in ("load", "tail"):
        print(f"dax 20b: the {name} window {_fmt_window(out[name])} {lab}")
    return out


def phase_dax(report: Report, device: str = "cuda:0") -> dict:
    """Path 20: the DAX serverless plane. (20a) bench.py config 19;
    (20b) the plane at SSB SF-1 width. ``device`` is the card's; a dry
    run on the CPU passes ``"cpu"``. The shared directory is under
    ``build/chip_smoke_dax``, removed at the end."""
    import gc
    import shutil

    import torch

    from pilosa_tpu_torch.ops import kernel_util as KU

    lab = report.label
    t_phase = time.perf_counter()
    base = os.path.abspath(os.path.join("build", "chip_smoke_dax"))
    shutil.rmtree(base, ignore_errors=True)
    out = {}
    try:
        for tag, fn, expected in (
                ("20a", _dax_config19,
                 ("tape_count", "pair_counts", "bsi_compare")),
                ("20b", _dax_ssb,
                 ("tape_count", "pair_counts", "scatter_merge"))):
            torch.cuda.synchronize()
            KU.reset_launches()
            _UNCOUNTED.clear()
            t0 = time.perf_counter()
            res = {}
            checked = _tapped(report, lambda: res.update(
                fn(report, device, base, lab)))
            res["seconds"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            launched = {k: v - _UNCOUNTED.get(k, 0)
                        for k, v in KU.launches().items()}
            report.launched(f"dax {tag}", launched, expected)
            for name, n in launched.items():
                assert not n or checked.get(name, 0) >= 1, \
                    f"{tag} launched {name} {n} times, held none"
            res["launches"], res["checked"] = launched, checked
            out[tag] = res
            print(f"dax {tag}: launches on the path {launched}; held "
                  f"against the plain versions {checked} {lab}")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"dax 20: steps "
          + ", ".join(f"{k} {out[k]['seconds']:.2f} s"
                      for k in ("20a", "20b"))
          + f"; {out['seconds']:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB on the card "
          f"after {lab}")
    print("dax 20: " + json.dumps(out, default=str))
    return out


def _print_ptxas(info: str) -> None:
    """ptxas's report on the tape_count, ctile_count and scatter_merge
    kernels; the one-op path of tape_count and both scatter_merge kernels
    must keep no stack frame and spill nothing."""
    lines = info.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        name = line.split("'")[1]
        if not any(k in name for k in ("tape_", "ctile_count",
                                        "scatter_merge")):
            continue
        props = next((x.strip() for x in lines[i + 1:i + 4]
                      if "stack frame" in x), "")
        regs = next((x.split(":", 1)[1].strip() for x in lines[i + 1:i + 4]
                     if "registers" in x), "")
        print(f"ptxas: {name}: {props}; {regs}")
        if "tape_one_op" in name or "scatter_merge" in name:
            assert props.startswith("0 bytes stack frame, 0 bytes spill "
                                    "stores, 0 bytes spill loads"), \
                f"{name} uses local memory: {props}"


def _wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--shards", type=int, default=6)
    ap.add_argument("--f3-probe", type=int, default=0, metavar="N",
                    help="only take path 14c's busy bsi_compare trace N "
                         "times on path 2's index (ROADMAP C, F.3)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if os.environ.get("PILOSA_TPU_COMPRESS") is not None:
        print("chip_smoke: unset PILOSA_TPU_COMPRESS: path 3 checks what "
              "the auto compression rule makes resident", file=sys.stderr)
        return 1
    from pilosa_tpu_torch.ops import kernel_util as KU

    name_power = _smi("name,power.limit")
    gpu_name = torch.cuda.get_device_name(0)
    power_limit = name_power.split(",")[-1].strip() if name_power else "?"
    nvcc_line = subprocess.run([KU.nvcc(), "--version"], capture_output=True,
                               text=True).stdout.strip().splitlines()[-1]
    print(f"environment: torch {torch.__version__} cuda {torch.version.cuda}")
    print(name_power)
    print(f"environment: {nvcc_line}")

    from pilosa_tpu_torch.probes import launch_probe as LP

    t0 = time.perf_counter()
    probe_build = LP.start_build()  # beside the kernels
    KU.lib()
    probe_lib = LP.load(*probe_build, verbose=False)
    print(f"build: kernels and the launch probe built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {KU.BUILD_SECONDS:.2f} s)")
    _print_ptxas(KU.ptxas_info())

    props = torch.cuda.get_device_properties(0)
    clock = _smi("clocks.max.sm").split()
    clock_mhz = float(clock[0]) if clock else 1980.0  # H100 SXM boost
    popc_rate = POPC_PER_CLOCK_PER_SM * props.multi_processor_count \
        * clock_mhz * 1e6
    mem_rate = _mem_rate(gpu_name)
    print(f"bounds: {mem_rate / 1e12:.2f} TB/s memory, {popc_rate / 1e12:.3f} "
          f"T popc/s ({props.multi_processor_count} SMs x "
          f"{POPC_PER_CLOCK_PER_SM}/clock x {clock_mhz:.0f} MHz)")

    report = Report(gpu_name, power_limit)
    if args.f3_probe:
        probe_f3(report, args, args.f3_probe)
        return 0
    device = torch.device("cuda", 0)
    lop_rate = LOP_PER_CLOCK_PER_SM * props.multi_processor_count \
        * clock_mhz * 1e6
    rates = (mem_rate, popc_rate, lop_rate)

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s")
        return out

    timed("kernel parity", phase_kernels, report,
          np.random.default_rng(args.seed + 1), device, popc_rate, mem_rate,
          lop_rate, INT8_OPS_PER_S, probe_lib)
    print("kernel parity: every kernel matches its plain version bit for "
          "bit")
    ssb = timed("1 SSB", phase_main_path, report, args)
    bsi = timed("2 BSI", phase_bsi_path, report, args)
    by_date = timed("3 SSB by date", phase_ssb_by_date, report, args)
    timed("sparse BSI", phase_sparse_bsi, report, args)
    config1 = timed("5 config 1", phase_config1, report, args)
    by_date = timed("6 writes", phase_writes, report, config1, by_date, bsi)
    c4 = timed("7 time", phase_time, report, args, rates)
    timed("8 dataframe", phase_dataframe, report, args, mem_rate)
    timed("9 serving", phase_serving, report, ssb, by_date, c4, rates)
    timed("14 observability", phase_observability, report, ssb, bsi, by_date,
          config1)
    timed("21 mesh", phase_mesh, report, ssb, bsi)
    del ssb, by_date, c4, bsi, config1
    timed("10 API reads", phase_api_reads, report)
    timed("11 durability", phase_durability, report, args,
          report.notes.get("write_visible_ms"))
    timed("12 ingest", phase_ingest, report)
    timed("13 SQL", phase_sql, report)
    timed("15 front ends", phase_frontends, report)
    cluster = timed("16 cluster", phase_cluster, report, keep_16d=True)
    timed("17 resilience", phase_resilience, report,
          cluster.pop("16d_cluster"))
    timed("18 gossip", phase_gossip, report)
    timed("19 tenants", phase_tenants, report)
    timed("20 DAX", phase_dax, report)

    print(f"profiler: empty traces of counted launches taken again "
          f"{len(PROFILER_MISSES)} {PROFILER_MISSES}")
    print(json.dumps({"kernels": list(report.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
