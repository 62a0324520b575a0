#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``gofr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each a hard failure with a non-zero exit:

1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``gofr_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel), with ptxas's report (registers, spills, shared memory) of
   the main path's instantiations beside it; a report that wgmma was
   serialized fails the phase;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and where the kernels can break, with the tolerance
   stated beside each: flash at buckets on and off its 128-row query and
   64-key tiles (S 32…2048), head dims 64 and 128, causal and not, kv_len
   0, odd and off every tile edge; both paged kernels at pages 16 and 32
   with lengths 0, on and one past a split span, a lone 4000-token row
   (B=1), and groups of 4 and 8 query heads;
3. drive four engine paths through ``ServingEngine.submit`` at Llama-3-8B
   widths (random weights from a seeded generator), each with the
   kernels' launch counters reset just before and read just after:
   - ``bf16``: bf16 paged KV, every prompt prefilled whole (flash kernel),
     decode through the bf16 paged kernel;
   - ``int8``: int8 paged KV on 32-token pages with the reference's
     256-token prefill chunks, prompts up to 3000 tokens (past the
     largest bucket): short prompts prefill whole, long ones chunk through
     the unified ragged dispatch, decode through the int8 paged kernel;
   - ``dense``: the reference's defaults, the dense slot cache with bf16
     KV and 256-token chunks: prompts of at most 256 tokens prefill whole
     (flash), longer ones chunk through the dense ragged dispatch, decode
     reads each row's whole layer cache in plain PyTorch (as the
     reference's XLA does); neither paged kernel may launch;
   - ``dense-w8``: the dense cache with int8 KV and weight-only int8
     params (``quantize_params`` of the same weights, on the card), prompts
     up to 3000 tokens;
   then serve one greedy request alone on each path and hold the logits
   the engine computed for it (its prefill's or final chunk's, and its
   decode steps', through the pool or the slot cache) against a plain
   dense forward of the same weights over the prompt and the tokens the
   engine generated (on the int8 paths with K/V passed through
   ``quantize_kv`` and ``dequantize_kv`` at every layer); then the
   lifecycle phase (cancel, priority, deadlines, streaming, drain, shed on
   a dense and a paged int8 engine); then the kv-reuse and spec phase, at
   ``PLANE_DEPTH`` (4 of the 32 layers), one engine after another with
   the launches of each counted alone:
   - ``R1`` dense bf16, ``R2`` paged bf16 (16-token pages) and ``R3`` paged
     int8 (32-token pages), each with a 64-entry, 2 GiB prefix cache: a
     200-token prompt twice (the second a whole-prompt hit: no prefill,
     no flash launch, the same tokens); a 1000-token prompt alone twice
     (on R1 and R2 a full chunk-chain hit with zero prefill dispatches,
     on R3 a recomputation, as int8 KV keeps no chunk cache); on R1 and
     R2 a 768-token system prompt with 8 concurrent 200-token suffixes
     (24 chunk hits, 8 chunks computed); on R1 the logits of a warm
     request (first token from the cached chain) against the dense
     forward;
   - ``R4`` dense bf16 with a device tier of 2 MiB a layer (one 200-token
     entry, not two; 64 MiB at full depth) over a 1 GiB host spill
     tier: prompt A, prompt B (which evicts A to pinned host memory), a
     flush, then A again, a host-tier hit with A's tokens;
   - ``S1`` dense bf16 and ``S2`` paged int8 with 4 prompt-lookup drafts
     a step: 8 greedy rows of prompts that repeat a 40-token segment and
     a sampled row, beside a non-spec engine of the same layout; one
     greedy request's verify logits against the dense forward, each
     emitted token the argmax of the engine's own logits;
   then the LoRA and tenancy phase, at ``PLANE_DEPTH`` (4) of the 32
   layers (the first 4 of the same weights), the launches of each engine
   counted alone:
   - ``L1`` dense bf16 with an ``AdapterRegistry`` of three rank-16
     adapters (``make_adapter``, seeds 1-3): 8 greedy rows of 200-token
     prompts in one batch (2 base, 2 per adapter), then each alone, the
     tokens equal or parted only where the dense forward's logits of the
     two tokens lie within ``GAP_TOL``; each adapter moves tokens against
     base; one request per adapter holds its logits plus the delta from
     the engine's tables against the dense forward plus ``emb[t] @ A @
     B``; ms a decode step of 8 rows with adapters and without;
   - ``L2`` paged int8 (32-token pages, 256-token chunks), the same
     registry: a 1000-token prompt under an adapter chunks through the
     ragged dispatch, its first token folded on the device, its logits
     held the same way;
   - ``T1`` dense bf16 and ``T2`` paged bf16 (16-token pages), each with a
     64-entry prefix cache and a ``TenantRegistry``: 8 batch-class rows of
     600-token prompts, 128 new tokens; once each has 16 out, one
     interactive 200-token request of 16. At least one preemption, warm
     resumes (a chunk hit, fewer chunk dispatches than a cold prefill),
     every token streamed once, each row's tokens held against its twin
     on an engine without the ladder; the interactive TTFT on both;
   then the healing phase, at ``PLANE_DEPTH`` (4) layers of the same
   weights, one supervised engine after
   another with the launches read before and after each (it never
   provokes a real CUDA fault: a sticky one would end the process):
   - ``H1`` dense bf16 (2048, 4 slots) with device telemetry: a fresh
     request with zero restarts (the cold-dispatch grace), then four
     running rows and four queued ones (two sampled); once each running
     row has 8 tokens out, ``engine.step`` hangs 6 s: SUSPECT, RESTARTING,
     UP; one restart; the running rows a retriable 503; the queued rows
     the tokens of a clean engine under the same ids; flash launching for
     every requeued prefill; the quarantined thread gone after its thaw;
     detection latency, ``warm_restart`` ms, the requeued TTFT,
     ``memory_allocated`` around it and ``details.device``;
   - ``H2`` paged int8 (32-token pages, 4096, 256-token chunks):
     ``device.loss`` once while eight rows (one of 1000 tokens) decode:
     every row fails with ``DeviceLost``, one poisoning and no restart, a
     clean ``torch.cuda.synchronize()``, memory within 64 MiB across the
     in-place rebuild, and the same prompts served again through the int8
     paged kernel with the first run's tokens;
   - ``H3`` paged bf16 (16-token pages): a poison storm (three
     ``device.loss``) escalates to a warm restart, then a probe through
     the bf16 paged kernel; memory around each rebuild and restart;
   - ``H4`` dense bf16 (2 slots, budget 2): a crash, one restart and a
     request through flash; then a crash at every step parks the engine
     WEDGED with every future settled within 10 s;
   then the observability phase, at ``PLANE_DEPTH`` layers, each engine
   instrumented
   (a Manager with ``register_serving_metrics``, a Tracer over an
   in-memory exporter, a caller span per request as ``trace_ctx``) and
   then a bare twin of it (no metrics, no tracer) through the same request
   sets, each set started behind a gate on the loop's step plan so both
   run the same dispatches:
   - ``O1`` dense bf16 (2048, 8 slots, 256-token chunks, a 2 GiB prefix
     cache with the chunk cache, gold/bulk/metered tenants): prompts of 5,
     31 (sampled), 200, 777 and 1000 tokens, a row canceled mid-stream, a
     queued 504, a metered tenant's 429; the 200 and 1000 again (a
     whole-prompt and a full chunk-chain hit); 8 batch-class rows of 600
     tokens and an interactive request that preempts one;
   - ``O2`` paged int8 (32-token pages, 4096, a 64 MiB device tier over a
     1 GiB host tier) with device telemetry: 8 prompts (1000 and 450
     chunk), the 200 again, two more 200-token prompts, a spill flush and
     the 200 once more, from the host tier;
   each then a timing set of 8 rows under ``set_sync_debug_mode("warn")``.
   Checked: one timeline per request id with one terminal mark and the
   result's finish reason, stamps in order, its TTFT within 2 ms of the
   result's, chunk counts, tiers, the preempted row's stamp; every span in
   its caller's trace under ``engine.queue``, one chunk span per computed
   chunk, no open span after the drain; TTFT and e2e counts, prefix hits
   by tier, one preemption and one tenant shed, a clean ``promlint``, the
   HBM gauges, ``request_latency``; the ``_block_sync`` reads equal to the
   dispatches and the ``_first_token`` syncs to the monolithic
   admissions, sync warnings a dispatch equal to the twin's, greedy tokens
   equal to the twin's, flash and int8 paged launches;
   then the HA and cross-replica KV phase, at ``PLANE_DEPTH`` layers of
   the same weights, engines built two at a time over the one weight set, each second engine's
   ``memory_allocated`` held to its KV:
   - ``A1`` paged int8 (4096, 32-token pages, a 16-frame replay window): 8
     threads submit one 200-token prompt under one key (one admission, one
     terminal mark, 8 equal results, 7 registry hits, 32 flash launches);
     a keyed stream dropped at frame 10, orphaned and resumed (frames
     11…N+1 once, the joined stream equal to the result); a resume behind
     the window (``ReplayGap``, a 404); an orphan canceled within its grace
     plus a block; a fenced zombie after ``warm_restart`` (409, no id);
   - ``M`` paged bf16 (2048, 16-token pages, 64-entry prefix caches): a
     destination whose ``KVMigrator`` holds the source serves its
     1000-token chunked and 200-token prompts with no prefill compute and
     no flash launch, the source's tokens and ``app_kv_migrations_total``
     2; a ``kv.migrate`` fault computes what was not fetched;
   - ``D`` dense bf16 (2048): a ``prefill_only`` request on a prefill
     engine retires ``"handoff"`` with no emission and no decode; a decode
     engine's ``handoff_from`` serves the unified engine's tokens with no
     prefill compute; a ``kv.handoff`` fault re-prefills;
   then the fleet phase, at ``PLANE_DEPTH`` (4) layers of the same weights,
   at most two engines at once over the one weight set, each announced on
   an ``InMemoryBroker`` every 0.2 s to a ``Router`` with the serving
   catalog:
   - ``F1`` two paged bf16 replicas (2048, 16-token pages, 64-entry prefix
     caches): 8 prompts sharing a 1000-token prefix all on the affine
     replica, the first computing 4 chunks and the rest one (768 tokens
     hit); a ``router.route`` fault walked to the other replica with a
     direct submit's tokens; ``warm_restart`` under a burst of 8, each
     request one terminal (a result or a retriable error); a keyed pair
     admitted once; ``routerz`` and the five ``app_router_*`` series,
     ``promlint``-clean;
   - ``F2`` a survivor and a preemptible paged bf16 replica from a
     ``SimulatedPoolDriver``, ``KVMigrator``s on one ``PrefixIndex``:
     4 batch-class and 4 interactive rows of 1000-token prompts, then a
     30 s notice: RECLAIMING on a beat and unrouted, the batch rows a
     retriable 503 before the last interactive token, the interactive
     ones finished, the evacuation
     committed to the survivor, the three reclamation series; the batch
     prompts again through the router served from the evacuated chain
     with a cold run's tokens; ``memory_allocated`` falls by the reaped
     replica's KV; a notice lost to a ``replica.reclaim`` fault;
   - ``F3`` an ``Autoscaler`` over ``engine_factory``'s paged int8
     replicas (4096, 32-token pages): a burst of 32 scales up to two (the
     time from the decision to the new replica's first route), the idle
     pool drains and reaps to one with nothing lost, a ``scale.decision``
     fault skips a round; then a dense bf16 prefill replica and a decode
     replica: a 1000-token prompt through ``_submit_disagg`` beside a
     unified engine's TTFT and tokens, no prefill compute on the decode
     replica;
   then the http phase: ``H1`` an ``App`` over a paged int8 engine (the
   main path's prompts as SSE streams against ``engine.submit``, the other
   routes, ``/metrics``, the profiler, the admin drain) and ``H2`` two apps
   behind a router of ``HTTPReplica``s (its binary ``/kv/fetch`` entry's
   bytes held to its slabs' shapes), both at ``PLANE_DEPTH`` (4) layers,
   and ``H3`` ``python -m gofr_tpu_torch.serve`` as a process at full
   depth with ``DB_DIALECT=sqlite`` (``sql`` UP on its health route); then the surface
   phase, at ``PLANE_DEPTH`` (4) layers, one ``App`` with API-key auth over a
   paged bf16 engine (2048, 16-token pages, whole prefills):
   - ``W`` the main path's prompts as 10 concurrent WebSocket streams
     (``/ws/generate``, the port's own client) against ``engine.submit``,
     sync warnings a dispatch equal; an upgrade with no key and with a
     wrong key and a ``POST /generate`` with no key refused 401 with no
     admission; a dropped and a closed socket each release row and pages;
     TTFT and the gap a token over the socket;
   - ``Q`` 8 generation jobs through ``app.subscribe`` on the in-memory
     broker, one ``pubsub.handler`` fault (one redelivery), a poison job
     dead-lettered after the topic's attempts, the ``app_pubsub_*``
     series and the consumers' health;
   - ``C`` a ``new_cmd`` app's ``generate`` subcommand against
     ``engine.submit``, help and an unknown command;
   - a ``* * * * * *`` cron job reading the device telemetry into a gauge
     all along; ``POST /.well-known/drain`` refused without the key, then
     draining the app with it;
   then the models phase, the other served families at their published
   widths (random weights from the seed), the launch counters reset
   before it:
   - ``E`` BERT-base (12 layers, d 768, bf16) behind ``/embed`` on an
     ``App``: 50 single-text requests one at a time at 16, 128 and 512
     tokens (p50/p95 by the client's clock), one request of 32 texts of
     mixed lengths, a request with no input (400); every row unit-norm,
     each text alone and in the batch at cosine >= 0.999, each against an
     f32 forward of the same weights at cosine >= 0.99, ``engine`` "torch";
   - ``A`` Whisper-large-v3 (128 mels, 32+32 layers, d 1280, bf16) written
     as an HF-layout safetensors directory by the script's own writer and
     loaded back by ``load_whisper_from_hf`` (bit-identical), served by an
     ``ASRWorker`` under ``app.subscribe("asr-jobs", ...)`` on the
     in-memory broker: jobs of 5, 12 and 30 s of seeded audio as
     ``audio_b64`` (32 tokens) and an empty one, one at a time; each
     reply's tokens equal to a direct ``transcribe`` of the same mel, the
     first step's logits against an f32 run, "empty audio"; load GB/s,
     encode ms of 30 s, ms a decoded token, publish-to-reply ms a job;
   - ``L`` an HF-layout Llama checkpoint at Llama-3-8B widths (2 layers)
     with a small byte-level BPE ``tokenizer.json`` (Llama-3's Split
     pattern) through ``ServingEngine.from_hf`` (paged bf16, 16-token
     pages, whole prefills): loaded params bit-identical, the port's
     ``BPETokenizer`` round-tripping the texts, the main path's prompts
     token-equal to an engine built from the same params, flash and the
     bf16 paged kernel launched, ``ByteTokenizer`` without the asset,
     ``forward``'s last logits (plain attention) against the flash
     prefill's; load s and the host's peak RSS;
   then the device phase, the launch counters reset before it:
   - ``T`` ``models.train.make_train_step`` at Llama-3-8B widths cut to
     ``DEVICE_T_DEPTH`` (2) layers, bf16, random from the seed: 4 AdamW steps
     on one repeated batch of 2 x 512 tokens, the loss falling and every
     gradient finite, ms a step and the peak ``max_memory_allocated``; a
     second run of 2 steps, params and optimizer state through a
     ``CheckpointManager``, a restore and 2 more steps, held to the 4
     straight steps within ``RESUME_REL_TOL``;
   - ``K`` T's params saved (npz, keep=3) and served by
     ``ServingEngine.from_checkpoint`` (paged bf16, 8 slots, N = 4,
     16-token pages, 2048): the main path's prompts, 32 greedy tokens
     each, token-equal to an engine built from the same params; save and
     restore s, GB/s and the host's RSS; flash and bf16 paged launched;
   - ``D`` an ``App`` on 127.0.0.1 with ``app.add_tpu(new_tpu(config))``,
     whose handler calls ``ctx.tpu.execute`` on three executables captured
     as CUDA graphs: ``flash`` (B=1, S=1024, H=32, Hkv=8, D=128, causal),
     ``paged`` (bf16, B=8 over 2851 tokens, page 16) and ``llama8``
     (``llama.forward`` at T's widths and depth, B=1, S=128); each replay
     held to an eager call (flash and paged bit-equal, llama8 within
     ``LOGITS_REL_TOL``) and flash and paged to their plain versions;
     replay against eager ms (median of 20); a wrong-shape execute a
     ``TPUError`` and a 503, health DEGRADED with ``last_error`` and UP
     after the next success, ``/metrics`` with the HBM gauge and, after
     10 s of executes, ``app_tpu_duty_cycle``; launches are the captured
     ones times the replays;
   - ``X`` the MoE at Mixtral-8x7B widths (8 experts, top-2) cut to
     ``MOE_DEPTH`` (2) of 32 layers, B=1, S=512: forward ms, finite
     logits, the load-balance loss finite, positive and equal to
     ``load_balance_loss``'s own pass, a backward reaching exactly the
     experts a token was routed to;
   then the sql phase, at Llama-3-8B widths and ``PLANE_DEPTH`` layers (the
   weights made again from the seed; the files, stores and analytics
   phases' engines too), the launch counters reset before it:
   - ``S1`` an ``App`` on 127.0.0.1 with ``DB_DIALECT=sqlite`` (a temporary
     file) and ``app.add_tpu(new_tpu(config))``; ``app.migrate``: version 1
     the ``prompt`` and ``generation`` tables, 2 the main path's ten
     prompts and 10,000 filler rows in the migration's transaction, 3 a
     ``ds.tpu`` warm-up (the paged bf16 executable at D's shape, one
     execute bit-equal to eager and within 2^-6 of the plain version), 4
     raises after an insert (a ``MigrationError``, nothing of it left,
     ``MAX(version)`` 3); ms of each version;
   - ``S2`` ``add_rest_handlers(Prompt)`` over HTTP (the port's client):
     200 single requests of each verb one at a time (p50/p95 ms), a GET of
     all 10,010 rows (ms, bytes), 404 and 400; Queue C 42: 8 POSTs sent
     while a handler holds a ``ctx.sql.begin()`` open wait until it rolls
     back, then land, and its own row does not;
   - ``S3`` a paged bf16 engine (the bf16 path's config) on the same app:
     ``POST /jobs/{id}`` for the ten main prompts at once (the prompt row
     through ``ctx.sql``, 32 greedy tokens, the ``generation`` row in one
     transaction), each job's tokens held to ``engine.submit`` of the same
     prompts in the same order, each row read back through CRUD equal to
     its reply, the ``app_sql_stats`` count equal to the statements
     issued, ``sql`` UP; TTFT through the handler against submit, ms of
     each job's SQL write; flash and bf16 paged launched, int8 paged not;
   - ``S4`` a second ``App`` on the same file with versions 1-3 and a new
     5: only 5 runs and its ``TPUClient`` compiles and launches nothing;
     then S1's versions 1-2 (1,000 filler rows) and S2's CRUD sequence over
     ``DB_DIALECT=postgres`` and ``mysql`` against the port's fake servers
     on 127.0.0.1: the rows read back equal across the three dialects
     (MySQL's raw rows as text), the pool gauges, ms a statement;
   it prints a ``{"sql": ...}`` line; its launches (S3's engine, and S1's
   captured launches times their replays) are the ``kernels`` rows'
   ``launches_sql``; then the pubsub phase on ``PLANE_DEPTH`` layers of
   the same weights, the launch counters reset before it: one paged bf16
   engine (the bf16 path's config), the main path's ten prompts each alone through ``submit`` as
   the gold, then for each of ``KAFKA``, ``NATS``, ``MQTT`` and
   ``EVENTHUB`` the port's fake of that broker on 127.0.0.1, an ``App``
   with ``PUBSUB_BACKEND`` set to it and a subscriber on ``generate`` that
   submits each job (32 greedy tokens) and publishes its result to
   ``generate.results``, and a user's client of the same broker that
   publishes the jobs and reads the results:
   - ``P1`` the ten prompts published at once: ten results, each job
     served once, its tokens held to the gold (equal, or parted only
     within ``GAP_TOL``);
   - ``P2`` one job under an injected ``pubsub.handler`` fault: one
     redelivery, served once, no dead letter; the fault to the
     redelivered handler's entry in ms;
   - ``P3`` an empty prompt (a 400 at submit) dead-lettered to
     ``generate.dlq`` after 3 deliveries (its attempt count in the dead
     letter's metadata, which MQTT 3.1.1 cannot carry), the job behind it
     served once, ``pubsub`` and ``pubsub_consumers`` UP;
   - ``P5`` the 1000-token prompt alone, in turns through the handler and
     through ``submit``: TTFT on the engine's clock, the job's round trip
     and the broker's share (publish to the handler's entry);
   - ``P4`` (Kafka only) the app stopped, three jobs published, a new app
     on the same ``CONSUMER_ID``: each served once, from the committed
     offset, and none of the earlier jobs again;
   per backend a job's round trip p50/p95 (publish to the result read),
   the broker's share, the redelivery latency, the ms of the handler's
   result publish and the phase's flash and bf16 paged launches; it
   prints a ``{"pubsub": ...}`` line; its launches are the ``kernels``
   rows' ``launches_pubsub``; then the files phase, the launch counters
   reset before it, over the port's file systems and their fakes on
   127.0.0.1 (the local file system, S3 and GCS on ``FakeObjectStore``,
   ``MiniFTPServer`` and ``MiniSFTPServer``) and a ``RedisClient`` on the
   port's RESP2 server:
   - ``F-S1`` an HF-layout Llama checkpoint at Llama-3-8B widths and
     ``FILES_S1_DEPTH`` (1) layer (2.54 GB of safetensors, ``config.json``, a BPE
     ``tokenizer.json``) written through the local, S3, GCS and FTP file
     systems and loaded back with ``ServingEngine.from_hf(path, fs=...)``:
     every tensor bit-identical to a plain-path load, the tokenizer round
     trips, and the S3-loaded engine (paged bf16) serves the ten prompts
     token-equal to an engine built from the same params; per backend the
     write and load seconds, GB/s and the host's peak RSS, the
     ``app_file_stats`` counts, and the object stores' ``read_range`` of
     the safetensors header (its bytes and ms);
   - ``F-S2`` one ``App`` over a full-depth paged bf16 engine whose
     ``ctx.redis`` is the RESP2 client and whose ``ctx.file`` is each file
     system in turn (SFTP with its host key pinned): ``POST /batch/{name}``
     reads ``jobs.jsonl`` through ``JSONRowReader``, answers each prompt
     from Redis or (a miss) the engine, caching it with ``PX`` 600000, and
     writes ``results.jsonl``; the first file's ten prompts are ten
     misses, each later file adds one new prompt (one miss, ten hits); the
     results read back equal ``submit`` of each prompt alone (or part
     within ``GAP_TOL``), an all-hit batch admits nothing and launches no
     flash, ``app_redis_stats`` counts equal the commands the server saw,
     each key's ``PTTL`` lies in (0, 600000], migrations record their
     versions in the ``gofr_migrations`` hash, health shows ``redis`` and
     ``file`` UP, a stopped Redis shows DOWN and the handler a 5xx with no
     admission, a wrong pinned fingerprint is refused at ``connect``; per
     backend the jobs' read and results' write ms, a handler's p50 round
     trip and a miss's TTFT through the handler against ``submit``; and
     FTP's and SFTP's MB/s on one 64 MiB blob;
   it prints a ``{"files": ...}`` line; its launches are the ``kernels``
   rows' ``launches_files``. Without the ``cryptography`` package the
   SFTP legs are not built and one line says why; then the stores phase on
   the same weights, the launch counters reset before it: one
   paged int8 engine (the int8 path's config) and the main path's ten
   prompts each alone through ``submit`` as the gold, behind an ``App``
   that serves ``examples_torch/using-datastores``: ``POST /jobs/{id}``
   claims the id (``INSERT ... IF NOT EXISTS``), sets ``job:<id>`` running,
   generates 32 greedy tokens, inserts the job's document in a session
   transaction, writes its usage row and claim state in one logged batch,
   indexes its tokens for search and sets ``job:<id>`` done; a ``* * * *
   * *`` cron job samples ``ctx.tpu.hbm_stats()`` into an
   ``EmbeddedTimeSeries``; the example's migrations record versions 1-3:
   - ``ST1`` the stores are the port's wire clients on its fakes on
     127.0.0.1 (``DynamoDBKVStore`` with SigV4, ``MongoClient``,
     ``CassandraClient``, ``SolrClient``): the ten jobs posted at once
     behind the gate, each job's tokens held to the gold (equal, or parted
     only within ``GAP_TOL``), each document read back with ``find_one``
     equal to its reply, the usage rows summing to the tokens generated,
     every ``job:<id>`` done, a duplicate a 409 with no admission,
     ``GET /search`` for three tokens ranked as an ``EmbeddedSearch`` fed
     the same documents on the host (the fake's BM25 scores equal to the
     host's), each ``app_*_stats`` count equal to the operations its fake
     served, every datasource UP; the 1000-token prompt alone in turns
     through the handler and ``submit``; then the Mongo fake stopped:
     ``document`` DOWN, a job a 5xx after its tokens with its claim row
     and ``"running"`` left behind;
   - ``ST2`` the recorder's points over ST1's jobs: one a second, tagged
     with the card's name, the largest bytes in use between the weights
     plus the KV pool and ``max_memory_allocated``, the limit the card's
     memory, one 1 s bucket of ``max`` a second (within one);
   - ``ST3`` the same App code and jobs over the embedded stores the
     factories pick with no host, a ``FileKVStore`` under a
     ``.chip_smoke_stores_*`` directory and ``EmbeddedSearch``: the tokens,
     documents, rows, KV values and rankings equal ST1's;
   per family the ms of each of the handler's spans (p50/p95), a job's
   round trip and the phase's flash and int8 paged launches (bf16 paged
   none); it prints a ``{"stores": ...}`` line; its launches are the
   ``kernels`` rows' ``launches_stores``; then the analytics phase on the
   same weights, the launch counters reset before it: first
   ``analysis.ffi`` holds every ``extern "C"`` entry of ``csrc/*.cu`` to
   ``_build.SIGNATURES`` (no finding), then, with ``analysis.lockorder``
   installed before the engine and the ``App`` are built, one paged bf16
   engine (the stores phase's settings) and the main path's ten prompts
   each alone through ``submit`` as the gold, behind an ``App`` serving
   ``examples_torch/using-analytics``:
   - ``AN1`` the columnar datasource is the port's ``ClickHouseClient`` on
     ``MiniClickHouseServer`` (127.0.0.1), the graph an ``EmbeddedGraph``;
     the ten jobs of three tenants posted at once behind the gate, each
     generating 32 greedy tokens, writing its usage row with
     ``insert_rows`` and an event row with ``async_insert``, and linking
     tenant → job → result in one ``GraphTxn``; each job's tokens held to
     the gold; ClickHouse's new tokens by tenant (``GET /usage``) equal to
     the engine's ``completion_tokens``; ``GET /lineage/{tenant}`` and
     ``shortest_path`` find every job; the 1000-token prompt alone in
     turns through the handler and ``submit``;
   - ``AN2`` the same records through ``OracleFacade`` (the port's
     sqlite), ``SurrealFacade`` and ``CouchbaseFacade`` (the embedded
     document store) and ``ArangoFacade`` (a document store and a graph),
     each read back equal and each health its backend's, UP;
   - ``AN3`` after a batch of 8 decode rows (ms a step under the shim,
     a record), the shim uninstalled: no lock-order cycle, its runtime
     graph checked with ``lockcheck.check_subgraph`` against the static
     graph of the port's tree (each missing edge printed),
     ``python -m gofr_tpu_torch.analysis --all`` exiting 0, and
     ``chaoscov`` finding every chaos point scheduled by a test of the
     port's chaos tier (``missing`` empty);
   the spans' ms (p50/p95), a job's round trip and the phase's flash and
   bf16 paged launches (int8 paged none); it prints an
   ``{"analytics": ...}`` line; its launches are the ``kernels`` rows'
   ``launches_analytics``; then the grpc phase on the same weights, the
   launch counters reset before it, every call over the port's own HTTP/2,
   HPACK and protobuf wire (``gofr_tpu_torch/grpcx``; no grpcio):
   - ``G1`` an ``App`` with ``GRPC_PORT`` on 127.0.0.1 serving
     ``InferenceService`` over a paged bf16 engine (the bf16 path's
     config): the main path's ten prompts (32 new tokens, one sampled at
     T 0.8, top-k 50, top-p 0.95) as concurrent ``GenerateStream`` calls
     through the port's ``InferenceClient``, the greedy ones held to
     ``engine.submit`` of the same set (equal, or parted only within
     ``GAP_TOL``) under a sync count that must equal the direct set's; the
     1000-token prompt alone in turns: TTFT on the client's clock beside
     the engine's timeline, the gap a token beside ms a step; one
     Generate, one Echo, health SERVING;
   - ``G2`` on G1's engine: a request queued behind the gate whose
     ``grpc-timeout`` lapses is DEADLINE_EXCEEDED with no launch for it;
     ``call.cancel()`` after two frames frees the row's slot and pages
     (ms to release); a shed is RESOURCE_EXHAUSTED with ``retry-delay-s``;
     during drain Generate is UNAVAILABLE while health answers
     NOT_SERVING; reflection lists ``gofr.v1.Inference`` and
     ``grpc.health.v1.Health``; ``x-tenant-id`` is the engine's tenant and
     the server span continues the client's ``traceparent``;
   - ``G3`` an ``App`` with ``PUBSUB_BACKEND=GOOGLE`` against the port's
     google.pubsub.v1 fake on 127.0.0.1 over a paged int8 engine: ten
     generation jobs (the pubsub phase's handler) held to ``submit``, a
     handler fault redelivered, and a job a consumer of the app's group
     pulled and never acknowledged, served by a restarted app once the
     ack deadline (2 s) lapsed; publish-to-result ms and the broker's
     share;
   - ``G4`` a ``CoordinationService`` leader on a ``GRPCServer`` in this
     process and two ``python -m gofr_tpu_torch.distributed.worker_main
     --device cuda`` processes (a bf16 tiny Llama at head dim 64 each):
     both register, requests reach both, one is SIGKILLed, the leader
     marks it SUSPECT then DEAD, bumps the epoch with one shard left, and
     the survivor answers; register-to-ready s, detection ms, each
     worker's launches as it reported them;
   it prints a ``{"grpc": ...}`` line; its launches (this process's and
   the workers') are the ``kernels`` rows' ``launches_grpc``, and this
   process's must include all three kernels; then the parallel phase,
   after the parent released its engines (``torch.cuda.mem_get_info()``
   printed first): one world of four ranks spawned on the one card over
   gloo (``gofr_tpu_torch.parallel.world.run_spmd``; NCCL refuses two ranks
   on one card), every rank making the same weights and inputs from
   ``SEED``, each step held on rank 0 to the same computation unsharded:
   - ``MP1`` ``llama.forward(mesh=)`` at Llama-3-8B widths and
     ``PLANE_DEPTH`` layers on tp=4 and on dp=2,tp=2, two prompts of 1000
     tokens: logits error, greedy agreement, ms a forward, peak memory;
   - ``MP2`` ``ring_attention`` and ``ulysses_attention`` (the flash
     kernel in its middle) on sp=4 at S=8192, H 32, Hkv 8, D 128, against
     the plain causal attention and the flash kernel on the whole
     sequence; then ``llama.forward`` with ``attn_impl="cp"`` at 2 layers,
     S=2048, under each impl;
   - ``MP3`` ``moe.forward(mesh=)`` on ep=4 at Mixtral widths and
     ``MOE_DEPTH`` layers, 4096 tokens, the logits and aux statistics
     against ``mesh=None``; two ``make_moe_train_step`` steps' losses
     against the one-card step's, and rank 0's updates of the router and
     of its experts against the same slices of the one-card update;
   - ``MP4`` ``pp_forward`` on pp=4 at 8B widths, ``PLANE_DEPTH`` layers, 4×512 tokens
     in 4 microbatches;
   - ``MP5`` three steps of ``sharded_train_step`` on dp=2,tp=2 and of
     ``make_pp_train_step`` on pp=2,dp=2 at 8B widths, 2 layers, 4×256
     tokens, the losses against the one-card ``make_train_step``'s; ms a
     step, peak memory per rank;
   - ``MP6`` ``CheckpointManager.restore(sharding=)`` of a 2-layer 8B-wide
     checkpoint by the tp=4 rules: every rank's shards bit-equal to slices
     of the saved tree, which rank 0's whole restore equals bit for bit;
     each rank's host RSS rise below the largest leaf's bytes (which a read
     of any leaf whole would pass);
   - ``MP7`` ``TPUClient`` with ``TPU_MESH="dp=4"`` over the world's ranks,
     a dp-sharded ``flash_attention`` (Llama-3-8B attention widths, 12×512
     tokens) captured on each rank's shard, through the reference's
     sick-chip arc: a fault injected on device 0, two typed 503s, the trip
     that excludes device 0, rebuilds the mesh over dp=3 and retries the
     call to the right result, DEGRADED naming device 0, a mesh-bound
     executable refused after the shrink, the half-open restore to dp=4;
     each result against flash on the whole batch, every rank's checksums
     alike;
   a rank's failure fails the phase; it prints a ``{"parallel": ...}``
   line, and the ranks' flash launches on the paths (Ulysses) are the
   ``kernels`` rows' ``launches_parallel``; then the tp phase, the
   tensor-parallel ``ServingEngine``: the parent computes one card's
   ``llama.prefill`` logits of the main path's 1000-token prompt at full
   depth and frees the weights, then one world of four ranks on the card
   over gloo, each drawing the 8B weights from ``SEED`` leaf by leaf and
   keeping its tp=4 slices (``init_params(mesh=)``); rank 0 holds each
   kernel to its plain version at the local shapes (8 query heads over 2
   KV heads) and its tp ``prefill`` logits to one card's (relative L2 ≤
   ``LOGITS_REL_TOL``), then runs ``ServingEngine(..., mesh=)`` while the
   others run ``serve_follower``: ``TP-B`` on the bf16 path's config behind
   an ``App`` with HTTP and gRPC (the path's ten prompts, then 8
   ``/generate`` and 4 gRPC ``Generate`` calls at once, ``app_ttft_seconds``
   counting all 12) and ``TP-Q`` on the int8 path's (its prompts and the
   3000-token one, chunked); each engine's first tokens equal the one-card
   path's on at least ``TP_FIRST_MIN`` of the 9 greedy prompts (the
   common prefixes printed), every rank's hash of its packed blocks equals
   rank 0's, and every kernel launches on every rank; it prints a
   ``{"tp": ...}`` line, and the ranks' launches are the ``kernels`` rows'
   ``launches_tp``. Both spawning phases first print the parent's
   ``memory_allocated`` before any collection, which must be at most
   ``HELD_MAX_GB``: every phase undoes its engines' patches as it ends
   and drops its stopped engines' KV (``release_engines``), and the
   weights' trees are emptied where their last phase ends
   (``drop_weights``), so nothing a stray reference cycle holds keeps
   device memory;
4. time each kernel, its plain version and a PyTorch library call for the
   same function, beside the least time the card could take (its bound),
   at the main path's shapes; then, for information, flash at S=2048 and
   each paged kernel on the lone 4000-token row, each beside its bound,
   and each paged wrapper's host time per call; the wall and kernel time
   of one decode block of each layout (bf16 and int8 weights on the dense
   cache); and time each engine path (TTFT, ms per decode step).

The analyzers' runtime twins ride the phases above, and each prints its
result and the seconds it added:

- ``K``: on each of the four main paths, after its timings (which it
  leaves as they were), and on the spec engines of ``S1`` and ``S2``,
  after their records: the path's prompts twice, greedy, each set
  admitted in one plan step behind a gate, bare and then under
  ``analysis.kerneltrace.KernelObserver``; ``check_kernel_table`` of the
  observed export is empty, every entry of ``K_EXPECT`` for that engine is
  observed, and each kernel launches as often observed as bare; each
  entry's distinct signatures and both passes' ms a step are recorded;
- ``L``: ``analysis.leaktrace`` installed before the lifecycle phase builds
  its first engine; after it stopped them, nothing is live and
  ``leakcheck.check_coverage`` is empty; acquires and releases by kind;
- ``D``: ``analysis.deadlinetrace`` over the HA and fleet phases: no budget
  widened, none negative, ``check_deadline_coverage`` empty, every
  boundary of ``D_EXPECT`` crossed; the crossings by site.

They print as an ``{"analysis": ...}`` line after the card's line. The
line before the last is the ``kernels`` record; the last line is the
contract line ``{"ok": true, "device": {...}}``. Without a card, or run
outside a checkout that holds ``gofr_tpu_torch/``, it exits non-zero and
prints no result. Imports nothing of JAX or of ``gofr_tpu``.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import inspect
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0  # weights, prompts and kernel inputs all derive from it

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain version, per output row (one query head of one token):
# max|got - ref| / max|ref| over the head dim. A one-step bf16 flip of any
# element is at most 2^-7 of the row's largest value; flash adds the
# rounding of P to bf16 against a different running max. 2^-6 is two
# steps, whatever the row's magnitude (late rows of a long prompt are ~30x
# smaller than early ones, so an absolute limit would not see them). The
# int8 kernel and its plain version dequantize the same int8 values with
# the same scales in f32, so only the output's rounding differs.
FLASH_ROW_TOL = 2.0 ** -6
PAGED_ROW_TOL = 2.0 ** -6
LOGITS_REL_TOL = 5e-2  # relative L2 of bf16 logits through 32 layers
PAGED_CHECK_LENS = [0, 1, 15, 17, 1000, 333, 64, 999]  # kernel check lengths
# lengths ending exactly on a split span of the paged kernels (256 tokens)
# and one past it, besides the edges above
SPAN_CHECK_LENS = [0, 1, 17, 256, 257, 512, 513, 999]
LONE_ROW = 4000  # one long request alone (B=1): split across 16 spans
FLASH_CHECK_S = (32, 128, 200, 1024, 2048)
MAIN_LENS = [5, 31, 60, 120, 250, 480, 777, 1000, 9, 333]  # the bf16 path's prompts
LONG_PROMPT = 3000  # the int8 path's extra prompt, past the largest bucket (2048)
# the bf16 and int8 paths' engine configs; the tp phase's TP-B and TP-Q mirror them. bf16: a
# chunk of 2048 keeps every prompt up to the largest bucket monolithic; int8: the reference's
# 256-token chunks
MAIN_ENGINES = {
    "bf16": dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                 max_new_tokens_default=32, prefill_chunk_tokens=2048),
    "int8": dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32, multi_step=4,
                 max_new_tokens_default=32, prefill_chunk_tokens=256, kv_dtype="int8"),
}
MAIN_TOKENS: dict = {}  # each main path's tokens by prompt, for the tp phase


# the main path's kernel instantiations, as ptxas names them (mangled):
# flash at D=128; the paged template at Dh=128, G=4 over bf16 (t) and int8 (a)
PATH_INSTANCES = {
    "flash_attention": {"flash D=128": "flash_fwd_kernelILi128EE"},
    "paged_attention": {"paged bf16 Dh=128 G=4": "paged_decode_kernelILi128ELi4EtEE",
                        "paged int8 Dh=128 G=4": "paged_decode_kernelILi128ELi4EaEE"},
}


def start_ptxas(build) -> dict:
    """Start one ``nvcc -Xptxas -v -c`` per source (with the build's own
    flags), beside the build; ``ptxas_report`` collects them."""
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return {name: subprocess.Popen(
        [build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(build.BUILD_DIR / f"{name}.ptxas.o"),
         str(build.CSRC / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in PATH_INSTANCES}


def ptxas_report(jobs: dict) -> dict:
    """Registers, spills and static shared memory of each main-path kernel
    instantiation, from ptxas's report; any note that wgmma was serialized
    fails the run's build phase."""
    report = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for csrc/{name}.cu:\n{out}")
        current, stats = None, {}
        for line in out.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w]+)", line)
            if m:
                current = m.group(1)
            elif current and "spill stores" in line:
                n = re.findall(r"(\d+) bytes", line)
                stats.setdefault(current, {}).update(stack=int(n[0]), spill_stores=int(n[1]),
                                                    spill_loads=int(n[2]))
            elif current and "Used" in line and "registers" in line:
                stats.setdefault(current, {}).update(
                    registers=int(re.search(r"Used (\d+) registers", line).group(1)),
                    static_smem=int(re.search(r"(\d+) bytes smem", line).group(1)))
            if "wgmma.mma_async instructions are serialized" in line:
                raise RuntimeError(f"csrc/{name}.cu: {line.strip()}")
        for label, key in PATH_INSTANCES[name].items():
            found = [v for k, v in stats.items() if key in k]
            if len(found) != 1:
                raise RuntimeError(f"ptxas report of csrc/{name}.cu has no single {key}")
            report[label] = found[0]
            print(f"ptxas {label}: {found[0]}")
    return report


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call by CUDA events: the median of ``iters``
    calls after a warm-up (``last`` keeps their mean and minimum beside
    it), with the 50 MB L2 flushed before each call so every input is read
    from HBM as on the serving path. After the flush the card sleeps about
    a millisecond (``torch.cuda._sleep``), so the host has queued the call
    before its start event runs: the time is the device's, not the host's
    launch overhead (a wrapper's checks and allocations can take longer
    than the flush alone). The median, not the mean: one call that waits
    on a stalled host cannot move a row."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        self.last: dict = {}

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        fn()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        self.last = {"median": statistics.median(times), "mean": sum(times) / iters,
                     "min": times[0]}
        return self.last["median"]

    def stats(self, fn, iters: int = 10) -> dict:
        """The row keys of one timing: ``ms`` the median, with the mean and
        the minimum of the same calls."""
        ms = self(fn, iters)
        return {"ms": ms, "ms_mean": self.last["mean"], "ms_min": self.last["min"]}


def row_rel_err(got, want) -> float:
    """Largest per-row error relative to the row's own scale,
    max|got - ref| / max|ref| over the last axis; a row whose reference is
    all zero must be exactly zero (else the error is infinite)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    scale = w.abs().amax(-1)
    if bool((err[scale == 0] != 0).any()):
        return math.inf
    return (err[scale > 0] / scale[scale > 0]).max().item()


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def counters() -> dict:
    """Each kernel wrapper of the port by name; ``.launches`` is its count."""
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_q

    return {"flash_attention": flash_attention, "paged_decode_attention": paged_decode_attention,
            "paged_decode_attention_q": paged_decode_attention_q}


# ------------------------------------------------------------- kernel inputs
def flash_inputs(torch, gen, S: int, kv_lens: list[int], H=32, Hkv=8, D=128, device="cuda"):
    B = len(kv_lens)
    q = torch.randn((B, S, H, D), generator=gen, device=device, dtype=torch.bfloat16)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=device, dtype=torch.bfloat16)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=device, dtype=torch.bfloat16)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device=device)
    return q, k, v, kv_len


def paged_inputs(torch, gen, seq_lens: list[int], H=32, Hkv=8, Dh=128, page=16, device="cuda"):
    """A pool with every sequence's pages scattered at shuffled ids, plus
    spare pages, a trash page, and table tails filled with other ids."""
    B = len(seq_lens)
    M = max(1, max(math.ceil(s / page) for s in seq_lens))
    n_used = sum(math.ceil(s / page) for s in seq_lens)
    N = n_used + 32 + 1
    perm = torch.randperm(N - 1, generator=gen, device=device).to(torch.int32)
    tables = torch.empty((B, M), dtype=torch.int32, device=device)
    pos = 0
    for b, s in enumerate(seq_lens):
        n = math.ceil(s / page)
        tables[b, :n] = perm[pos:pos + n]
        tables[b, n:] = perm[(pos + n) % (N - 1)]  # unused columns: any id
        pos += n
    k_pool = torch.randn((N, Hkv, page, Dh), generator=gen, device=device, dtype=torch.bfloat16)
    v_pool = torch.randn((N, Hkv, page, Dh), generator=gen, device=device, dtype=torch.bfloat16)
    q = torch.randn((B, H, Dh), generator=gen, device=device, dtype=torch.bfloat16)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=device)
    return q, k_pool, v_pool, tables, lens


def paged_inputs_q(torch, gen, seq_lens: list[int], page: int, **shape):
    """``paged_inputs`` with the pools quantized per vector as the engine
    stores them: (q, k_pool, v_pool int8, k_scale, v_scale, tables, lens)."""
    from gofr_tpu_torch.models.llama import quantize_kv

    q, kp, vp, tables, lens = paged_inputs(torch, gen, seq_lens, page=page, **shape)
    kq, ks = quantize_kv(kp * 3)  # scales far from 1: a wrong scale shows
    vq, vs = quantize_kv(vp)
    return q, kq, vq, ks[..., None].contiguous(), vs[..., None].contiguous(), tables, lens


def check_kernels(torch, gen) -> dict:
    """Each kernel against its plain version; returns, per kernel, its
    largest absolute and per-row relative errors over the cases."""
    from gofr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from gofr_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_q,
        paged_decode_attention_ref,
    )

    errs = {n: {"max_abs_err": 0.0, "max_row_rel_err": 0.0} for n in counters()}

    def record(name, got, want, zero_row, tol, what):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        print(f"{what}: max_abs_err={err:.3e}, max row_rel_err={rel:.3e} (tol {tol:.3e}), "
              f"empty row max |out|={zero_row}")
        if not (rel <= tol) or zero_row != 0.0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: the kernel disagrees with its plain version")
        e = errs[name]
        e["max_abs_err"], e["max_row_rel_err"] = max(e["max_abs_err"], err), max(e["max_row_rel_err"], rel)

    for S in FLASH_CHECK_S:
        # kv_len full, odd (S - 7), off every tile edge (S // 3 + 1), and 0;
        # H=8 at 2048 keeps the dense plain version small
        kv_lens = [S, max(1, S - 7), S // 3 + 1, 0]
        H, Hkv = (32, 8) if S <= 1024 else (8, 2)
        for D in (64, 128):
            for causal in (True, False):
                q, k, v, kv_len = flash_inputs(torch, gen, S, kv_lens, H=H, Hkv=Hkv, D=D)
                got = flash_attention(q, k, v, kv_len, causal=causal)
                want = flash_attention_ref(q, k, v, kv_len, causal=causal)
                record("flash_attention", got, want, got[3].float().abs().max().item(),
                       FLASH_ROW_TOL, f"flash S={S} H={H} Hkv={Hkv} D={D} causal={int(causal)} "
                       f"kv_len={kv_lens}")
    # (lengths, H, Hkv, Dh): G = 4 at the model's widths, G = 8 at Dh 64
    paged_cases = [(PAGED_CHECK_LENS, 32, 8, 128), (SPAN_CHECK_LENS, 32, 8, 128),
                   ([LONE_ROW], 32, 8, 128), (SPAN_CHECK_LENS, 16, 2, 64)]
    for page in (16, 32):
        for lens_, H, Hkv, Dh in paged_cases:
            shape = dict(H=H, Hkv=Hkv, Dh=Dh)
            empty = lens_.index(0) if 0 in lens_ else None
            what = f"seq_lens={lens_ if len(lens_) > 1 else lens_[0]} H={H} Hkv={Hkv} Dh={Dh} page={page}"
            q, kp, vp, tables, lens = paged_inputs(torch, gen, lens_, page=page, **shape)
            got = paged_decode_attention(q, kp, vp, tables, lens)
            want = paged_decode_attention_ref(q, kp, vp, tables, lens)
            record("paged_decode_attention", got, want,
                   0.0 if empty is None else got[empty].float().abs().max().item(), PAGED_ROW_TOL,
                   f"paged bf16 {what}")
            q, kq, vq, ks, vs, tables, lens = paged_inputs_q(torch, gen, lens_, page, **shape)
            got = paged_decode_attention_q(q, kq, vq, ks, vs, tables, lens)
            want = paged_decode_attention_ref(q, kq, vq, tables, lens, k_scale=ks, v_scale=vs)
            record("paged_decode_attention_q", got, want,
                   0.0 if empty is None else got[empty].float().abs().max().item(), PAGED_ROW_TOL,
                   f"paged int8 {what}")
    return errs


# ------------------------------------------------------------------ timings
DECODE_LENS = [21, 47, 76, 136, 266, 496, 793, 1016]  # the decode batch mid-generation


def time_kernels(torch, gen, timer: Timer, errs: dict, launches: dict) -> list[dict]:
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from gofr_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_q,
        paged_decode_attention_ref,
    )

    rows = []
    # flash: the main path's largest bucket, one full 1024-token prompt
    S, H, Hkv, D = 1024, 32, 8, 128
    q, k, v, kv_len = flash_inputs(torch, gen, S, [S])
    pairs = S * (S + 1) // 2  # causal (query, key) pairs this input needs
    flops = 4 * H * D * pairs
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4
    b_ms, b_by = bound_ms(flops, nbytes)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "gofr_tpu_torch/csrc/flash_attention.cu",
        "replaces": "gofr_tpu/ops/flash_attention.py:40",
        "launches": launches["bf16"]["flash_attention"],
        **errs["flash_attention"],
        **timer.stats(lambda: flash_attention(q, k, v, kv_len)),
        "plain_ms": timer(lambda: flash_attention_ref(q, k, v, kv_len), iters=3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        "shape": f"B=1 S={S} H={H} Hkv={Hkv} D={D} kv_len={S} bf16",
        "launches_by_path": {p: c["flash_attention"] for p, c in launches.items()},
    })

    # paged, bf16 and int8: the main path's decode batch, 8 rows mid-generation
    tokens = sum(DECODE_LENS)

    def paged_row(name, source, page, kv_bytes, quantized):
        if quantized:
            q, kp, vp, ks, vs, tables, lens = paged_inputs_q(torch, gen, DECODE_LENS, page)
            args, kw = (q, kp, vp, ks, vs, tables, lens), {"k_scale": ks, "v_scale": vs}
            kernel, plain_args = paged_decode_attention_q, (q, kp, vp, tables, lens)
        else:
            q, kp, vp, tables, lens = paged_inputs(torch, gen, DECODE_LENS, page=page)
            args = plain_args = (q, kp, vp, tables, lens)
            kw, kernel = {}, paged_decode_attention
        Bp, Hp, Dh = q.shape
        flops = 4 * Hp * Dh * tokens
        nbytes = 2 * 8 * kv_bytes * tokens + 2 * q.numel() * 2 + tables.numel() * 4 + lens.numel() * 4
        b_ms, b_by = bound_ms(flops, nbytes)
        M = tables.shape[1]
        mask = (torch.arange(M * page, device="cuda")[None, :] < lens[:, None])[:, None, None, :]

        def gathered_sdpa():
            t = tables.long()
            kd = kp[t].permute(0, 2, 1, 3, 4).reshape(Bp, 8, M * page, Dh)
            vd = vp[t].permute(0, 2, 1, 3, 4).reshape(Bp, 8, M * page, Dh)
            if quantized:
                kd = (kd.float() * ks[t].permute(0, 2, 1, 3, 4).reshape(Bp, 8, M * page, 1)).to(q.dtype)
                vd = (vd.float() * vs[t].permute(0, 2, 1, 3, 4).reshape(Bp, 8, M * page, 1)).to(q.dtype)
            return F.scaled_dot_product_attention(
                q[:, :, None, :], kd.repeat_interleave(Hp // 8, dim=1),
                vd.repeat_interleave(Hp // 8, dim=1), attn_mask=mask,
            )

        path = "int8" if quantized else "bf16"
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": "gofr_tpu/ops/paged_attention.py:90",
            "launches": launches[path][name],
            **errs[name],
            **timer.stats(lambda: kernel(*args)),
            "plain_ms": timer(lambda: paged_decode_attention_ref(*plain_args, **kw)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(gathered_sdpa),
            "shape": f"B=8 H=32 Hkv=8 Dh=128 page={page} seq_lens={DECODE_LENS} "
                     + ("int8 pools + f32 scales" if quantized else "bf16"),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
        }

    rows.append(paged_row("paged_decode_attention", "gofr_tpu_torch/csrc/paged_attention.cu",
                          16, 128 * 2, quantized=False))
    rows.append(paged_row("paged_decode_attention_q", "gofr_tpu_torch/csrc/paged_attention.cu",
                          32, 128 + 4, quantized=True))
    return rows


def wrapper_host_us(torch, gen, calls: int = 200) -> dict:
    """Host time of one call of each paged wrapper (its checks, buffers and
    launch), in microseconds: the median over 5 rounds of ``calls`` calls
    at the main path's decode batch, with no synchronize between calls.
    It calls only the wrappers' public signatures, so it can time another
    checkout's package too (import that package first)."""
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_q

    out = {}
    for name, fn, args in (
        ("paged_decode_attention", paged_decode_attention, paged_inputs(torch, gen, DECODE_LENS, page=16)),
        ("paged_decode_attention_q", paged_decode_attention_q, paged_inputs_q(torch, gen, DECODE_LENS, 32)),
    ):
        fn(*args)
        torch.cuda.synchronize()
        rounds = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*args)
            rounds.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        out[name] = sorted(rounds)[2]
    print("(information) paged wrapper host us per call: "
          + ", ".join(f"{n} {us:.2f}" for n, us in out.items()))
    return out


def time_information(torch, gen, timer: Timer) -> dict:
    """Kernel times outside the main path's shapes, each beside its bound,
    for information: flash on the largest bucket (S=2048) against
    ``scaled_dot_product_attention``, and each paged kernel on one
    4000-token row alone (B=1, split across blocks)."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_q

    info = {}
    S, H, Hkv, D = 2048, 32, 8, 128
    q, k, v, kv_len = flash_inputs(torch, gen, S, [S])
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    b_ms, b_by = bound_ms(4 * H * D * S * (S + 1) // 2, 2 * (2 * q.numel() + k.numel() + v.numel()))
    info["flash_attention_S2048"] = {
        "ms": timer(lambda: flash_attention(q, k, v, kv_len)), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        "shape": f"B=1 S={S} H={H} Hkv={Hkv} D={D} causal bf16"}
    del q, k, v, qt, kt, vt
    for name, page, kv_bytes in (("paged_decode_attention", 16, 128 * 2),
                                 ("paged_decode_attention_q", 32, 128 + 4)):
        if name.endswith("_q"):
            args = paged_inputs_q(torch, gen, [LONE_ROW], page)
            fn = paged_decode_attention_q
        else:
            args = paged_inputs(torch, gen, [LONE_ROW], page=page)
            fn = paged_decode_attention
        b_ms, b_by = bound_ms(4 * 32 * 128 * LONE_ROW, 2 * 8 * kv_bytes * LONE_ROW + 2 * 2 * 32 * 128)
        info[f"{name}_lone{LONE_ROW}"] = {
            "ms": timer(lambda: fn(*args)), "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B=1 H=32 Hkv=8 Dh=128 page={page} seq_len={LONE_ROW}"}
    for n, r in info.items():
        lib = f", library {r['library_ms']:.4f}" if "library_ms" in r else ""
        print(f"(information) {n}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}"
              f"{lib}) at {r['shape']}")
    info["paged_wrapper_host_us"] = wrapper_host_us(torch, gen)
    return info


def kernel_label(key: str) -> str:
    """A profiler kernel name cut short: its head (up to 48 characters)
    and, for PyTorch's templated elementwise kernels, whose heads all look
    alike, the operation inside (``direct_copy_kernel_cuda``, a
    ``...Functor``)."""
    name = key.replace("void ", "").replace("(anonymous namespace)::", "")
    head = name.split("(")[0].split("<")[0][:48]
    ops = re.findall(r"(\w+_kernel_cuda|\w+Functor)\b", key)
    return f"{head} {ops[-1]}" if ops else head


def dispatch_busy(torch, cfg, params, params_w8) -> dict:
    """Where a dispatch's time goes: host wall time of one call of the
    engine's device functions, synchronized (median of 5), against the sum
    of the kernel times ``torch.profiler`` records for one more call. The
    rest of the wall time the card sits idle, waiting for the host to
    issue work. Cases: the N-step decode block at batch 8 (512 tokens of
    context a row) over bf16 and int8 pools, and a ragged dispatch that
    runs one 256-token chunk alone (the fourth chunk of a 1000-token
    prompt, as the int8 path's TTFT runs it); then the dense decode block
    at the same batch and context over the dense paths' caches: bf16 KV
    at 2048 positions with bf16 and with int8 weights (their difference is
    what the weights' eager int8-to-bf16 copies cost), and int8 KV at 4096
    positions with int8 weights."""
    from torch.profiler import ProfilerActivity, profile

    from gofr_tpu_torch.serving import batch as batch_ops
    from gofr_tpu_torch.serving.kv_cache import PagedKVCache

    B, N, ctx, C = 8, 4, 512, 256
    dev = params["embedding"].device
    out = {}

    def measure(name, call):
        call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
        wall = sorted(walls)[2]
        by_label: dict = {}
        for e in events:
            label = kernel_label(e.key)
            by_label[label] = by_label.get(label, 0.0) + e.self_device_time_total / 1e3
        top = sorted(by_label.items(), key=lambda kv: -kv[1])[:6]
        out[name] = {"wall_ms": wall, "kernel_ms": kernel_ms or None,
                     "device_busy_share": kernel_ms / wall if kernel_ms else None,
                     "top_kernels_ms": dict(top)}
        print(f"  {name}: wall {wall:.2f} ms, kernels {kernel_ms:.2f} ms "
              f"(busy share {kernel_ms / wall:.3f}); top: "
              + ", ".join(f"{k} {v:.2f}" for k, v in out[name]["top_kernels_ms"].items()))

    def state(lens):
        return batch_ops.make_decode_state(
            [7] * B, lens, [False] * B, [10_000] * B, [-1] * B, [0.0] * B, [0] * B,
            [1.0] * B, torch.Generator(device=dev).manual_seed(SEED), device=dev)

    active = torch.ones(B, dtype=torch.bool, device=dev)
    for kv_dtype, page in (("bf16", 16), ("int8", 32)):
        cap = 4 * C + 64  # pages for a 1000-token prompt's fourth chunk, and decode room
        pc = PagedKVCache(cfg, num_pages=B * cap // page, page_size=page, max_slots=B,
                          max_seq_len=cap, device=dev, kv_dtype=kv_dtype)
        for b in range(B):
            pc.alloc_slot(b, seq_id=b, prompt_len=ctx, reserve_tokens=cap)
        tables = pc.tables_device()
        fn = batch_ops.decode_block_paged_q if pc.quantized else batch_ops.decode_block_paged
        pools = pc.pools() if pc.quantized else pc.pools()[:2]
        measure(f"decode_block_{kv_dtype}_b8_n4",
                lambda: fn(cfg, params, *pools, state([ctx] * B), tables, active, N)[0].cpu())
        if pc.quantized:
            chunk = torch.randint(3, cfg.vocab_size, (B, C), device=dev)
            i32 = dict(dtype=torch.int32, device=dev)
            zeros = torch.zeros(B, **i32)
            measure("ragged_int8_one_256_chunk", lambda: batch_ops.ragged_step_paged_q(
                cfg, params, *pools, state([1] * B), tables, chunk,
                torch.full((B,), 3 * C, **i32), torch.tensor([0], device=dev),
                torch.full((B,), cap, **i32), torch.zeros(B, dtype=torch.bool, device=dev),
                torch.full((B,), 4 * C, **i32), zeros, torch.full((B,), -1, device=dev),
                torch.zeros(B, device=dev), torch.zeros(B, dtype=torch.int64, device=dev),
                torch.ones(B, device=dev), [SEED], torch.zeros(B, dtype=torch.bool, device=dev), 0,
            )[0].cpu())
        for b in range(B):
            pc.free_slot(b)
        del pc, pools
    from gofr_tpu_torch.models.llama import KVCache

    for kv_dtype, S, weights, tree in ((None, 2048, "bf16", params), (None, 2048, "int8", params_w8),
                                       ("int8", 4096, "int8", params_w8)):
        cache = KVCache.create(cfg, B, max_len=S, kv_dtype=kv_dtype, device=dev)
        measure(f"dense_block_{kv_dtype or 'bf16'}_kv{S}_{weights}_weights_b8_n4",
                lambda: batch_ops.decode_block(cfg, tree, cache, state([ctx] * B), active, N)[0].cpu())
        del cache
    return out


# ------------------------------------------------------------------- engine
def dense_logits(torch, cfg, params, ids: list[int], n_last: int, kv_quant: bool):
    """A plain dense forward of the same weights (no kernel, no cache):
    f32 logits [n_last, V] at the last ``n_last`` positions of ``ids``.
    With ``kv_quant`` every layer's K/V pass through ``quantize_kv`` and
    ``dequantize_kv`` first, as everything the int8 engine reads does."""
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.attention import attention
    from gofr_tpu_torch.ops.rope import rope_table

    dev = params["embedding"].device
    tokens = torch.tensor([ids], device=dev)
    S = len(ids)
    x = params["embedding"][tokens].to(cfg.dtype)
    positions = torch.arange(S, device=dev)[None]
    sin, cos = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    for layer in range(cfg.n_layers):
        lp = llama.layer_params(params, layer)
        _, q, k, v = llama._qkv(cfg, x, lp, sin, cos, positions)
        if kv_quant:
            k = llama.dequantize_kv(*llama.quantize_kv(k), cfg.dtype)
            v = llama.dequantize_kv(*llama.quantize_kv(v), cfg.dtype)
        x = llama._attn_mlp_epilogue(cfg, x, lp, attention(q, k, v, causal=True))
    return llama._logits(cfg, params, x[:, -n_last:])[0]


def ragged_name(engine) -> str:
    """The ragged dispatch function the engine's layout and KV dtype run."""
    if engine.paged_cache is None:
        return "ragged_step"
    return "ragged_step_paged_q" if engine.paged_cache.quantized else "ragged_step_paged"


def decode_step_spy(engine, decode_seen: list):
    """A stand-in for the engine layout's decode step that records each
    step's (live rows, logits) and runs the real one; returns (name, real
    function, spy)."""
    from gofr_tpu_torch.models import llama

    dense = engine.paged_cache is None
    quantized = (engine.cache if dense else engine.paged_cache).quantized
    name = "decode_step" if dense else ("decode_step_paged_q" if quantized else "decode_step_paged")
    step_fn = getattr(llama, name)

    def step_hook(*args, **kw):
        out = step_fn(*args, **kw)
        # a dense step's frozen rows run at length S_max + 1; a paged step
        # takes its live rows as its last argument
        live = args[4] <= args[3].max_len if dense else args[-1]
        decode_seen.append((live.clone(), out[0].clone()))  # (live rows, logits)
        return out

    return name, step_fn, step_hook


def hold_to_dense(torch, engine, ids: list[int], r, first_logits, decode_seen: list, steps: int,
                  what: str, delta=None) -> None:
    """Hold the logits the engine computed for one request served alone
    (``first_logits`` [1, V] for its first token, then each of its first
    ``steps`` decode steps') against one dense forward over the prompt and
    the tokens the engine generated; its tokens must be the argmax of its
    own logits. With ``delta`` (a LoRA row) both sides add the adapter's
    delta of the token each position forwarded: ``delta(tokens)`` gives
    (the delta from the engine's device tables, ``emb[t] @ A @ B`` from
    the adapter's host factors). Prints the outcome; raises on a
    disagreement."""
    cfg, params = engine.model_cfg, engine.params
    quantized = (engine.cache if engine.paged_cache is None else engine.paged_cache).quantized
    live_steps = [(live, lg) for live, lg in decode_seen if bool(live.any())][:steps]
    rows = {tuple(live.nonzero()[:, 0].tolist()) for live, _ in live_steps}
    if len(live_steps) != steps or len(rows) != 1 or len(next(iter(rows))) != 1:
        raise AssertionError(f"expected {steps} decode steps with one live row, saw {rows}")
    (row,) = next(iter(rows))
    got = torch.cat([first_logits[-1:]] + [lg[row:row + 1] for _, lg in live_steps])  # [steps+1, V]
    seq = ids + r.token_ids[:steps]
    want = dense_logits(torch, cfg, params, seq, steps + 1, kv_quant=quantized)
    d_want = 0
    if delta is not None:
        # the logits of position i came from forwarding seq[len(ids) - 1 + i]
        d_got, d_want = delta(seq[len(ids) - 1:])
        got, want = got + d_got, want + d_want
        what += ", with the adapter's delta"
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
    picked = got.argmax(-1).tolist() == r.token_ids
    dense_agree = sum(int(a == b) for a, b in zip(want.argmax(-1).tolist(), r.token_ids))
    print(f"  engine logits vs dense forward{' (K/V quantized)' if quantized else ''} "
          f"({len(ids)}-token prompt, {what}, slot {row}): rel_l2 first token {rel[0]:.3e}, "
          f"decode steps {' '.join(f'{x:.3e}' for x in rel[1:])} (tol {LOGITS_REL_TOL}); tokens = "
          f"argmax of the engine's logits: {picked}; dense argmax agrees on {dense_agree}/{steps + 1}")
    if quantized:  # information only: how far int8 KV moves the logits
        plain = dense_logits(torch, cfg, params, seq, steps + 1, kv_quant=False) + d_want
        rel_plain = ((got - plain).norm(dim=-1) / plain.norm(dim=-1)).tolist()
        print(f"  (information) engine int8 logits vs the unquantized dense forward: rel_l2 "
              f"{' '.join(f'{x:.3e}' for x in rel_plain)}")
    if not (max(rel) <= LOGITS_REL_TOL) or not picked or not bool(torch.isfinite(got).all()):
        raise AssertionError("the engine's logits disagree with the dense forward")


def check_engine_logits(torch, engine, ids: list[int], steps: int, delta=None, **submit_kw) -> None:
    """Serve one greedy request alone and hold the logits the engine itself
    computed for it against one dense forward over the prompt and the
    tokens the engine generated: the prefill's (a prompt of at most one
    chunk: one bucketed flash prefill) or the final chunk's (a longer one:
    chunks through the ragged dispatch, the first token folded on the
    device), then each of its first ``steps`` decode steps' (K/V written in
    place into the slot row, the frozen rows' writes sent to the sink past
    the dense cache's end; or through the block tables, the idle rows'
    writes sent to the trash page, the paged kernel)."""
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving import batch as batch_ops

    chunked = engine._route_chunked(len(ids))
    # (function whose logits are the prompt's, index of those logits in its result)
    pre_name, pre_idx = (ragged_name(engine), 1) if chunked else ("prefill_compute", 0)
    prefill_seen, decode_seen = [], []
    prefill_fn = getattr(batch_ops, pre_name)
    step_name, step_fn, step_hook = decode_step_spy(engine, decode_seen)

    def prefill_hook(*args, **kw):
        out = prefill_fn(*args, **kw)
        prefill_seen.append(out[pre_idx].clone())
        return out

    setattr(batch_ops, pre_name, prefill_hook)
    setattr(llama, step_name, step_hook)
    try:
        r = engine.submit(ids, max_new_tokens=steps + 1, **submit_kw).result(timeout=600)
    finally:
        setattr(batch_ops, pre_name, prefill_fn)
        setattr(llama, step_name, step_fn)
    n_prefill = math.ceil(len(ids) / engine._chunk_tokens) if chunked else 1
    if r.finish_reason != "length" or len(r.token_ids) != steps + 1 or len(prefill_seen) != n_prefill:
        raise AssertionError(f"the logits check request ended {r.finish_reason} after "
                             f"{len(r.token_ids)} tokens and {len(prefill_seen)} prefill calls")
    what = f"{n_prefill} prefill call(s), first token from the " + ("final chunk" if chunked else "prefill")
    hold_to_dense(torch, engine, ids, r, prefill_seen[-1], decode_seen, steps, what, delta)


def serve_path(torch, cfg, params, name: str, ecfg, lens: list[int], must: set, must_not: set,
               logits_prompt: int, logits_steps: int, ttft_lens: tuple) -> tuple[dict, dict]:
    """Drive one engine path: a warm-up, then the path's requests with the
    launch counters reset just before and read just after, then the
    logits check and the timings. Returns (launches, timings)."""
    from gofr_tpu_torch import ServingEngine
    from gofr_tpu_torch.serving import batch as batch_ops
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    engine = ServingEngine(cfg, params, ecfg, ByteTokenizer(cfg.vocab_size), seed=SEED)
    rng = torch.Generator().manual_seed(SEED)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    layout = "dense" if engine.paged_cache is None else f"paged page={ecfg.kv_page_size}"
    weights = "int8" if isinstance(params["lm_head"], dict) else "bf16"
    print(f"engine path {name}: {layout} kv_dtype={ecfg.kv_dtype} weights={weights} "
          f"max_seq_len={ecfg.max_seq_len} chunk={engine._chunk_tokens} tokens; prompts {lens}, "
          f"chunked: {[n for n in lens if engine._route_chunked(n)]}")
    ragged_fn = getattr(batch_ops, ragged_name(engine))
    ragged_calls = [0]

    def count_ragged(*args, **kw):
        ragged_calls[0] += 1
        return ragged_fn(*args, **kw)

    engine.start()
    try:
        engine.submit(prompt(5), max_new_tokens=4).result(timeout=600)  # warm-up
        prompts = [prompt(n) for n in lens]
        # ---- the path: counters from 0, read right after
        kernels = counters()
        setattr(batch_ops, ragged_fn.__name__, count_ragged)
        for fn in kernels.values():
            fn.launches = 0
        try:
            futs = [
                engine.submit(p, max_new_tokens=32,
                              **(dict(temperature=0.8, top_k=50, top_p=0.95) if i == 3 else {}))
                for i, p in enumerate(prompts)
            ]
            results = [f.result(timeout=900) for f in futs]
        finally:
            launches = {n: fn.launches for n, fn in kernels.items()}
            setattr(batch_ops, ragged_fn.__name__, ragged_fn)
        MAIN_TOKENS[name] = [r.token_ids for r in results]
        for n, r in zip(lens, results):
            print(f"  prompt {n:4d} -> {r.completion_tokens:2d} tokens, {r.finish_reason}, "
                  f"ttft {r.ttft_s * 1e3:.1f} ms")
            if r.finish_reason not in ("length", "stop") or r.prompt_tokens != n:
                raise AssertionError(f"request with a {n}-token prompt ended {r.finish_reason}")
            if r.finish_reason == "length" and r.completion_tokens != 32:
                raise AssertionError("a length finish must carry 32 tokens")
            if any(not (0 <= t < cfg.vocab_size) for t in r.token_ids):
                raise AssertionError("token id outside the vocabulary")
        n_chunks = sum(math.ceil(n / engine._chunk_tokens) for n in lens if engine._route_chunked(n))
        print(f"  launches on path {name}: {launches}; ragged dispatches {ragged_calls[0]} "
              f"(chunks of the chunked prompts: {n_chunks})")
        if ragged_calls[0] < n_chunks or ragged_calls[0] > 0 and not n_chunks:
            raise AssertionError(f"path {name}: {ragged_calls[0]} ragged dispatches for {n_chunks} chunks")
        if not all(launches[n] for n in must) or any(launches[n] for n in must_not):
            raise AssertionError(f"path {name}: launches {launches}; must launch {sorted(must)}, "
                                 f"must not launch {sorted(must_not)}")

        check_engine_logits(torch, engine, prompt(logits_prompt), logits_steps)

        # ---- timings: TTFT alone, then a full batch of decode rows
        timings = {}
        for n in ttft_lens:
            r = engine.submit(prompt(n), max_new_tokens=2).result(timeout=600)
            timings[f"ttft_ms_prompt{n}_alone"] = r.ttft_s * 1e3
        batch = [engine.submit(prompt(20), max_new_tokens=65) for _ in range(8)]
        res = [f.result(timeout=900) for f in batch]
        per_step = sorted((r.duration_s - r.ttft_s) / (r.completion_tokens - 1) * 1e3 for r in res
                          if r.completion_tokens > 1)
        timings["decode_ms_per_step_batch8"] = per_step[len(per_step) // 2] if per_step else None
        timings["main_path_ttft_ms_max"] = max(r.ttft_s for r in results) * 1e3
        # K: after the timings, which it leaves as they were, over the ten
        # main prompts (the long prompt adds chunks, not entries)
        kernel_pass(torch, engine, name, prompts[:len(MAIN_LENS)])
        return launches, timings
    finally:
        engine.stop()


# ---------------------------------------------------------------- lifecycle
def wait_until(pred, timeout: float, what: str) -> None:
    t_end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out after {timeout:g}s waiting for {what}")
        time.sleep(0.002)


def check_clean(engine, what: str) -> None:
    """Every slot free, the scheduler's ``busy_slots`` at 0, no request
    left and, on the paged layout, every page back in the pool."""
    wait_until(lambda: all(s is None for s in engine.slots), 60, f"{what}: slots to free")
    stats = engine._sched.stats()
    if stats["busy_slots"] or engine._by_id:
        raise AssertionError(f"{what}: {stats['busy_slots']} busy slots, {len(engine._by_id)} "
                             "requests left")
    pc = engine.paged_cache
    if pc is not None and pc.stats()["free_blocks"] != pc.stats()["total_blocks"]:
        raise AssertionError(f"{what}: pages still owned: {pc.stats()}")


def hook_retires(engine) -> list:
    """Record each retire on the engine thread as (slot, request id,
    reason, perf_counter time); returns the record."""
    log, retire = [], engine._retire

    def recorded(slot, reason):
        req = engine.slots[slot]
        log.append((slot, req.id if req is not None else None, reason, time.perf_counter()))
        return retire(slot, reason)

    engine._retire = recorded
    return log


def hook_admissions(engine) -> list:
    """Record each (slot, request id) that reaches a prefill (whole, or a
    chunk cursor's start)."""
    log = []
    for name in ("_prefill_into", "_start_cursor"):
        real = getattr(engine, name)

        def spy(slot, req, _real=real):
            log.append((slot, req.id))
            return _real(slot, req)

        setattr(engine, name, spy)
    return log


def first_frames(order: list, key):
    """A stream_cb that appends ``key`` to ``order`` at its first token
    frame (frames arrive in emission order on the one detok worker)."""
    seen = []

    def cb(token_id, piece, done):
        if not done and not seen:
            seen.append(token_id)
            order.append(key)

    return cb


def per_step_ms(results) -> float | None:
    per = sorted((r.duration_s - r.ttft_s) / (r.completion_tokens - 1) * 1e3 for r in results
                 if r.completion_tokens > 1)
    return per[len(per) // 2] if per else None


def lifecycle_dense(torch, engine, prompt, errors) -> dict:
    """The dense engine's scenarios, in order; each a hard failure, each
    ending with every slot free. Returns their outcomes and the timings."""
    out = {}
    retires = hook_retires(engine)
    admitted = hook_admissions(engine)

    # 1. priority: 8 running, then 4 at priority 5 and 4 at priority 0
    fill = [engine.submit(prompt(20), max_new_tokens=48) for _ in range(8)]
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8 and not engine._sched.pending(),
               120, "the 8 slots to fill")
    order: list = []
    queued = [engine.submit(prompt(20), max_new_tokens=48, priority=p,
                            stream_cb=first_frames(order, p)) for p in (5,) * 4 + (0,) * 4]
    res = [f.result(timeout=600) for f in fill + queued]
    if order != [0] * 4 + [5] * 4 or any(r.finish_reason not in ("length", "stop") for r in res):
        raise AssertionError(f"priority: first tokens by class {order}")
    check_clean(engine, "priority")
    out["priority"] = {"first_token_classes": order}

    # 2. cancel a running row after its 8th token; a queued request takes its slot
    t_cancel = []

    seen: list = []

    def cancel_at_8(token_id, piece, done):
        if not done:
            seen.append(token_id)
            if len(seen) == 8:
                t_cancel.append(time.perf_counter())
                engine.cancel(target.request_id)

    others = [engine.submit(prompt(20), max_new_tokens=128) for _ in range(7)]
    target = engine.submit(prompt(20), max_new_tokens=512, stream_cb=cancel_at_8)
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8, 120, "the 8 slots to fill")
    waiter = engine.submit(prompt(20), max_new_tokens=8)
    r = target.result(timeout=600)
    w = waiter.result(timeout=600)
    o = [f.result(timeout=600) for f in others]
    target_slot = next(s for s, rid in admitted if rid == target.request_id)
    waiter_slot = next(s for s, rid in admitted if rid == waiter.request_id)
    released = next(t for s, rid, why, t in retires if rid == target.request_id)
    if r.finish_reason != "cancel" or not 8 <= r.completion_tokens < 512 or waiter_slot != target_slot \
            or any(x.finish_reason not in ("length", "stop") for x in o + [w]):
        raise AssertionError(f"cancel: {r.finish_reason} after {r.completion_tokens} tokens; the "
                             f"waiter took slot {waiter_slot} (the canceled row's: {target_slot})")
    check_clean(engine, "cancel")
    cancel_ms = (released - t_cancel[0]) * 1e3
    out["cancel_running"] = {"finish_reason": r.finish_reason, "tokens": r.completion_tokens,
                             "waiter_took_slot": waiter_slot == target_slot, "cancel_to_release_ms": cancel_ms}

    # 4. deadlines: one that expires in the queue, one that expires mid-stream
    fill = [engine.submit(prompt(20), max_new_tokens=64) for _ in range(8)]
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8, 120, "the 8 slots to fill")
    late = engine.submit(prompt(20), max_new_tokens=8, deadline=0.2)
    try:
        late.result(timeout=600)
        raise AssertionError("deadline: a request expired in the queue was served")
    except errors.ErrorDeadlineExceeded as exc:
        if exc.status_code != 504:
            raise AssertionError(f"deadline: status {exc.status_code}") from None
    if any(rid == late.request_id for _, rid in admitted):
        raise AssertionError("deadline: the expired request reached a prefill")
    [f.result(timeout=600) for f in fill]
    r = engine.submit(prompt(20), max_new_tokens=1000, deadline=1.0).result(timeout=600)
    if r.finish_reason != "deadline_exceeded" or not 0 < r.completion_tokens < 1000:
        raise AssertionError(f"deadline: mid-stream {r.finish_reason} after {r.completion_tokens}")
    check_clean(engine, "deadlines")
    out["deadlines"] = {"queued": 504, "mid_stream": r.finish_reason, "mid_stream_tokens": r.completion_tokens}

    # 5. callbacks: one that raises cancels; one that blocks stalls only the detok worker
    def raises(token_id, piece, done):
        raise RuntimeError("client gone")

    r = engine.submit(prompt(20), max_new_tokens=200, stream_cb=raises).result(timeout=600)
    if r.finish_reason != "cancel" or r.completion_tokens >= 200:
        raise AssertionError(f"callbacks: a raising stream_cb gave {r.finish_reason}")
    release = threading.Event()

    def blocks(token_id, piece, done):
        release.wait(timeout=600)

    n0 = len(retires)
    futs = [engine.submit(prompt(20), max_new_tokens=65, stream_cb=blocks if i == 0 else None)
            for i in range(8)]
    rids = {f.request_id for f in futs[1:]}
    wait_until(lambda: sum(1 for _, rid, why, _ in retires[n0:]
                           if rid in rids and why in ("length", "stop")) == 7,
               300, "the 7 other rows to finish while a callback blocks")
    blocked_done = [f.done() for f in futs]
    release.set()
    res = [f.result(timeout=600) for f in futs]
    if any(x.finish_reason not in ("length", "stop") for x in res):
        raise AssertionError("callbacks: a row behind a blocking callback did not finish")
    check_clean(engine, "callbacks")
    out["callbacks"] = {"raising": r.finish_reason, "raising_tokens": r.completion_tokens,
                        "others_retired_while_blocked": 7,
                        "futures_done_while_blocked": sum(blocked_done)}

    # 6. stream(): whole, and left after 4 tokens
    futs = []
    submit = engine.submit

    def spy(*a, **kw):
        futs.append(submit(*a, **kw))
        return futs[-1]

    engine.submit = spy

    async def consume():
        whole, early, final = [], [], {}
        async for tid, _ in engine.stream(prompt(20), max_new_tokens=16,
                                          on_result=lambda res: final.setdefault("r", res)):
            whole.append(tid)
        agen = engine.stream(prompt(20), max_new_tokens=512)
        async for tid, _ in agen:
            early.append(tid)
            if len(early) == 4:
                break
        await agen.aclose()
        return whole, early, final["r"]

    try:
        whole, early, final = asyncio.run(consume())
    finally:
        del engine.submit
    left = futs[1].result(timeout=600)
    if whole != final.token_ids or left.finish_reason != "cancel":
        raise AssertionError(f"stream: {len(whole)} streamed tokens against {final.token_ids}; "
                             f"leaving early gave {left.finish_reason}")
    check_clean(engine, "stream")
    out["stream"] = {"tokens_equal_result": True, "left_early": left.finish_reason,
                     "left_early_tokens": left.completion_tokens}

    # 7. over-long prompt (C7): 2100 tokens at max_seq_len 2048
    ragged = [0]
    dispatch_ragged = engine._dispatch_ragged

    def count(*a):
        ragged[0] += 1
        return dispatch_ragged(*a)

    engine._dispatch_ragged = count
    try:
        r = engine.submit(prompt(2100), max_new_tokens=32).result(timeout=600)
    finally:
        del engine._dispatch_ragged
    if (r.prompt_tokens, r.completion_tokens, r.finish_reason) != (2047, 1, "length") or ragged[0] < 8:
        raise AssertionError(f"over-long: {r.prompt_tokens} prompt tokens, {r.completion_tokens} "
                             f"tokens, {r.finish_reason}, {ragged[0]} ragged dispatches")
    check_clean(engine, "over-long")
    out["over_long"] = {"prompt_tokens": r.prompt_tokens, "tokens": r.completion_tokens,
                        "finish_reason": r.finish_reason, "ragged_dispatches": ragged[0]}

    # 8. shed: 1 ms of estimated wait, the estimator seeded by the requests above
    fill = [engine.submit(prompt(20), max_new_tokens=64) for _ in range(8)]
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8, 120, "the 8 slots to fill")
    behind = engine.submit(prompt(20), max_new_tokens=8)
    shed = {}
    for how in ("threshold", "deadline"):
        engine.config.shed_max_wait_s = 0.001 if how == "threshold" else 0.0
        try:
            engine.submit(prompt(20), max_new_tokens=8, deadline=0.001 if how == "deadline" else None)
            raise AssertionError(f"shed: the {how} submit was accepted")
        except errors.ErrorTooManyRequests as exc:
            if not exc.retry_after or exc.retry_after <= 0:
                raise AssertionError(f"shed: retry_after {exc.retry_after}") from None
            shed[how] = {"status": exc.status_code, "retry_after_s": exc.retry_after}
    [f.result(timeout=600) for f in fill + [behind]]
    check_clean(engine, "shed")
    out["shed"] = shed

    # timings, for information: ms per decode step at batch 8, without
    # and with a stream_cb on every row
    def noop(token_id, piece, done):
        pass

    timing = {}
    for name, cb in (("decode_ms_per_step_b8_no_cb", None), ("decode_ms_per_step_b8_cb", noop)):
        res = [f.result(timeout=600) for f in
               [engine.submit(prompt(20), max_new_tokens=65, stream_cb=cb) for _ in range(8)]]
        timing[name] = per_step_ms(res)
    check_clean(engine, "timings")
    timing["cancel_to_release_ms"] = cancel_ms

    # 9. drain over 8 running requests, then a refused submit
    futs = [engine.submit(prompt(20), max_new_tokens=32) for _ in range(8)]
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8, 120, "the 8 slots to fill")
    if engine.drain(120) is not True:
        raise AssertionError("drain(120) did not finish the work in hand")
    res = [f.result(timeout=1) for f in futs]
    if any(x.finish_reason not in ("length", "stop") for x in res):
        raise AssertionError("drain: a request did not finish")
    try:
        engine.submit(prompt(5))
        raise AssertionError("drain: a submit after drain was accepted")
    except errors.ErrorServiceUnavailable as exc:
        if exc.status_code != 503 or "Retry-After" not in exc.response_headers():
            raise AssertionError("drain: the refusal is not a retriable 503") from None
    if any(s is not None for s in engine.slots) or engine._sched.stats()["busy_slots"]:
        raise AssertionError("drain: slots left busy")
    out["drain"] = {"drained": True, "after": 503}
    return out, timing


def lifecycle_drain_deadline(torch, engine, prompt, errors) -> dict:
    """drain(0) over 8 running requests on a fresh engine: False, each
    request ends with a result or a retriable 503, the thread exits."""
    engine.start()
    futs = [engine.submit(prompt(20), max_new_tokens=512) for _ in range(8)]
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8, 120, "the 8 slots to fill")
    if engine.drain(0) is not False:
        raise AssertionError("drain(0) over running work returned True")
    ends = []
    for f in futs:
        try:
            ends.append(f.result(timeout=60).finish_reason)
        except errors.ErrorServiceUnavailable as exc:
            if exc.retry_after is None:
                raise AssertionError("drain(0): a 503 without retry_after") from None
            ends.append(503)
    if engine._thread is not None and engine._thread.is_alive():
        raise AssertionError("drain(0): the engine thread did not exit")
    if any(s is not None for s in engine.slots) or engine._sched.stats()["busy_slots"]:
        raise AssertionError("drain(0): slots left busy")
    return {"drained": False, "ends": ends}


def lifecycle_paged(torch, engine, prompt) -> dict:
    """Cancel mid-chunk on the paged int8 engine: a 3000-token prompt
    beside two decoding rows, canceled after its first ragged dispatch."""
    pc = engine.paged_cache
    free0 = pc.stats()["free_blocks"]
    target: list = []
    dispatch_ragged = engine._dispatch_ragged

    def cancel_after_first(state, chunk_rows, steps):
        out = dispatch_ragged(state, chunk_rows, steps)
        if target and any(req.id == target[0].request_id for _, _, req, _, _ in chunk_rows) \
                and len(target) == 1:
            target.append(time.perf_counter())
            engine.cancel(target[0].request_id)
        return out

    engine._dispatch_ragged = cancel_after_first
    try:
        rows = [engine.submit(prompt(20), max_new_tokens=64) for _ in range(2)]
        wait_until(lambda: engine._sched.stats()["busy_slots"] == 2, 120, "two decoding rows")
        target.append(engine.submit(prompt(3000), max_new_tokens=8))
        r = target[0].result(timeout=600)
        res = [f.result(timeout=600) for f in rows]
    finally:
        del engine._dispatch_ragged
    if r.finish_reason != "cancel" or r.completion_tokens != 0 or len(target) != 2 \
            or any(x.finish_reason not in ("length", "stop") for x in res):
        raise AssertionError(f"cancel mid-chunk: {r.finish_reason} after {r.completion_tokens} tokens")
    check_clean(engine, "cancel mid-chunk")
    if pc.stats()["free_blocks"] != free0:
        raise AssertionError(f"cancel mid-chunk: {pc.stats()['free_blocks']} free pages, {free0} before")
    return {"finish_reason": r.finish_reason, "tokens": r.completion_tokens,
            "free_pages_restored": free0}


def check_prefill_c9(torch, cfg, params, prompt) -> dict:
    """C9 on the card: ``llama.prefill`` into a bf16 and an int8 KVCache
    (B=1, a 700-token prompt) against ``prefill_compute``'s slabs."""
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving import batch as batch_ops

    dev = params["embedding"].device
    tokens = torch.tensor([prompt(700)], device=dev)
    lens = torch.tensor([700], dtype=torch.int32, device=dev)
    want, k_slab, v_slab = batch_ops.prefill_compute(cfg, params, tokens, lens)
    out = {}
    for kv_dtype in (None, "int8"):
        cache = llama.KVCache.create(cfg, 1, max_len=700, kv_dtype=kv_dtype, device=dev)
        got, cache = llama.prefill(cfg, params, tokens, cache, lens)
        rel = ((got - want).norm() / want.norm()).item()
        if kv_dtype is None:
            same = torch.equal(cache.k[:, 0], k_slab) and torch.equal(cache.v[:, 0], v_slab)
        else:
            (kq, ks), (vq, vs) = llama.quantize_kv(k_slab), llama.quantize_kv(v_slab)
            same = all(torch.equal(a, b) for a, b in zip(
                (cache.k[:, 0], cache.v[:, 0], cache.ks[:, 0], cache.vs[:, 0]), (kq, vq, ks, vs)))
        name = kv_dtype or "bf16"
        print(f"  C9 llama.prefill into a {name} KVCache (700 tokens): logits rel_l2 {rel:.3e} "
              f"(tol {LOGITS_REL_TOL}), cache rows equal {'quantize_kv(slabs)' if kv_dtype else 'the slabs'}: {same}")
        if not (rel <= LOGITS_REL_TOL) or not same:
            raise AssertionError(f"C9: llama.prefill into a {name} cache disagrees with prefill_compute")
        out[name] = {"logits_rel_l2": rel, "cache_equal": same}
    return out


def run_lifecycle(torch, cfg, params) -> dict:
    """The lifecycle phase at Llama-3-8B widths: the dense engine (the
    reference's defaults) and the paged int8 engine, each with the launch
    counters reset just before its scenarios and read just after; then a
    fresh dense engine for drain(0), and C9's prefill check."""
    from gofr_tpu_torch import EngineConfig, ServingEngine, errors
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    rng = torch.Generator().manual_seed(SEED + 1)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    dense_cfg = dict(max_slots=8, max_seq_len=2048, kv_layout="dense", multi_step=4,
                     prefill_chunk_tokens=256)
    paged_cfg = dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32,
                     kv_dtype="int8", multi_step=4, prefill_chunk_tokens=256)
    kernels = counters()
    result = {"launches": {}}

    def engine_of(conf):
        engine = ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size), seed=SEED)
        engine.start()
        engine.submit(prompt(5), max_new_tokens=4).result(timeout=600)  # warm-up
        check_clean(engine, "warm-up")
        for fn in kernels.values():
            fn.launches = 0
        return engine

    t0 = time.perf_counter()
    engine = engine_of(dense_cfg)
    try:
        result["dense"], timing = lifecycle_dense(torch, engine, prompt, errors)
    finally:
        result["launches"]["dense"] = {n: fn.launches for n, fn in kernels.items()}
        engine.stop()
    del engine
    torch.cuda.empty_cache()
    engine = engine_of(paged_cfg)
    try:
        result["paged_int8"] = {"cancel_mid_chunk": lifecycle_paged(torch, engine, prompt)}
    finally:
        result["launches"]["paged_int8"] = {n: fn.launches for n, fn in kernels.items()}
        engine.stop()
    del engine
    torch.cuda.empty_cache()
    engine = ServingEngine(cfg, params, EngineConfig(**dense_cfg), ByteTokenizer(cfg.vocab_size), seed=SEED)
    result["dense"]["drain_deadline"] = lifecycle_drain_deadline(torch, engine, prompt, errors)
    del engine
    torch.cuda.empty_cache()
    result["c9_prefill"] = check_prefill_c9(torch, cfg, params, prompt)
    launches = result["launches"]
    if not (launches["dense"]["flash_attention"] and launches["paged_int8"]["flash_attention"]
            and launches["paged_int8"]["paged_decode_attention_q"]) \
            or launches["dense"]["paged_decode_attention"] or launches["dense"]["paged_decode_attention_q"]:
        raise AssertionError(f"lifecycle launches {launches}")
    result["timing"] = timing
    result["seconds"] = time.perf_counter() - t0
    print(f"  lifecycle: launches {launches}; timings {timing}; {result['seconds']:.1f}s")
    return result


# ------------------------------------------------------- kv reuse and spec
SPEC_TOKENS, SPEC_NGRAM = 4, 3


@contextlib.contextmanager
def spying(target, name: str, record):
    """Replace ``target.name`` for the block by a function that runs the
    real one and then calls ``record(bound arguments, result)``."""
    real = getattr(target, name)
    sig = inspect.signature(real)

    def spy(*args, **kw):
        out = real(*args, **kw)
        record(sig.bind(*args, **kw).arguments, out)
        return out

    setattr(target, name, spy)
    try:
        yield
    finally:
        setattr(target, name, real)


def finished(r, max_new: int) -> bool:
    """A request that ran to its budget, or to a stop token before it."""
    return (r.finish_reason == "length" and r.completion_tokens == max_new
            or r.finish_reason == "stop" and r.completion_tokens < max_new)


def launch_counts() -> dict:
    return {n: fn.launches for n, fn in counters().items()}


def print_launches(name: str, launches: dict) -> None:
    """Each kernel's launch count on a line of its own."""
    for kernel, label in (("flash_attention", "flash"), ("paged_decode_attention", "paged bf16"),
                          ("paged_decode_attention_q", "paged int8")):
        print(f"  {name} launches: {label} {launches.get(kernel, 0)}")


def add_launches(total: dict, more: dict) -> None:
    for n, v in more.items():
        total[n] = total.get(n, 0) + v


def reuse_path(torch, cfg, params, name: str, ecfg, prompts: dict, *, steps: tuple,
               chunk_cache: bool, logits_check: bool) -> dict:
    """Drive one KV-reuse engine through ``steps`` of: (1) a 200-token
    prompt twice, the second a whole-prompt hit; (2) a 1000-token prompt
    alone twice, the second a full chain hit, or with ``chunk_cache`` off a
    recomputation; (3) the system-prompt mix, one warm request and then 8
    concurrent ones sharing its 768-token prefix; (4) the logits of one
    warm request against the dense forward. Each request's prefill calls,
    chunk rows dispatched and kernel launches are counted alone. Returns
    the outcomes; raises at the first check that fails."""
    from gofr_tpu_torch import ServingEngine
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving import batch as batch_ops
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, ecfg, ByteTokenizer(cfg.vocab_size), seed=SEED)
    layout = "dense" if engine.paged_cache is None else f"paged page={ecfg.kv_page_size}"
    print(f"engine {name}: {layout} kv_dtype={ecfg.kv_dtype} max_seq_len={ecfg.max_seq_len} "
          f"chunk={engine._chunk_tokens} prefix_cache_entries={ecfg.prefix_cache_entries} "
          f"prefix_cache_bytes={ecfg.prefix_cache_bytes} kv_spill_bytes={ecfg.kv_spill_bytes}, "
          f"{cfg.n_layers} layers")
    prefill_calls, chunk_rows = [], []
    out = {"launches": {}}
    total = {}

    def served(ids, what, **kw):
        """One request alone: (result, prefill calls, chunk rows, launches)."""
        n_pre, n_rows = len(prefill_calls), len(chunk_rows)
        for fn in counters().values():
            fn.launches = 0
        r = engine.submit(ids, **{"max_new_tokens": 32, **kw}).result(timeout=600)
        launches = launch_counts()
        add_launches(total, launches)
        rec = (r, len(prefill_calls) - n_pre, chunk_rows[n_rows:], launches)
        print(f"  {what}: {r.completion_tokens} tokens, {r.finish_reason}, ttft "
              f"{r.ttft_s * 1e3:.2f} ms; prefill calls {rec[1]}, chunk dispatches {len(rec[2])}, "
              f"flash launches {launches['flash_attention']}")
        if not finished(r, kw.get("max_new_tokens", 32)) or any(
                not (0 <= t < cfg.vocab_size) for t in r.token_ids):
            raise AssertionError(f"{name} {what}: ended {r.finish_reason}")
        return rec

    engine.start()
    try:
        with spying(batch_ops, "prefill_compute", lambda a, o: prefill_calls.append(1)), \
                spying(batch_ops, ragged_name(engine),
                       lambda a, o: chunk_rows.append(int(a["chunk_rows"].shape[0]))):
            engine.submit(prompts["warm"], max_new_tokens=4).result(timeout=600)  # warm-up
            if 1 in steps:
                cold = served(prompts["short"], "200-token prompt, cold")
                warm = served(prompts["short"], "200-token prompt, again")
                ok = (cold[1] == 1 and warm[1] == 0 and warm[3]["flash_attention"] == 0
                      and warm[0].token_ids == cold[0].token_ids)
                out["whole_prompt_hit"] = ok
                if not ok:
                    raise AssertionError(f"{name}: the repeated 200-token prompt was no clean hit")
            if 2 in steps:
                cold = served(prompts["long"], "1000-token prompt alone, cold")
                warm = served(prompts["long"], "1000-token prompt alone, again")
                n_chunks = math.ceil(1000 / engine._chunk_tokens)
                hit = not warm[2] and warm[1] == 0 and warm[3]["flash_attention"] == 0
                keys = [k for k in engine._prefix_cache.keys() if str(k).startswith("chunkpfx:")]
                ok = (len(cold[2]) == n_chunks and warm[0].token_ids == cold[0].token_ids
                      and (hit if chunk_cache else len(warm[2]) == n_chunks and not keys))
                out["ttft_ms_prompt1000_cold"] = cold[0].ttft_s * 1e3
                out["ttft_ms_prompt1000_warm"] = warm[0].ttft_s * 1e3
                out["chain_hit" if chunk_cache else "chunk_miss"] = ok
                print(f"  TTFT of the 1000-token prompt: cold {cold[0].ttft_s * 1e3:.2f} ms, "
                      f"warm {warm[0].ttft_s * 1e3:.2f} ms; chunkpfx keys {len(keys)}")
                if not ok:
                    raise AssertionError(f"{name}: the repeated 1000-token prompt broke its contract")
            if 3 in steps:
                system, suffixes = prompts["system"], prompts["suffixes"]
                served(system + suffixes[0], "system prompt + suffix 0, the first of its family")
                before, n_rows = engine._prefix_cache.stats(), len(chunk_rows)
                for fn in counters().values():
                    fn.launches = 0
                futs = [engine.submit(system + s, max_new_tokens=32) for s in suffixes[1:9]]
                results = [f.result(timeout=900) for f in futs]
                add_launches(total, launch_counts())
                after = engine._prefix_cache.stats()
                hits, computed = after["hits"] - before["hits"], sum(chunk_rows[n_rows:])
                ok = hits == 24 and computed == 8 and all(finished(r, 32) for r in results)
                out["system_mix"] = {"hits": hits, "computed_chunks": computed, "ok": ok,
                                     "ttft_ms_max": max(r.ttft_s for r in results) * 1e3}
                print(f"  system-prompt mix, 8 concurrent {len(system) + 200}-token prompts: "
                      f"{hits} chunk hits, {computed} chunks computed, TTFT max "
                      f"{out['system_mix']['ttft_ms_max']:.2f} ms, ms/step {per_step_ms(results)}")
                if not ok:
                    raise AssertionError(f"{name}: system-prompt mix {out['system_mix']}")
            if logits_check:
                # the 1000-token prompt once more: its first token from the
                # cached chain's logits, with no prefill dispatch at all
                looked, decode_seen = [], []
                lookup = engine._cache_lookup
                engine._cache_lookup = lambda key: looked.append(lookup(key)) or looked[-1]
                step_name, step_fn, step_hook = decode_step_spy(engine, decode_seen)
                n_pre, n_rows = len(prefill_calls), len(chunk_rows)
                setattr(llama, step_name, step_hook)
                try:
                    r = engine.submit(prompts["long"], max_new_tokens=9).result(timeout=600)
                finally:
                    setattr(llama, step_name, step_fn)
                    del engine._cache_lookup
                if len(prefill_calls) != n_pre or len(chunk_rows) != n_rows or not finished(r, 9):
                    raise AssertionError(f"{name}: the warm logits check dispatched a prefill")
                first = [v for v, _tier in looked if v is not None][-1][0]
                hold_to_dense(torch, engine, prompts["long"], r, first, decode_seen, 8,
                              f"0 prefill calls, first token from the cached chain's logits "
                              f"({len(looked)} lookups)")
                out["warm_logits"] = True
    finally:
        engine.stop()
    out["launches"] = total
    out["cache"] = {k: v for k, v in engine._prefix_cache.stats().items() if k != "host"}
    out["seconds"] = time.perf_counter() - t0
    print_launches(name, total)
    print(f"  {name}: prefix cache {out['cache']}; {out['seconds']:.1f}s")
    return out


def spill_path(torch, cfg, params, name: str, ecfg, prompts: dict) -> dict:
    """A device tier that holds one 200-token entry over a host spill tier:
    prompt A, then B (which evicts A to host memory), a flush, then A
    again, which must be a host-tier hit with A's tokens."""
    from gofr_tpu_torch import ServingEngine
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, ecfg, ByteTokenizer(cfg.vocab_size), seed=SEED)
    print(f"engine {name}: dense kv_dtype={ecfg.kv_dtype} prefix_cache_bytes="
          f"{ecfg.prefix_cache_bytes} kv_spill_bytes={ecfg.kv_spill_bytes}, {cfg.n_layers} layers")
    tiers = []
    lookup = engine._cache_lookup

    def recorded(key):
        value, tier = lookup(key)
        tiers.append(tier)
        return value, tier

    engine._cache_lookup = recorded
    for fn in counters().values():
        fn.launches = 0
    engine.start()
    try:
        a = engine.submit(prompts["short"], max_new_tokens=32).result(timeout=600)
        engine.submit(prompts["other"], max_new_tokens=32).result(timeout=600)
        flushed = engine._prefix_cache.flush(60.0)
        host_before = engine._prefix_cache.stats()["host"]
        tiers.clear()
        again = engine.submit(prompts["short"], max_new_tokens=32).result(timeout=600)
        stats = engine._prefix_cache.stats()
    finally:
        engine.stop()
    launches = launch_counts()
    ok = (flushed and tiers == ["host"] and stats["host"]["hits"] == 1
          and again.token_ids == a.token_ids and finished(again, 32))
    out = {"host_hit": ok, "tiers": tiers, "host_entries_before": host_before["entries"],
           "spilled_total": stats["spilled_total"], "launches": launches,
           "ttft_ms_cold": a.ttft_s * 1e3, "ttft_ms_host_hit": again.ttft_s * 1e3,
           "seconds": time.perf_counter() - t0}
    print(f"  A, B, flush, A again: lookup tiers of the second A {tiers}, host hits "
          f"{stats['host']['hits']}, spilled {stats['spilled_total']}, tokens equal "
          f"{again.token_ids == a.token_ids}; TTFT cold {a.ttft_s * 1e3:.2f} ms, host hit "
          f"{again.ttft_s * 1e3:.2f} ms")
    print_launches(name, launches)
    if not ok:
        raise AssertionError(f"{name}: no clean host-tier hit: {out}")
    return out


def spec_traffic(engine, prompts: list) -> tuple[list, float]:
    """8 greedy requests and one sampled, 48 new tokens each, at once."""
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new_tokens=48,
                          **(dict(temperature=0.8, top_k=50, top_p=0.95) if i == 8 else {}))
            for i, p in enumerate(prompts)]
    return [f.result(timeout=900) for f in futs], time.perf_counter() - t0


def check_spec_logits(torch, engine, ids: list[int], n_new: int) -> dict:
    """Serve one greedy request alone on a spec engine and hold every
    logits row the engine computed for an emitted token (the prefill's for
    the first, then, per verify, the rows of the accepted drafts and the
    bonus) against the dense forward; every emitted token must be the
    argmax of its row."""
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving import batch as batch_ops

    dense = engine.paged_cache is None
    quantized = (engine.cache if dense else engine.paged_cache).quantized
    fwd = "decode_chunk" if dense else ("decode_chunk_paged_q" if quantized else "decode_chunk_paged")
    pre, verifies = [], []

    def on_verify(a, o):
        rows = (a["tokens"][:, 0] >= 0).nonzero()[:, 0].tolist()
        if len(rows) != 1:
            raise AssertionError(f"the spec logits check saw verify rows {rows}")
        verifies.append((a["tokens"][rows[0]].tolist(), o[0][rows[0]].clone()))

    with spying(batch_ops, "prefill_compute", lambda a, o: pre.append(o[0].clone())), \
            spying(llama, fwd, on_verify):
        r = engine.submit(ids, max_new_tokens=n_new).result(timeout=600)
    rows, emitted = [pre[-1][0]], [int(pre[-1][0].argmax())]
    accepted = 0
    for chunk, L in verifies:
        g = L.argmax(-1).tolist()
        a = 0
        while a + 1 < len(chunk) and chunk[a + 1] >= 0 and g[a] == chunk[a + 1]:
            a += 1
        accepted += a
        rows += [L[j] for j in range(a + 1)]
        emitted += g[:a + 1]
    n = len(r.token_ids)
    picked = emitted[:n] == r.token_ids and (r.finish_reason != "length" or n == n_new)
    got = torch.stack(rows[:n])
    want = dense_logits(torch, engine.model_cfg, engine.params, ids + r.token_ids[:n - 1], n,
                        kv_quant=quantized)
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
    dense_agree = sum(int(a == b) for a, b in zip(want.argmax(-1).tolist(), r.token_ids))
    print(f"  spec logits vs dense forward{' (K/V quantized)' if quantized else ''} "
          f"({len(ids)}-token prompt, {len(verifies)} verify dispatches, {accepted} drafts "
          f"accepted): rel_l2 max {max(rel):.3e} over {n} tokens (tol {LOGITS_REL_TOL}); tokens = "
          f"argmax of the engine's logits: {picked}; dense argmax agrees on {dense_agree}/{n}")
    if not (max(rel) <= LOGITS_REL_TOL) or not picked or not bool(torch.isfinite(got).all()):
        raise AssertionError("the spec engine's logits disagree with the dense forward")
    return {"rel_l2_max": max(rel), "verifies": len(verifies), "accepted": accepted, "tokens": n}


def spec_path(torch, cfg, params, name: str, conf: dict, prompts: list, check_ids: list) -> dict:
    """A spec engine and a non-spec engine of the same layout over the
    same traffic, one after the other; the spec engine's logits check."""
    from gofr_tpu_torch import EngineConfig, ServingEngine
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    out = {}
    for mode, extra in (("spec", dict(spec_tokens=SPEC_TOKENS, spec_ngram=SPEC_NGRAM)),
                        ("plain", dict(multi_step=4))):
        ecfg = EngineConfig(**conf, **extra)
        engine = ServingEngine(cfg, params, ecfg, ByteTokenizer(cfg.vocab_size), seed=SEED)
        engine.start()
        try:
            engine.submit(prompts[0][:5], max_new_tokens=4).result(timeout=600)  # warm-up
            engine.spec_stats.update(dispatches=0, accepted=0, emitted=0)
            for fn in counters().values():
                fn.launches = 0
            results, wall = spec_traffic(engine, prompts)
            launches = launch_counts()
            stats = dict(engine.spec_stats)
            check = check_spec_logits(torch, engine, check_ids, 16) if mode == "spec" else None
            if mode == "spec":  # K: after the spec records, which it leaves as they were
                kernel_pass(torch, engine, name, prompts[:K_SPEC_PROMPTS])
        finally:
            engine.stop()
        del engine
        torch.cuda.empty_cache()
        for r in results:
            if r.finish_reason not in ("length", "stop") or not r.token_ids:
                raise AssertionError(f"{name} {mode}: a request ended {r.finish_reason}")
        out[mode] = {"results": results, "launches": launches, "spec_stats": stats,
                     "ms_per_token": per_step_ms(results), "wall_s": wall, "check": check}
        print(f"  {name} {mode}: {ecfg.kv_layout} kv_dtype={ecfg.kv_dtype} spec_tokens="
              f"{ecfg.spec_tokens}; traffic {wall:.2f}s, ms per emitted token (median row) "
              f"{out[mode]['ms_per_token']}; spec_stats {stats}")
        print_launches(f"{name} {mode}", launches)
    spec, plain = out["spec"], out["plain"]
    greedy = list(zip(spec["results"][:8], plain["results"][:8]))
    same_rows = sum(int(a.token_ids == b.token_ids) for a, b in greedy)
    same_tokens = sum(sum(int(x == y) for x, y in zip(a.token_ids, b.token_ids)) for a, b in greedy)
    n_tokens = sum(len(b.token_ids) for _, b in greedy)
    first_diff = [next((i for i, (x, y) in enumerate(zip(a.token_ids, b.token_ids)) if x != y), None)
                  for a, b in greedy]
    # how close a tie each first difference was: the dense forward's gap
    # between its two largest logits there, beside the row's median gap
    # over the tokens both engines agreed on
    gaps = []
    for (_, b), d, p in zip(greedy, first_diff, prompts):
        if d is None:
            continue
        lg = dense_logits(torch, cfg, params, p + b.token_ids[:d], d + 1,
                          kv_quant=conf.get("kv_dtype") == "int8")
        top2 = lg.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).tolist()
        gaps.append([gap[-1], sorted(gap[:-1])[len(gap[:-1]) // 2] if d else None])
    st = spec["spec_stats"]
    per_dispatch = st["accepted"] / st["dispatches"] if st["dispatches"] else 0.0
    # each row of a verify emits its accepted drafts and one more token
    row_verifies = st["emitted"] - st["accepted"]
    summary = {
        "spec_stats": st, "accepted_per_dispatch": per_dispatch,
        "accepted_per_row_verify": st["accepted"] / row_verifies if row_verifies else 0.0,
        "emitted_per_dispatch": st["emitted"] / st["dispatches"] if st["dispatches"] else 0.0,
        "ms_per_emitted_token": spec["ms_per_token"], "plain_ms_per_step": plain["ms_per_token"],
        "greedy_rows_equal": same_rows, "greedy_tokens_equal": same_tokens,
        "greedy_first_difference": first_diff, "top2_gap_at_difference_and_median": gaps,
        "greedy_tokens": n_tokens, "logits_check": spec["check"],
        "launches": {"spec": spec["launches"], "plain": plain["launches"]},
        "seconds": time.perf_counter() - t0,
    }
    print(f"  {name}: accepted drafts per verify dispatch {per_dispatch:.3f} (per row verify "
          f"{summary['accepted_per_row_verify']:.3f}), emitted per dispatch "
          f"{summary['emitted_per_dispatch']:.3f}; ms per emitted token {spec['ms_per_token']} "
          f"against {plain['ms_per_token']} ms per step without spec; greedy rows equal to the "
          f"non-spec engine's {same_rows}/8, tokens {same_tokens}/{n_tokens}, first difference at "
          f"token {first_diff}; the dense forward's top-2 logit gap there and the row's median gap "
          f"before it {[[round(x, 4) if x is not None else None for x in g] for g in gaps]} "
          f"(information: at bf16 a near-tie may flip an argmax between the verify's chunk "
          f"forward and the one-step decode)")
    if not st["dispatches"] or st["emitted"] < st["dispatches"]:
        raise AssertionError(f"{name}: spec_stats {st}")
    return summary


def run_kv_reuse_spec(torch, cfg, params) -> dict:
    """The kv-reuse and spec phase at Llama-3-8B widths and full depth, one
    engine after another, each stopped before the next: R1 dense bf16, R2
    paged bf16 and R3 paged int8 with the prefix caches; R4 dense bf16 over
    the host spill tier; S1 dense bf16 and S2 paged int8 with speculative
    decoding, each beside a non-spec engine of its layout."""
    from gofr_tpu_torch import EngineConfig

    rng = torch.Generator().manual_seed(SEED + 2)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    t0 = time.perf_counter()
    prompts = {"warm": prompt(5), "short": prompt(200), "other": prompt(200), "long": prompt(1000),
               "system": prompt(768), "suffixes": [prompt(200) for _ in range(9)]}
    reuse = dict(max_slots=8, multi_step=4, prefill_chunk_tokens=256, prefix_cache_entries=64,
                 prefix_cache_bytes=2 << 30)
    out = {}
    out["R1"] = reuse_path(torch, cfg, params, "R1", EngineConfig(
        **reuse, max_seq_len=2048, kv_layout="dense"), prompts, steps=(1, 2, 3),
        chunk_cache=True, logits_check=True)
    torch.cuda.empty_cache()
    out["R2"] = reuse_path(torch, cfg, params, "R2", EngineConfig(
        **reuse, max_seq_len=2048, kv_layout="paged", kv_page_size=16), prompts, steps=(1, 2, 3),
        chunk_cache=True, logits_check=False)
    torch.cuda.empty_cache()
    out["R3"] = reuse_path(torch, cfg, params, "R3", EngineConfig(
        **reuse, max_seq_len=4096, kv_layout="paged", kv_page_size=32, kv_dtype="int8"), prompts,
        steps=(1, 2), chunk_cache=False, logits_check=False)
    torch.cuda.empty_cache()
    # 2 MiB a layer (64 MiB at 32 layers) holds one 200-token entry (34.1 MB
    # at bucket 256 and 32 layers), not two
    out["R4"] = spill_path(torch, cfg, params, "R4", EngineConfig(
        **dict(reuse, prefix_cache_bytes=(2 << 20) * cfg.n_layers), max_seq_len=2048,
        kv_layout="dense",
        kv_spill_bytes=1 << 30), prompts)
    torch.cuda.empty_cache()
    # each prompt repeats a random 40-token segment 5 times: prompt lookup
    # finds continuations to draft
    spec_prompts = [prompt(40) * 5 for _ in range(9)]
    check_ids = prompt(40) * 5
    spec = dict(max_slots=8, prefill_chunk_tokens=256)
    out["S1"] = spec_path(torch, cfg, params, "S1", dict(
        spec, max_seq_len=2048, kv_layout="dense"), spec_prompts, check_ids)
    out["S2"] = spec_path(torch, cfg, params, "S2", dict(
        spec, max_seq_len=4096, kv_layout="paged", kv_page_size=32, kv_dtype="int8"),
        spec_prompts, check_ids)
    total = {}
    for key in ("R1", "R2", "R3", "R4"):
        add_launches(total, out[key]["launches"])
    for key in ("S1", "S2"):
        for mode in ("spec", "plain"):
            add_launches(total, out[key]["launches"][mode])
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t0
    print(f"  kv-reuse and spec: launches {total}; {out['seconds']:.1f}s")
    if (out["R1"]["launches"].get("paged_decode_attention") or out["R1"]["launches"].get(
            "paged_decode_attention_q") or not out["R2"]["launches"].get("paged_decode_attention")
            or not out["R3"]["launches"].get("paged_decode_attention_q")
            or not all(total.get(n) for n in counters())):
        raise AssertionError(f"kv-reuse and spec launches {total}")
    return out


# ---------------------------------------------------------- LoRA and tenancy
LORA_RANK = 16
# make_adapter's scale: the delta's logits are ~scale/64 at these random
# weights (embedding rows of norm ~1, A entries ~1/sqrt(D)), 0.25 here
# against base logits of RMS ~1, so each adapter moves greedy tokens
LORA_SCALE = 16.0
# two greedy runs whose tokens part at a step pass only if, on the dense
# forward's logits there, the two tokens they chose lie within this gap:
# twice the per-logit error LOGITS_REL_TOL allows at these unit-RMS logits
GAP_TOL = 2 * LOGITS_REL_TOL
STORM_BULK, STORM_PROMPT, STORM_NEW = 8, 600, 128  # T1/T2: batch-class rows
GOLD_PROMPT, GOLD_NEW, GOLD_AFTER = 200, 16, 16  # the interactive request, and when it comes


def adapter_delta(torch, engine, adapter):
    """``hold_to_dense``'s ``delta`` for one adapter served by ``engine``:
    for the tokens given, (the delta the engine's device tables give at
    the adapter's slot, ``emb[t] @ A @ B`` from its host factors)."""
    from gofr_tpu_torch.serving import batch as batch_ops

    dev = engine.device
    a = torch.from_numpy(adapter.a).to(dev).float()
    b = torch.from_numpy(adapter.b).to(dev).float()

    def delta(tokens):
        t = torch.tensor(tokens, device=dev)
        slot = engine._lora._slot_of[adapter.adapter_id]  # resident since its request
        a_tab, b_tab = engine._lora.tables()
        got = batch_ops._lora_delta(engine.params["embedding"], a_tab, b_tab, t,
                                    torch.full_like(t, slot))
        return got, (engine.params["embedding"][t].float() @ a) @ b

    return delta


def same_or_close(torch, engine, ids: list[int], got: list[int], want: list[int], what: str,
                  delta=None) -> dict:
    """Two greedy runs of one request: equal tokens, or where they first
    part, the two tokens' logits on the dense forward over the prompt and
    the shared tokens (plus the adapter's delta) within GAP_TOL. Prints a
    parting; raises past the tolerance."""
    if got == want:
        return {"equal": True}
    k = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if k is None:
        raise AssertionError(f"{what}: one run stopped early ({len(got)} against {len(want)} tokens)")
    seq = ids + want[:k]
    quantized = (engine.cache if engine.paged_cache is None else engine.paged_cache).quantized
    logits = dense_logits(torch, engine.model_cfg, engine.params, seq, 1, kv_quant=quantized)[0]
    if delta is not None:
        logits = logits + delta([seq[-1]])[1][0]
    top2 = logits.topk(2).values.tolist()
    gap = abs(float(logits[got[k]] - logits[want[k]]))
    print(f"  {what}: the runs part at step {k} ({got[k]} against {want[k]}); their dense-forward "
          f"logits gap {gap:.4f} (top-2 gap {top2[0] - top2[1]:.4f}; tol {GAP_TOL})")
    if not gap <= GAP_TOL:
        raise AssertionError(f"{what}: tokens part at step {k} with a logits gap of {gap:.4f}")
    return {"equal": False, "step": k, "gap": gap}


def lora_path(torch, cfg, params, name: str, ecfg, reg, adapters: list, prompt) -> dict:
    """L1 (dense bf16) or L2 (paged int8 with 256-token chunks) with the
    adapter registry, launches counted from after a warm-up. L1: 8 greedy
    rows of 200-token prompts in one batch (2 base, 2 per adapter: two
    prompts under each), then each row alone, tokens equal or within the
    gap rule, each adapter moving tokens against base; the logits of one
    request per adapter against the dense forward plus its delta; ms a
    decode step of a batch of 8 with adapters and without. L2: a
    1000-token prompt under the first adapter chunks through the ragged
    dispatch, first token folded on the device, its logits held the same
    way."""
    from gofr_tpu_torch import ServingEngine
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, ecfg, ByteTokenizer(cfg.vocab_size), seed=SEED, lora=reg)
    layout = "dense" if engine.paged_cache is None else f"paged page={ecfg.kv_page_size}"
    print(f"engine {name}: {layout} kv_dtype={ecfg.kv_dtype} chunk={engine._chunk_tokens} "
          f"{cfg.n_layers} layers; adapters {[a.adapter_id for a in adapters]} rank {LORA_RANK} "
          f"scale {LORA_SCALE} (max_active {reg.max_active})")
    out = {}
    engine.start()
    try:
        engine.submit(prompt(5), max_new_tokens=4).result(timeout=600)  # warm-up
        for fn in counters().values():
            fn.launches = 0
        if name == "L1":
            pair = [prompt(200), prompt(200)]
            rows = [(pair[i], a) for a in [None] + [ad.adapter_id for ad in adapters] for i in range(2)]
            futs = [engine.submit(p, max_new_tokens=32, adapter_id=a) for p, a in rows]
            batched = [f.result(timeout=900) for f in futs]
            alone = [engine.submit(p, max_new_tokens=32, adapter_id=a).result(timeout=600)
                     for p, a in rows]
            deltas = {ad.adapter_id: adapter_delta(torch, engine, ad) for ad in adapters}
            partings = []
            for (p, a), rb, ra in zip(rows, batched, alone):
                if not (finished(rb, 32) and finished(ra, 32)):
                    raise AssertionError(f"{name}: a row ended {rb.finish_reason}/{ra.finish_reason}")
                partings.append(same_or_close(torch, engine, p, rb.token_ids, ra.token_ids,
                                              f"{name} row {a or 'base'} batched vs alone",
                                              deltas.get(a)))
            base = [r.token_ids for (_, a), r in zip(rows, alone) if a is None]
            moved = {ad.adapter_id: [r.token_ids for (_, a), r in zip(rows, alone)
                                     if a == ad.adapter_id] != base for ad in adapters}
            out.update(batched_equal_alone=sum(x["equal"] for x in partings),
                       partings=[x for x in partings if not x["equal"]], adapters_move_tokens=moved)
            print(f"  {name}: 8 rows batched vs alone: {out['batched_equal_alone']}/8 equal; each "
                  f"adapter moves tokens against base: {moved}")
            if not all(moved.values()):
                raise AssertionError(f"{name}: an adapter left every token as the base model's")
            for ad in adapters:
                check_engine_logits(torch, engine, prompt(200), 8, deltas[ad.adapter_id],
                                    adapter_id=ad.adapter_id)
            # ms a decode step, 8 rows of 20-token prompts, 65 tokens each
            for key, names in (("lora", [None, None] + [ad.adapter_id for ad in adapters for _ in (0, 1)]),
                               ("base", [None] * 8)):
                res = [f.result(timeout=900) for f in
                       [engine.submit(prompt(20), max_new_tokens=65, adapter_id=a) for a in names]]
                out[f"decode_ms_per_step_batch8_{key}"] = per_step_ms(res)
            print(f"  {name}: ms a decode step, batch of 8: with adapters "
                  f"{out['decode_ms_per_step_batch8_lora']:.3f}, base only "
                  f"{out['decode_ms_per_step_batch8_base']:.3f}")
        else:
            ad = adapters[0]
            check_engine_logits(torch, engine, prompt(1000), 10, adapter_delta(torch, engine, ad),
                                adapter_id=ad.adapter_id)
            out["chunked_adapter_logits"] = True
        out["launches"] = launch_counts()
        out["residency"] = reg.residency()
    finally:
        engine.stop()
    if reg.residency()["pinned_slots"]:
        raise AssertionError(f"{name}: adapter pins left: {reg.residency()}")
    out["seconds"] = time.perf_counter() - t0
    print_launches(name, out["launches"])
    print(f"  {name}: registry {out['residency']}; {out['seconds']:.1f}s")
    return out


def storm_run(torch, cfg, params, ecfg, bulk: list, gold: list) -> dict:
    """One run of the tenant storm: the batch-class rows, and once each
    has GOLD_AFTER tokens out, the interactive request, submitted from the
    engine thread right after the block that got them there was read.
    Launches counted from after a warm-up."""
    from gofr_tpu_torch import ServingEngine
    from gofr_tpu_torch.serving import TenantPolicy, TenantRegistry
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    tenants = TenantRegistry()
    tenants.set_policy(TenantPolicy(name="gold", deadline_class="interactive", deadline_s=600.0))
    tenants.set_policy(TenantPolicy(name="bulk", deadline_class="batch", deadline_s=600.0))
    engine = ServingEngine(cfg, params, ecfg, ByteTokenizer(cfg.vocab_size), seed=SEED,
                           tenants=tenants)
    state, preempted, resumes = {}, [], []
    frames = [[] for _ in bulk]
    consume, preempt, start_cursor = engine._consume, engine._preempt, engine._start_cursor

    def consume_hook(rec):
        consume(rec)
        rows = [r for r in engine.slots if r is not None and r.tenant == "bulk"]
        if ("gold" not in state and len(rows) == len(bulk)
                and all(len(r.tokens) >= GOLD_AFTER for r in rows)):
            state["gold"] = engine.submit(gold, max_new_tokens=GOLD_NEW, tenant="gold")

    def preempt_hook(slot):
        preempted.append((engine.slots[slot].id, len(engine.slots[slot].tokens)))
        return preempt(slot)

    def start_cursor_hook(slot, req):
        start_cursor(slot, req)
        cursor = engine._cursors.get(slot)
        if req.preemptions and cursor is not None:
            resumes.append({"request": req.id, "total": cursor.total, "prefix_hit": cursor.prefix_hit})

    engine._consume, engine._preempt, engine._start_cursor = consume_hook, preempt_hook, start_cursor_hook
    engine.start()
    try:
        engine.submit(bulk[0][:5], max_new_tokens=4).result(timeout=600)  # warm-up
        for fn in counters().values():
            fn.launches = 0
        futs = [engine.submit(p, max_new_tokens=STORM_NEW, tenant="bulk",
                              stream_cb=lambda t, s, d, i=i: None if d else frames[i].append(t))
                for i, p in enumerate(bulk)]
        results = [f.result(timeout=900) for f in futs]
        wait_until(lambda: "gold" in state, 60, "the interactive request")
        hi = state["gold"].result(timeout=600)
        launches = launch_counts()
        check_clean(engine, "tenant storm")
    finally:
        engine.stop()
    return {"results": results, "gold": hi, "frames": frames, "preempted": preempted,
            "resumes": resumes, "launches": launches, "engine": engine}


def tenancy_path(torch, cfg, params, name: str, conf: dict, prompt) -> dict:
    """T1 (dense bf16) or T2 (paged bf16): the tenant storm on an engine
    with the preemption ladder and on an identical one without it (the
    twins). Checks: at least one preemption, gold ends "length", every
    batch-class row 128 tokens with every token streamed once, each row's
    tokens equal its twin's or within the gap rule, and each resume walks
    at least one chunk hit and dispatches fewer chunks than a cold
    prefill. Prints gold's TTFT on both."""
    from gofr_tpu_torch import EngineConfig

    t0 = time.perf_counter()
    bulk = [prompt(STORM_PROMPT) for _ in range(STORM_BULK)]
    gold = prompt(GOLD_PROMPT)
    chunk = conf["prefill_chunk_tokens"]
    print(f"engine {name}: {conf['kv_layout']} page={conf.get('kv_page_size', '-')} "
          f"chunk={chunk}, {cfg.n_layers} layers: {STORM_BULK} batch-class rows of "
          f"{STORM_PROMPT}-token prompts, {STORM_NEW} tokens; at {GOLD_AFTER} tokens out each, one "
          f"interactive {GOLD_PROMPT}-token request of {GOLD_NEW}")
    twin = storm_run(torch, cfg, params, EngineConfig(**conf, tenant_preempt=False), bulk, gold)
    del twin["engine"]  # its KV and prefix cache go before the next engine's
    torch.cuda.empty_cache()
    run = storm_run(torch, cfg, params, EngineConfig(**conf), bulk, gold)
    torch.cuda.empty_cache()
    out = {"preemptions": len(run["preempted"]), "preempted_at_tokens": [n for _, n in run["preempted"]],
           "resumes": run["resumes"], "gold_ttft_ms": run["gold"].ttft_s * 1e3,
           "gold_ttft_ms_without_preemption": twin["gold"].ttft_s * 1e3,
           "launches": run["launches"], "launches_without_preemption": twin["launches"]}
    print(f"  {name}: preemptions {out['preemptions']} (at {out['preempted_at_tokens']} tokens out), "
          f"resumes {run['resumes']}; gold TTFT {out['gold_ttft_ms']:.2f} ms with the ladder, "
          f"{out['gold_ttft_ms_without_preemption']:.2f} ms without it (information)")
    if not run["preempted"] or run["gold"].finish_reason != "length" or \
            twin["gold"].finish_reason != "length" or twin["preempted"]:
        raise AssertionError(f"{name}: preempted {run['preempted']}, gold "
                             f"{run['gold'].finish_reason}, twin preempted {twin['preempted']}")
    partings = []
    for i, (r, t) in enumerate(zip(run["results"], twin["results"])):
        if not (r.finish_reason == t.finish_reason == "length" and r.completion_tokens == STORM_NEW):
            raise AssertionError(f"{name}: row {i} ended {r.finish_reason} after {r.completion_tokens}")
        if run["frames"][i] != r.token_ids:
            raise AssertionError(f"{name}: row {i} streamed {len(run['frames'][i])} frames for "
                                 f"{len(r.token_ids)} tokens")
        partings.append(same_or_close(torch, run["engine"], bulk[i], r.token_ids, t.token_ids,
                                      f"{name} row {i} vs its twin"))
    out["rows_equal_twin"] = sum(x["equal"] for x in partings)
    out["partings"] = [x for x in partings if not x["equal"]]
    for res in run["resumes"]:
        cold = math.ceil(res["total"] / chunk)
        warm = math.ceil((res["total"] - res["prefix_hit"]) / chunk)
        res["chunk_hits"], res["chunks_computed"], res["chunks_cold"] = res["prefix_hit"] // chunk, warm, cold
        if res["chunk_hits"] < 1 or warm >= cold:
            raise AssertionError(f"{name}: a resume was not warm: {res}")
    if len(run["resumes"]) != len(run["preempted"]):
        raise AssertionError(f"{name}: {len(run['preempted'])} preemptions, {len(run['resumes'])} resumes")
    out["seconds"] = time.perf_counter() - t0
    print(f"  {name}: rows equal to their twins {out['rows_equal_twin']}/{STORM_BULK}; resumes "
          f"{run['resumes']}")
    print_launches(name, out["launches"])
    print(f"  {name}: {out['seconds']:.1f}s")
    return out


def run_tenancy_lora(torch, cfg, params) -> dict:
    """The LoRA and tenancy phase at Llama-3-8B widths and the depth of
    ``cfg`` (``PLANE_DEPTH`` in ``run_engine``), one engine after another: L1 dense bf16 and L2 paged int8 with a registry
    of three rank-16 adapters; T1 dense bf16 and T2 paged bf16 with the
    tenant storm."""
    from gofr_tpu_torch import EngineConfig
    from gofr_tpu_torch.serving import AdapterRegistry, make_adapter

    rng = torch.Generator().manual_seed(SEED + 3)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    t0 = time.perf_counter()
    adapters = [make_adapter(cfg, f"adapter-{i}", rank=LORA_RANK, seed=i, scale=LORA_SCALE)
                for i in (1, 2, 3)]
    reg = AdapterRegistry(max_active=4)
    for ad in adapters:
        reg.register(ad)
    out = {}
    try:
        out["L1"] = lora_path(torch, cfg, params, "L1", EngineConfig(
            max_slots=8, max_seq_len=2048, kv_layout="dense", multi_step=4,
            prefill_chunk_tokens=256), reg, adapters, prompt)
        torch.cuda.empty_cache()
        out["L2"] = lora_path(torch, cfg, params, "L2", EngineConfig(
            max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=32, kv_dtype="int8",
            multi_step=4, prefill_chunk_tokens=256), reg, adapters, prompt)
        torch.cuda.empty_cache()
    finally:
        reg.close()
    # a step budget that grants every cursor its next chunk in each
    # dispatch: the 8 rows prefill in step, so all of them have
    # GOLD_AFTER tokens out at once (one chunk an iteration, the auto
    # budget, would finish the first row before the last one starts)
    storm = dict(max_slots=8, max_seq_len=1024, multi_step=4, prefill_chunk_tokens=256,
                 step_token_budget=8 * 256 + 8 * 4, prefix_cache_entries=64,
                 prefix_cache_bytes=2 << 30)
    out["T1"] = tenancy_path(torch, cfg, params, "T1", dict(storm, kv_layout="dense"), prompt)
    out["T2"] = tenancy_path(torch, cfg, params, "T2", dict(storm, kv_layout="paged", kv_page_size=16),
                             prompt)
    out["seconds"] = time.perf_counter() - t0
    launches = {k: out[k]["launches"] for k in ("L1", "L2", "T1", "T2")}
    print(f"  LoRA and tenancy: launches {launches}; {out['seconds']:.1f}s")
    if not (launches["L1"]["flash_attention"] and launches["T1"]["flash_attention"]
            and launches["T2"]["paged_decode_attention"] and launches["L2"]["paged_decode_attention_q"]):
        raise AssertionError(f"LoRA and tenancy launches {launches}")
    return out


# ------------------------------------------------------------------ healing
HANG_S = 6.0  # H1: how long engine.step hangs
THAW_EXIT_S = 10.0  # H1: the thawed thread exits within this of the thaw
REBUILD_SLACK = 64 << 20  # H2: memory_allocated after the rebuild, against before


def mib(torch) -> float:
    return torch.cuda.memory_allocated() / 2**20


def zero_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def since(mark: dict) -> dict:
    """Launches of each kernel since the ``launch_counts()`` snapshot."""
    return {n: v - mark[n] for n, v in launch_counts().items()}


class StateLog:
    """A metrics sink for the supervisor: it sets ``app_engine_supervisor_state``
    on every transition (0 UP, 1 SUSPECT, 2 RESTARTING, 3 WEDGED), so each
    change is stamped here, on the supervisor's thread, as it happens.
    SUSPECT lasts microseconds before the restart begins: a health_check
    poller may never see it, this log always does."""

    NAMES = {0.0: "UP", 1.0: "SUSPECT", 2.0: "RESTARTING", 3.0: "WEDGED"}

    def __init__(self) -> None:
        self.changes: list[tuple[float, str]] = []
        self.counters: dict[str, int] = {}

    def set_gauge(self, name, value, *labels, **kw) -> None:
        if name == "app_engine_supervisor_state":
            state = self.NAMES[float(value)]
            if not self.changes or self.changes[-1][1] != state:
                self.changes.append((time.monotonic(), state))

    def increment_counter(self, name, *labels, **kw) -> None:
        self.counters[name] = self.counters.get(name, 0) + 1

    def states(self) -> list[str]:
        return [state for _, state in self.changes]


class HealthPoller:
    """Polls ``engine.health_check()["status"]`` every 5 ms on a thread of
    its own and keeps each change with its time."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.changes: list[tuple[float, str]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="health-poller")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(0.005):
            status = self.engine.health_check()["status"]
            if not self.changes or self.changes[-1][1] != status:
                self.changes.append((time.monotonic(), status))

    def stop(self) -> list[str]:
        self._stop.set()
        self._thread.join(timeout=10)
        return [status for _, status in self.changes]


def in_order(seq: list, wanted: list) -> bool:
    """``wanted`` appears in ``seq`` in order (not necessarily adjacent)."""
    it = iter(seq)
    return all(any(x == w for x in it) for w in wanted)


def timed_restarts(torch, engine, record: list) -> None:
    """Wrap ``engine.warm_restart`` (the supervisor calls it through the
    instance) to record its wall time, whether the loop had crashed, and
    memory_allocated before and after."""
    real = engine.warm_restart

    def timed(*args, **kw):
        entry = {"loop_crashed": engine.loop_crashed, "mib_before": mib(torch)}
        t0 = time.perf_counter()
        try:
            entry["ok"] = real(*args, **kw)
        finally:
            entry["ms"] = (time.perf_counter() - t0) * 1e3
            entry["mib_after"] = mib(torch)
            entry["t_end"] = time.monotonic()
            record.append(entry)
        return entry["ok"]

    engine.warm_restart = timed


def timed_rebuilds(torch, engine, record: list) -> None:
    """Record memory_allocated around each in-place KV rebuild."""
    real = engine._rebuild_kv

    def timed():
        entry = {"mib_before": mib(torch)}
        real()
        entry["mib_after"] = mib(torch)
        record.append(entry)

    engine._rebuild_kv = timed


def healing_h1(torch, cfg, params, prompt) -> dict:
    """H1: a supervised dense bf16 engine (2048, 4 slots, N=4) with device
    telemetry. A fresh 200-token request with zero restarts; then four
    running 200-token rows and four queued (two greedy, two sampled); once
    each running row has 8 tokens out engine.step hangs 6 s. Requires
    SUSPECT, RESTARTING, UP; one restart; the running rows a retriable
    503; the queued rows the tokens of a clean engine of the same
    configuration (same ids, same order); flash launching after the
    restart for every requeued prefill; the thawed thread gone within 10 s
    of the thaw."""
    from gofr_tpu_torch import EngineConfig, ServingEngine, chaos, errors
    from gofr_tpu_torch.serving import DeviceTelemetry, EngineSupervisor
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    conf = dict(max_slots=4, max_seq_len=2048, kv_layout="dense", multi_step=4)
    run_prompts = [prompt(200) for _ in range(4)]
    queued_prompts = [prompt(200) for _ in range(4)]
    sampling = [dict(), dict(), dict(temperature=0.8, top_k=50), dict(temperature=0.8, top_k=50)]
    print(f"engine H1: dense bf16 max_seq_len=2048, 4 slots, N=4, {cfg.n_layers} layers, "
          f"supervised (stall 2 s, join 1 s, budget 3): a hang of {HANG_S:g} s at engine.step")
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size), seed=SEED)
    states = StateLog()
    sup = EngineSupervisor(engine, metrics=states, stall_s=2.0, poll_s=0.1, join_timeout=1.0,
                           restart_budget=3)
    tel = DeviceTelemetry(engine, interval_s=0.5)
    restarts: list = []
    timed_restarts(torch, engine, restarts)
    hang_started: list = []
    hang = chaos.hang_factory(HANG_S)

    def hang_once(point, nth):
        hang_started.append(time.monotonic())
        return hang(point, nth)

    out: dict = {}
    poller = None
    zero_launches()  # the engine's own launches, read after its twin
    try:
        sup.start()
        tel.start()
        first = engine.submit(prompt(200), max_new_tokens=16).result(timeout=600)
        if sup.restarts or first.finish_reason not in ("stop", "length"):
            raise AssertionError(f"H1: a fresh engine restarted {sup.restarts} time(s) "
                                 f"({sup.last_reason}) serving its first request")
        out["first_request_ms"] = first.duration_s * 1e3
        seen = [[] for _ in run_prompts]
        running = [engine.submit(p, max_new_tokens=64, stream_cb=lambda t, s, d, i=i:
                                 None if d else seen[i].append(t))
                   for i, p in enumerate(run_prompts)]
        first_token_at: dict = {}
        queued = [engine.submit(p, max_new_tokens=32, stream_cb=lambda t, s, d, i=i:
                                None if d else first_token_at.setdefault(i, time.monotonic()),
                                **sampling[i])
                  for i, p in enumerate(queued_prompts)]
        wait_until(lambda: all(len(x) >= 8 for x in seen), 600, "8 tokens out on every running row")
        if engine._sched.stats()["total_admitted"] != 5:
            raise AssertionError("H1: a queued request was admitted before the hang")
        old_thread = engine._thread
        exited: list = []  # when the quarantined thread is gone
        threading.Thread(target=lambda: (old_thread.join(), exited.append(time.monotonic())),
                         daemon=True).start()
        mark = launch_counts()
        out["mib_before_hang"] = mib(torch)
        poller = HealthPoller(engine)
        chaos.install(chaos.ChaosInjector(SEED, {"engine.step": 1.0}, max_faults=1,
                                          fault_factories={"engine.step": hang_once}))
        try:
            for i, fut in enumerate(running):
                try:
                    fut.result(timeout=600)
                    raise AssertionError(f"H1: running row {i} finished through the hang")
                except errors.ErrorServiceUnavailable as exc:
                    if exc.retry_after is None:
                        raise AssertionError("H1: a 503 without a retry-after") from exc
            results = [f.result(timeout=600) for f in queued]
            out["mib_after_restart"] = restarts[0]["mib_after"] if restarts else None
            wait_until(lambda: exited, HANG_S + THAW_EXIT_S, "the quarantined thread to exit")
            thread_exit_s = exited[0] - hang_started[0]
            after_restart = since(mark)
            out["mib_after_thaw"] = mib(torch)
        finally:
            chaos.uninstall()
        health = poller.stop()
        poller = None
        out["device"] = engine.health_check()["details"]["device"]
        out["restarts"] = sup.restarts
    finally:
        if poller is not None:
            poller.stop()
        tel.stop()
        sup.stop()
    suspect_t = next((t for t, st in states.changes if st == "SUSPECT"), None)
    out["supervisor_states"] = states.states()
    out["health_statuses"] = health
    out["detection_latency_ms"] = (suspect_t - hang_started[0]) * 1e3 if suspect_t else None
    out["warm_restart_ms"] = restarts[0]["ms"] if restarts else None
    out["thread_exit_after_hang_s"] = thread_exit_s
    out["queued_ttft_ms"] = [r.ttft_s * 1e3 for r in results]
    first_after = min(first_token_at.values()) if first_token_at else None
    out["first_requeued_token_after_restart_ms"] = (
        (first_after - restarts[0]["t_end"]) * 1e3 if restarts and first_after else None)
    flash = after_restart["flash_attention"]
    out["launches_after_restart"] = after_restart
    # the clean twin: the queued requests alone, under the same ids, in the
    # same order, on a fresh engine of the same configuration
    twin = ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size), seed=SEED)
    twin._next_id = queued[0].request_id - 1
    try:
        twin_futs = [twin.submit(p, max_new_tokens=32, **sampling[i])
                     for i, p in enumerate(queued_prompts)]
        if [f.request_id for f in twin_futs] != [f.request_id for f in queued]:
            raise AssertionError("H1: the twin's request ids differ")
        twin.start()
        twin_results = [f.result(timeout=600) for f in twin_futs]
    finally:
        twin.stop()
    del twin
    torch.cuda.empty_cache()
    out["queued_equal_clean"] = [r.token_ids == t.token_ids for r, t in zip(results, twin_results)]
    out["launches"] = launch_counts()  # the supervised engine and its twin
    out["seconds"] = time.perf_counter() - t0
    print(f"  H1: supervisor {out['supervisor_states']}, health {health}; restarts {sup.restarts}; "
          f"detection {out['detection_latency_ms']:.1f} ms after the hang began; warm_restart "
          f"{out['warm_restart_ms']:.1f} ms; first requeued token "
          f"{out['first_requeued_token_after_restart_ms']:.1f} ms after it (queued TTFTs "
          f"{[round(x, 1) for x in out['queued_ttft_ms']]} ms from submit)")
    print(f"  H1: memory_allocated {out['mib_before_hang']:.1f} MiB before the hang, "
          f"{out['mib_after_restart']:.1f} after the restart, {out['mib_after_thaw']:.1f} after the "
          f"thaw; the thawed thread exited {thread_exit_s:.2f} s after the hang began")
    print(f"  H1: details.device {out['device']}")
    print(f"  H1: queued rows equal to a clean engine's {out['queued_equal_clean']}; flash launches "
          f"after the restart {flash}; {out['seconds']:.1f}s")
    if not (in_order(out["supervisor_states"], ["SUSPECT", "RESTARTING", "UP"])
            and in_order(health, ["RESTARTING", "UP"])):
        raise AssertionError(f"H1: states {out['supervisor_states']}, health {health}")
    if sup.restarts != 1 or not all(r.finish_reason in ("stop", "length") for r in results):
        raise AssertionError(f"H1: {sup.restarts} restarts, queued {[r.finish_reason for r in results]}")
    if not all(out["queued_equal_clean"]):
        raise AssertionError(f"H1: queued rows against the clean engine {out['queued_equal_clean']}")
    if flash < 4 * cfg.n_layers:
        raise AssertionError(f"H1: {flash} flash launches after the restart")
    if thread_exit_s > HANG_S + THAW_EXIT_S:
        raise AssertionError(f"H1: the thawed thread exited {thread_exit_s:.1f} s after the hang")
    return out


def healing_h2(torch, cfg, params, prompt) -> dict:
    """H2: device loss recovered in place on paged int8 KV (32-token pages,
    4096, 256-token chunks, 8 slots; supervisor poison threshold 3). The
    eight prompts (one of 1000 tokens, chunked) are served once; then eight
    rows decode and ``device.loss`` fires once at a dispatch. Requires the
    rows to fail with DeviceLost, one poisoning and no restart, a clean
    ``torch.cuda.synchronize()`` (no kernel launched on the poisoned
    pools), memory_allocated after the rebuild within 64 MiB of before the
    fault, and the same prompts served again through the int8 paged kernel
    with the first run's greedy tokens (or parting only where the dense
    forward's logits of the two tokens lie within GAP_TOL, as the earlier
    phases allow)."""
    from gofr_tpu_torch import EngineConfig, ServingEngine, chaos
    from gofr_tpu_torch.serving import EngineSupervisor
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    conf = dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32, kv_dtype="int8",
                multi_step=4, prefill_chunk_tokens=256)
    prompts = [prompt(1000)] + [prompt(200) for _ in range(7)]
    print(f"engine H2: paged int8 page=32 max_seq_len=4096 chunk=256, 8 slots, {cfg.n_layers} "
          "layers, supervised (poison threshold 3): device.loss once at a decode dispatch")
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size), seed=SEED)
    sup = EngineSupervisor(engine, stall_s=30.0, poll_s=0.1, poison_threshold=3)
    rebuilds: list = []
    timed_rebuilds(torch, engine, rebuilds)
    out: dict = {}
    zero_launches()
    try:
        sup.start()
        before = [f.result(timeout=600) for f in [engine.submit(p, max_new_tokens=16) for p in prompts]]
        seen = [[] for _ in prompts]
        futs = [engine.submit(p, max_new_tokens=64, stream_cb=lambda t, s, d, i=i:
                              None if d else seen[i].append(t)) for i, p in enumerate(prompts)]
        wait_until(lambda: all(seen), 600, "every row decoding")
        out["mib_before_fault"] = mib(torch)
        with chaos.active(chaos.ChaosInjector(SEED, {"device.loss": 1.0}, max_faults=1)):
            lost = 0
            for fut in futs:
                try:
                    fut.result(timeout=600)
                except chaos.DeviceLost:
                    lost += 1
        torch.cuda.synchronize()  # raises on a kernel that ran on the poisoned pools
        wait_until(lambda: not engine._kv_unhealthy(), 60, "the rebuilt pools")
        out["mib_after_rebuild"] = mib(torch)
        out["rebuild_mib"] = rebuilds
        out["device_poisonings"] = engine.device_poisonings
        mark = launch_counts()
        after = [f.result(timeout=600) for f in [engine.submit(p, max_new_tokens=16) for p in prompts]]
        out["launches_after_rebuild"] = since(mark)
        out["launches"] = launch_counts()
        out["restarts"] = sup.restarts
        # greedy runs of one prompt: equal, or parting only where the dense
        # forward's logits of the two tokens lie within GAP_TOL
        out["equal_before_after"] = [
            same_or_close(torch, engine, p, a.token_ids, b.token_ids, f"H2 prompt {i}")["equal"]
            for i, (p, a, b) in enumerate(zip(prompts, after, before))]
    finally:
        sup.stop()
    del engine
    torch.cuda.empty_cache()
    out["rows_lost"] = lost
    out["seconds"] = time.perf_counter() - t0
    print(f"  H2: {lost}/8 rows failed with DeviceLost; poisonings {out['device_poisonings']}, "
          f"restarts {out['restarts']}; memory_allocated {out['mib_before_fault']:.1f} MiB before the "
          f"fault, {out['mib_after_rebuild']:.1f} after the rebuild ({rebuilds}); synchronize clean")
    print(f"  H2: the same prompts after the rebuild equal the first run's {out['equal_before_after']}; "
          f"launches after the rebuild {out['launches_after_rebuild']}; {out['seconds']:.1f}s")
    if lost != 8 or out["device_poisonings"] != 1 or out["restarts"] != 0:
        raise AssertionError(f"H2: lost {lost}, poisonings {out['device_poisonings']}, "
                             f"restarts {out['restarts']}")
    if abs(out["mib_after_rebuild"] - out["mib_before_fault"]) * 2**20 > REBUILD_SLACK:
        raise AssertionError(f"H2: memory_allocated {out['mib_before_fault']:.1f} -> "
                             f"{out['mib_after_rebuild']:.1f} MiB across the rebuild")
    if not out["launches_after_rebuild"]["paged_decode_attention_q"]:
        raise AssertionError(f"H2: launches after the rebuild {out['launches_after_rebuild']}")
    return out


def healing_h3(torch, cfg, params, prompt) -> dict:
    """H3: a poison storm on paged bf16 KV (16-token pages, 2048):
    ``device.loss`` at every decode dispatch, three times; the supervisor
    (poison threshold 2, budget 5) escalates to a warm restart. Requires
    at least one restart, then a probe served through the bf16 paged
    kernel. Prints memory_allocated around each rebuild and restart."""
    from gofr_tpu_torch import EngineConfig, ServingEngine, chaos, errors
    from gofr_tpu_torch.serving import EngineSupervisor
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4)
    print(f"engine H3: paged bf16 page=16 max_seq_len=2048, {cfg.n_layers} layers, supervised "
          "(poison threshold 2, budget 5): device.loss at every decode dispatch, 3 times")
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size), seed=SEED)
    sup = EngineSupervisor(engine, stall_s=30.0, poll_s=0.1, poison_threshold=2, restart_budget=5)
    rebuilds, restarts, outcomes = [], [], []
    timed_rebuilds(torch, engine, rebuilds)
    timed_restarts(torch, engine, restarts)
    out: dict = {}
    zero_launches()
    try:
        sup.start()
        with chaos.active(chaos.ChaosInjector(SEED, {"device.loss": 1.0}, max_faults=3)) as inj:
            t_end = time.monotonic() + 300
            while inj.stats()["device.loss"]["faults"] < 3 or not sup.restarts:
                if time.monotonic() > t_end:
                    raise AssertionError(f"H3: {inj.stats()}, restarts {sup.restarts}")
                try:
                    res = engine.submit(prompt(100), max_new_tokens=8).result(timeout=600)
                    outcomes.append(res.finish_reason)
                except (chaos.ChaosFault, errors.ErrorServiceUnavailable) as exc:
                    outcomes.append(type(exc).__name__)
                    wait_until(lambda: not engine._restarting, 60, "the restart to end")
        mark = launch_counts()
        probe = None
        for _ in range(20):  # a probe that lands in a restart window is retried
            try:
                probe = engine.submit(prompt(100), max_new_tokens=8).result(timeout=600)
                break
            except errors.ErrorServiceUnavailable:
                wait_until(lambda: not engine._restarting, 60, "the restart to end")
        out["launches_after_restart"] = since(mark)
        out["launches"] = launch_counts()
        out["restarts"] = sup.restarts
        out["device_poisonings"] = engine.device_poisonings
    finally:
        sup.stop()
    del engine
    torch.cuda.empty_cache()
    out["outcomes"] = outcomes
    out["rebuild_mib"] = rebuilds
    out["restart_mib"] = [{k: r[k] for k in ("mib_before", "mib_after", "ms")} for r in restarts]
    out["seconds"] = time.perf_counter() - t0
    print(f"  H3: outcomes {outcomes}; poisonings {out['device_poisonings']}, restarts "
          f"{out['restarts']}; memory_allocated around each rebuild {rebuilds}, each restart "
          f"{out['restart_mib']}")
    print(f"  H3: probe {probe.finish_reason if probe else None}; launches after the restart "
          f"{out['launches_after_restart']}; {out['seconds']:.1f}s")
    if out["restarts"] < 1 or probe is None or probe.finish_reason not in ("stop", "length") \
            or not out["launches_after_restart"]["paged_decode_attention"]:
        raise AssertionError(f"H3: restarts {out['restarts']}, probe {probe}, "
                             f"{out['launches_after_restart']}")
    return out


def healing_h4(torch, cfg, params, prompt) -> dict:
    """H4: a crash, then the budget spent (dense bf16, 2048, 2 slots,
    budget 2). engine.step raises once: the loop dies, the supervisor sees
    ``loop_crashed`` and restarts once, and a request is served through
    flash. Then engine.step raises at every call (three faults): the
    engine is parked WEDGED, stopped, every submitted future settles with
    a typed error within 10 s, and a second stop() is harmless."""
    from gofr_tpu_torch import EngineConfig, ServingEngine, chaos, errors
    from gofr_tpu_torch.serving import EngineSupervisor
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    conf = dict(max_slots=2, max_seq_len=2048, kv_layout="dense", multi_step=4)
    print(f"engine H4: dense bf16 max_seq_len=2048, 2 slots, {cfg.n_layers} layers, supervised "
          "(budget 2): engine.step raises once, then at every call")
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size), seed=SEED)
    sup = EngineSupervisor(engine, poll_s=0.1, restart_budget=2)
    restarts: list = []
    timed_restarts(torch, engine, restarts)
    out: dict = {}
    zero_launches()
    try:
        sup.start()
        with chaos.active(chaos.ChaosInjector(SEED, {"engine.step": 1.0}, max_faults=1)):
            wait_until(lambda: sup.restarts == 1, 60, "the restart after the crash")
        out["crash_seen"] = restarts[0]["loop_crashed"]
        out["crash_reason"] = sup.last_reason
        mark = launch_counts()
        served = engine.submit(prompt(200), max_new_tokens=8).result(timeout=600)
        out["launches_after_restart"] = since(mark)
        out["served"] = served.finish_reason
        futs, refused = [], []
        with chaos.active(chaos.ChaosInjector(SEED, {"engine.step": 1.0}, max_faults=3)):
            for _ in range(4):
                try:
                    futs.append(engine.submit(prompt(100), max_new_tokens=8))
                except errors.HTTPError as exc:
                    refused.append(exc.status_code)
            wait_until(lambda: sup.state == "WEDGED", 60, "the engine parked WEDGED")
            t_park = time.monotonic()
            settled = []
            for fut in futs:
                try:
                    fut.result(timeout=max(10.0 - (time.monotonic() - t_park), 0.01))
                    settled.append("result")
                except errors.HTTPError as exc:
                    settled.append(exc.status_code)
            settle_s = time.monotonic() - t_park
        out["status"] = engine.health_check()["status"]
        out["running"] = engine._running
        engine.stop(join_timeout=5.0)  # a second stop: harmless
        out["status_after_second_stop"] = engine.health_check()["status"]
        out["restarts"] = sup.restarts
        out["launches"] = launch_counts()
    finally:
        sup.stop()
    del engine
    torch.cuda.empty_cache()
    out.update(settled=settled, refused=refused, settle_s=settle_s,
               restart_ms=[r["ms"] for r in restarts], seconds=time.perf_counter() - t0)
    print(f"  H4: crash seen by the restart {out['crash_seen']} ({out['crash_reason']}); served "
          f"{out['served']}, launches {out['launches_after_restart']}; then {out['status']} after "
          f"{out['restarts']} restarts (warm_restart ms {[round(x, 1) for x in out['restart_ms']]}), "
          f"running {out['running']}, futures {settled} in {settle_s:.2f} s, refused {refused}, "
          f"after a second stop {out['status_after_second_stop']}; {out['seconds']:.1f}s")
    if not (out["crash_seen"] and out["served"] in ("stop", "length")
            and out["launches_after_restart"]["flash_attention"]):
        raise AssertionError(f"H4: crash seen {out['crash_seen']}, served {out['served']}, "
                             f"{out['launches_after_restart']}")
    if out["status"] != "WEDGED" or out["running"] or out["status_after_second_stop"] != "WEDGED" \
            or "result" in settled or settle_s > 10.0 or out["restarts"] != 2:
        raise AssertionError(f"H4: {out}")
    return out


def run_healing(torch, cfg, params) -> dict:
    """The healing phase at Llama-3-8B widths and ``cfg``'s depth
    (``PLANE_DEPTH`` in ``run_engine``), one engine after another: H1 hang
    and quarantine, H2 device loss in place, H3 a poison storm, H4 a crash
    then the budget spent. Never provokes a real CUDA fault."""
    rng = torch.Generator().manual_seed(SEED + 4)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    t0 = time.perf_counter()
    out = {}
    for name, fn in (("H1", healing_h1), ("H2", healing_h2), ("H3", healing_h3), ("H4", healing_h4)):
        out[name] = fn(torch, cfg, params, prompt)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    for name in ("H1", "H2", "H3", "H4"):
        print_launches(name, out[name]["launches"])
    print(f"  healing: {out['seconds']:.1f}s")
    return out


# -------------------------------------------------------------- observability
OBS_COLD = [5, 31, 200, 777, 1000]  # O1's cold prompts: 777 and 1000 chunk at 256
OBS_SAMPLED = 31  # the cold prompt that samples
OBS_NEW = 16
OBS_BULK, OBS_BULK_PROMPT, OBS_BULK_NEW, OBS_GOLD_AFTER = 8, 600, 48, 8
OBS_TIMING_ROWS, OBS_TIMING_PROMPT, OBS_TIMING_NEW = 8, 64, 64
OBS_O2_LENS = [5, 31, 200, 120, 60, 1000, 9, 450]  # O2's first set; 200 is the repeated prompt
# O2's device tier over a 1 GiB host tier, a layer of depth (64 MiB at 32
# layers): an entry's bytes grow with the depth, and the tier must evict
OBS_TIER_BYTES_A_LAYER = 2 << 20
TTFT_SLACK_S = 2e-3  # timeline TTFT against GenerationResult.ttft_s
LATENCY_KEYS = {"in_flight", "completed", "ttft_ms_p50", "queue_wait_ms_p50", "e2e_ms_p50"}
PHASE_ORDER = ("submitted", "admitted", "prefill_start", "prefill_end", "first_token", "detok_done")


class Gate:
    """Holds an engine's loop at its next step plan while a request set is
    submitted: the set starts in one iteration, so an engine and its twin
    run the same sequence of dispatches."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self._hold, self._parked, self._go = threading.Event(), threading.Event(), threading.Event()
        real = engine._plan_step

        def plan():
            if self._hold.is_set():
                self._parked.set()
                self._go.wait(120)
            return real()

        engine._plan_step = plan

    @contextlib.contextmanager
    def closed(self):
        self._go.clear()
        self._parked.clear()
        self._hold.set()
        self.engine._wake.set()
        if not self._parked.wait(120):
            raise AssertionError("the engine loop did not reach the gate")
        try:
            yield
        finally:
            self._hold.clear()
            self._go.set()
            self.engine._wake.set()


class SyncProbe:
    """Counts, on one engine, its dispatches (``_dispatch`` calls that
    launched), the ``_block_sync`` reads (the engine module's hook, on
    this engine's loop thread), the
    ``_first_token`` syncs and the monolithic admissions
    (``_commit_prefilled``), the first tokens committed that are not a
    resume's, each ``_record_prefix_tier`` call and each preemption."""

    def __init__(self, engine) -> None:
        from gofr_tpu_torch.serving import engine as engine_mod

        self.n = {"dispatches": 0, "block_syncs": 0, "first_token_syncs": 0,
                  "monolithic_admissions": 0, "first_tokens": 0}
        self.tiers: list[tuple[int, str]] = []
        self.preempted: list[tuple[int, int]] = []
        self.reading = 0  # a _block_sync call in progress
        self._mod, self._real_sync = engine_mod, engine_mod._block_sync

        def sync(packed):
            if threading.current_thread() is not engine._thread:
                return self._real_sync(packed)  # another engine's read
            self.n["block_syncs"] += 1
            self.reading += 1
            try:
                return self._real_sync(packed)
            finally:
                self.reading -= 1

        engine_mod._block_sync = sync
        dispatch, first, commit = engine._dispatch, engine._first_token, engine._commit_prefilled
        commit_first, tier, preempt = (engine._commit_first_token, engine._record_prefix_tier,
                                       engine._preempt)

        def counted_dispatch(plan):
            rec = dispatch(plan)
            self.n["dispatches"] += rec is not None
            return rec

        def counted_first(req, logits):
            self.n["first_token_syncs"] += 1
            return first(req, logits)

        def counted_commit(*args):
            self.n["monolithic_admissions"] += 1
            return commit(*args)

        def counted_commit_first(slot, req, first_id):
            self.n["first_tokens"] += req.first_token_at is None
            return commit_first(slot, req, first_id)

        def recorded_tier(req, t):
            self.tiers.append((req.id, t))
            return tier(req, t)

        def recorded_preempt(slot):
            req = engine.slots[slot]
            self.preempted.append((req.id, len(req.tokens)))
            return preempt(slot)

        engine._dispatch, engine._first_token = counted_dispatch, counted_first
        engine._commit_prefilled, engine._commit_first_token = counted_commit, counted_commit_first
        engine._record_prefix_tier, engine._preempt = recorded_tier, recorded_preempt

    def close(self) -> None:
        self._mod._block_sync = self._real_sync


class MetricTap:
    """Keeps every value a Manager records for a few series while it is
    open: the block time, the host ms per step and the block size, one of
    each per block read."""

    NAMES = ("app_decode_block_seconds", "app_decode_host_ms_per_step", "app_decode_block_size")

    def __init__(self, manager) -> None:
        self.values: dict[str, list] = {n: [] for n in self.NAMES}
        self.open = False
        record, gauge = manager.record_histogram, manager.set_gauge

        def tapped_record(name, value, *labels, **kw):
            if self.open and name in self.values:
                self.values[name].append(value)
            return record(name, value, *labels, **kw)

        def tapped_gauge(name, value, *labels, **kw):
            if self.open and name in self.values:
                self.values[name].append(value)
            return gauge(name, value, *labels, **kw)

        manager.record_histogram, manager.set_gauge = tapped_record, tapped_gauge

    def blocks(self) -> list[tuple[float, float, int]]:
        """(block seconds, host ms per step, steps) of each decode block read."""
        v = self.values
        return [(s, h, int(n)) for s, h, n in zip(v["app_decode_block_seconds"],
                                                   v["app_decode_host_ms_per_step"],
                                                   v["app_decode_block_size"]) if n > 0]


def percentile(xs, q: float):
    """The nearest-rank ``q``-th percentile (the upper middle at 50)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q / 100))] if xs else None


def median(xs):
    return percentile(xs, 50)


def engine_idle(engine, probe) -> bool:
    """No row in a slot, no dispatch left to read and no read in progress:
    the loop touches the card no more until the next submit. (A sync's
    warning is raised when its op returns, so a read that starts inside a
    window and returns outside it would be lost.)"""
    return not engine._inflight and all(s is None for s in engine.slots) and not probe.reading


def settle(engine, probe, what: str) -> None:
    """Wait for the engine to be idle, twice 50 ms apart (a read popped but
    not yet started when first seen has started, or ended, by the second),
    and for its spill worker to have copied every eviction to the host
    tier: each set's spills land in its own window, and the next set's
    lookups find them there on an engine and its twin alike."""
    for _ in range(2):
        wait_until(lambda: engine_idle(engine, probe), 120, what)
        time.sleep(0.05)
    wait_until(lambda: engine_idle(engine, probe), 120, what)
    flush = getattr(engine._prefix_cache, "flush", None)
    if flush is not None and not flush(timeout=120):
        raise AssertionError(f"{what}: the spill worker did not settle")


def sync_warnings(torch, engine, probe, fn) -> tuple[object, int]:
    """Run ``fn()`` with ``torch.cuda.set_sync_debug_mode("warn")``, from an
    idle engine until it is idle again (the pipeline's last reads land
    after the results), and count the synchronizing-operation warnings
    raised on any thread meanwhile, by the Python line that raised them."""
    import warnings

    settle(engine, probe, "the engine to go idle")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            settle(engine, probe, "the engine to go idle")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites: dict = {}
    for w in caught:
        # not the once-per-process note that the mode is a prototype
        if "called a synchronizing CUDA operation" in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return out, sites


def outcome(fut, timeout: float = 600):
    """A GenerationResult, or the status code the request failed with."""
    try:
        return fut.result(timeout=timeout)
    except Exception as exc:
        code = getattr(exc, "status_code", None)
        if code is None:
            raise
        return code


def obs_submit(engine, tracer, callers: dict, name: str, ids: list[int], **kw):
    """Submit one request of the phase, with a caller span of its own as
    ``trace_ctx`` on an instrumented engine; a refused submit gives its
    status code."""
    caller = tracer.start_span(f"caller {name}", activate=False) if tracer is not None else None
    try:
        fut = engine.submit(ids, trace_ctx=caller, **kw)
    except Exception as exc:
        if caller is not None:
            caller.end()
        code = getattr(exc, "status_code", None)
        if code is None:
            raise
        return code
    if caller is not None:
        callers[fut.request_id] = (name, caller)
    return fut


def o1_traffic(engine, gate, tracer, prompt_of) -> tuple[dict, dict]:
    """O1's request sets, each submitted behind the gate: the cold prompts,
    a row canceled mid-stream, a queued 504, a metered tenant's request
    and its 429; the whole-prompt and chunk-chain hits; the tenant storm
    with its preemption; the timing set. Returns (outcome by name,
    the caller spans by request id)."""
    callers, out, state = {}, {}, {}
    consume = engine._consume

    def hooked(rec):
        consume(rec)
        for req in engine.slots:
            if req is not None and req.id == state.get("cancel") and len(req.tokens) >= 4:
                engine.cancel(req.id)
        rows = [r for r in engine.slots if r is not None and r.tenant == "bulk"]
        if ("gold" not in state and len(rows) == OBS_BULK
                and max(len(r.tokens) for r in rows) >= OBS_GOLD_AFTER):
            state["gold"] = obs_submit(engine, tracer, callers, "gold", prompt_of("gold", 200),
                                       max_new_tokens=OBS_NEW, tenant="gold")

    engine._consume = hooked
    sub = lambda name, ids, **kw: obs_submit(engine, tracer, callers, name, ids, **kw)  # noqa: E731
    futs = {}
    with gate.closed():
        for n in OBS_COLD:
            kw = dict(temperature=0.8, top_k=40) if n == OBS_SAMPLED else {}
            futs[f"cold{n}"] = sub(f"cold{n}", prompt_of(f"cold{n}", n), max_new_tokens=OBS_NEW,
                                   **kw)
        futs["cancel"] = sub("cancel", prompt_of("cancel", 120), max_new_tokens=64)
        state["cancel"] = futs["cancel"].request_id
        futs["expired"] = sub("expired", prompt_of("expired", 50), max_new_tokens=8, deadline=0.02)
        futs["metered"] = sub("metered", prompt_of("metered", 31), max_new_tokens=32,
                              tenant="metered")
        out["over_budget"] = sub("over_budget", prompt_of("metered", 31), max_new_tokens=32,
                                 tenant="metered")
        time.sleep(0.1)  # the 504's deadline passes while it waits
    out.update({name: outcome(f) for name, f in futs.items()})
    futs = {}
    with gate.closed():
        futs["hit200"] = sub("hit200", prompt_of("cold200", 200), max_new_tokens=OBS_NEW)
        futs["hit1000"] = sub("hit1000", prompt_of("cold1000", 1000), max_new_tokens=OBS_NEW)
    out.update({name: outcome(f) for name, f in futs.items()})
    futs = {}
    with gate.closed():
        for i in range(OBS_BULK):
            futs[f"bulk{i}"] = sub(f"bulk{i}", prompt_of(f"bulk{i}", OBS_BULK_PROMPT),
                                   max_new_tokens=OBS_BULK_NEW, tenant="bulk")
    out.update({name: outcome(f) for name, f in futs.items()})
    wait_until(lambda: "gold" in state, 60, "O1: the interactive request")
    out["gold"] = outcome(state["gold"])
    engine._consume = consume
    return out, callers


def o2_traffic(engine, gate, tracer, prompt_of) -> tuple[dict, dict]:
    """O2's request sets behind the gate: eight prompts (1000 and 450
    chunk); the 200-token one again; two more 200-token prompts, which
    push it out of the 64 MiB device tier; a flush of the spill worker;
    then the 200-token prompt once more, from the host tier."""
    callers, out = {}, {}
    sub = lambda name, ids, **kw: obs_submit(engine, tracer, callers, name, ids, **kw)  # noqa: E731
    sets = [[(f"first{n}", n) for n in OBS_O2_LENS], [("again200", 200)],
            [("filler0", 200), ("filler1", 200)], [("host200", 200)]]
    for k, request_set in enumerate(sets):
        if k == 3:
            engine._prefix_cache.flush()
        futs = {}
        with gate.closed():
            for name, n in request_set:
                key = "first200" if name in ("again200", "host200") else name
                futs[name] = sub(name, prompt_of(key, n), max_new_tokens=OBS_NEW)
        out.update({name: outcome(f) for name, f in futs.items()})
    return out, callers


def timing_set(torch, engine, probe, gate, tracer, prompt_of, callers,
               suffix: str) -> tuple[list, dict]:
    """The timing set: OBS_TIMING_ROWS greedy rows of OBS_TIMING_PROMPT
    tokens and OBS_TIMING_NEW new ones, started together, under
    ``set_sync_debug_mode("warn")``. Returns (results, warnings by site)."""

    def run():
        futs = []
        with gate.closed():
            for i in range(OBS_TIMING_ROWS):
                futs.append(obs_submit(engine, tracer, callers, f"timing{i}{suffix}",
                                       prompt_of(f"timing{i}", OBS_TIMING_PROMPT),
                                       max_new_tokens=OBS_TIMING_NEW))
        return [outcome(f) for f in futs]

    return sync_warnings(torch, engine, probe, run)


def obs_engine(torch, cfg, params, conf: dict, instrumented: bool, telemetry: bool = False):
    """An engine of the phase, started: with a Manager carrying the serving
    catalog and a Tracer over an in-memory exporter, or bare (the twin)."""
    from gofr_tpu_torch import EngineConfig, ServingEngine
    from gofr_tpu_torch.metrics import new_metrics_manager
    from gofr_tpu_torch.serving import DeviceTelemetry, TenantPolicy, TenantRegistry
    from gofr_tpu_torch.serving import register_serving_metrics
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    from gofr_tpu_torch.tracing import InMemoryExporter, SimpleSpanProcessor, Tracer

    tenants = TenantRegistry()
    tenants.set_policy(TenantPolicy(name="gold", deadline_class="interactive", deadline_s=600.0))
    tenants.set_policy(TenantPolicy(name="bulk", deadline_class="batch", deadline_s=600.0))
    tenants.set_policy(TenantPolicy(name="metered", deadline_class="standard", token_rate=0.5,
                                    burst_tokens=64.0))
    manager = tracer = exporter = None
    if instrumented:
        manager = register_serving_metrics(new_metrics_manager())
        exporter = InMemoryExporter()
        tracer = Tracer("chip-smoke", SimpleSpanProcessor(exporter))
    engine = ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size),
                           seed=SEED, tenants=tenants, metrics=manager, tracer=tracer)
    tel = DeviceTelemetry(engine, interval_s=0.5) if telemetry else None
    return engine, manager, tracer, exporter, tel



FAILED_REASON = {504: "deadline_exceeded", 429: "shed", 503: "unavailable", 413: "too_large"}


def check_observed(label: str, engine, manager, tracer, exporter, callers: dict, outcomes: dict,
                   probe, cold_chunks: dict, want_tiers: dict) -> dict:
    """The phase's checks of one instrumented engine after its drain (its
    caller spans ended): timelines, spans, metrics and the health view.
    ``cold_chunks`` maps a request to the chunk count of its cold prompt,
    ``want_tiers`` a request to the tier that must have served it."""
    from collections import Counter

    from gofr_tpu_torch import GenerationResult
    from gofr_tpu_torch.metrics import lint_exposition

    def fail(msg):
        raise AssertionError(f"{label}: {msg}")

    if engine.timeline.in_flight():
        fail(f"{len(engine.timeline.in_flight())} timelines still in flight after the drain")
    tls = {tl.request_id: tl for tl in engine.timeline.completed()}
    if sorted(tls) != sorted(callers):
        fail(f"timelines {sorted(tls)} for the request ids {sorted(callers)}")
    preempted = {rid for rid, _ in probe.preempted}
    by_name, ttft_gap = {}, 0.0
    for rid, (name, _caller) in callers.items():
        tl, res = tls[rid], outcomes[name]
        by_name[name] = tl
        want = res.finish_reason if isinstance(res, GenerationResult) else FAILED_REASON[res]
        if tl.terminal_marks != 1 or tl.finish_reason != want:
            fail(f"{name}: {tl.terminal_marks} terminal marks, reason {tl.finish_reason} "
                 f"for {want}")
        stamps = [tl.phases[p] for p in PHASE_ORDER if p in tl.phases]
        if stamps != sorted(stamps):
            fail(f"{name}: stamps out of order: {tl.to_dict()['phases_ms']}")
        if isinstance(res, GenerationResult) and "first_token" in tl.phases:
            gap = abs(tl.ttft_s() - res.ttft_s)
            ttft_gap = max(ttft_gap, gap)
            if gap > TTFT_SLACK_S:
                fail(f"{name}: timeline TTFT {tl.ttft_s():.6f} s, result {res.ttft_s:.6f} s")
        if (rid in preempted) != any(p.startswith("preempted:") for p in tl.phases):
            fail(f"{name}: preempted {rid in preempted}, stamps {sorted(tl.phases)}")
    for name, n in cold_chunks.items():
        tl = by_name[name]
        if tl.request_id in preempted:
            continue  # its resume adds chunks
        if [c["prefix_hit"] for c in tl.prefill_chunks] != [False] * n:
            fail(f"{name}: chunks {tl.prefill_chunks}, a cold prompt of {n}")
    # tiers: the first walk of each request is its timeline's, and the
    # counter counts every walk (a resume walks again)
    first_tier: dict = {}
    for rid, tier in probe.tiers:
        first_tier.setdefault(rid, tier)
    for rid, (name, _) in callers.items():
        if tls[rid].prefix_tier != first_tier.get(rid):
            fail(f"{name}: timeline tier {tls[rid].prefix_tier}, walked {first_tier.get(rid)}")
        if name in want_tiers and tls[rid].prefix_tier != want_tiers[name]:
            fail(f"{name}: served from {tls[rid].prefix_tier}, not {want_tiers[name]}")
    hits = manager.get("app_kv_prefix_hits_total")
    counted = {k: hits.value(dict(k)) for k in hits._series}
    walked = {(("tier", t),): float(n) for t, n in Counter(t for _, t in probe.tiers).items()}
    if counted != walked:
        fail(f"app_kv_prefix_hits_total {counted}, walks {walked}")
    # spans: each request's tree hangs off its caller's span
    spans: dict = {}
    for s in exporter.spans:
        if "request.id" in s.attributes:
            spans.setdefault(s.attributes["request.id"], []).append(s)
    for rid, (name, caller) in callers.items():
        mine = spans.get(rid, [])
        queue = [s for s in mine if s.name == "engine.queue"]
        if len(queue) != 1 or queue[0].parent_id != caller.span_id:
            fail(f"{name}: engine.queue spans {[(s.name, s.parent_id) for s in queue]}")
        if any(s.trace_id != caller.trace_id for s in mine):
            fail(f"{name}: a span outside its caller's trace")
        stray = [s.name for s in mine if s.name.startswith("serve.")
                 and s.parent_id != queue[0].span_id]
        if stray:
            fail(f"{name}: serve spans not under engine.queue: {stray}")
        computed = sum(not c["prefix_hit"] for c in tls[rid].prefill_chunks)
        chunk_spans = sum(s.name == "serve.prefill_chunk" for s in mine)
        if chunk_spans != computed:
            fail(f"{name}: {chunk_spans} chunk spans for {computed} computed chunks")
    if tracer.open_spans() != 0:
        fail(f"{tracer.open_spans()} spans open after the drain")
    # metrics
    results = [r for r in outcomes.values() if isinstance(r, GenerationResult)]
    ttft_n = manager.get("app_ttft_seconds").snapshot()[1]
    e2e = manager.get("app_request_e2e_seconds")
    e2e_n = sum(e2e.snapshot(dict(k))[1] for k in e2e._series)
    if ttft_n != probe.n["first_tokens"] or e2e_n != len(results):
        fail(f"app_ttft_seconds count {ttft_n} for {probe.n['first_tokens']} first tokens, "
             f"app_request_e2e_seconds count {e2e_n} for {len(results)} results")
    problems = lint_exposition(manager.expose_prometheus())
    if problems:
        fail(f"the exposition does not lint: {problems[:5]}")
    latency = engine.health_check()["details"]["request_latency"]
    if set(latency) != LATENCY_KEYS or latency["completed"] != len(tls) or latency["in_flight"]:
        fail(f"request_latency {latency} over {len(tls)} completed timelines")
    durations: dict = {}
    for s in exporter.spans:
        if "request.id" in s.attributes:
            durations.setdefault(s.name, []).append(s.duration_us / 1e3)
    return {
        "timelines": len(tls), "spans": sum(len(v) for v in spans.values()),
        "ttft_count": ttft_n, "e2e_count": e2e_n, "max_ttft_gap_ms": ttft_gap * 1e3,
        "prefix_hits": {t: n for ((_, t),), n in walked.items()},
        "preemptions": {dict(k).get("tenant"): v for k, v in manager.get(
            "app_tenant_preemptions_total")._series.items()},
        "shed": {dict(k).get("tenant", ""): v for k, v in manager.get(
            "app_requests_shed_total")._series.items()},
        "request_latency": latency,
        "span_ms_p50": {n: median(v) for n, v in sorted(durations.items())},
    }


def observe_pair(torch, cfg, params, label: str, conf: dict, traffic, prompt_of, *,
                 telemetry: bool, cold_chunks: dict, want_tiers: dict) -> dict:
    """One configuration of the phase: the instrumented engine and its bare
    twin, both alive. The request sets run on the engine, then on the twin;
    the timing set in turns, engine, twin, twin, engine (the second turn of
    each finds its prompts in the prefix cache); the launches of each
    engine counted alone."""
    from gofr_tpu_torch import GenerationResult

    t0 = time.perf_counter()
    parts: dict = {}
    for role in ("engine", "twin"):
        engine, manager, tracer, exporter, tel = obs_engine(torch, cfg, params, conf,
                                                            role == "engine",
                                                            telemetry and role == "engine")
        parts[role] = {"engine": engine, "manager": manager, "tracer": tracer,
                       "exporter": exporter, "tel": tel, "probe": SyncProbe(engine),
                       "gate": Gate(engine), "tap": MetricTap(manager) if manager else None,
                       "launches": {}, "turns": []}
    try:
        for role in ("engine", "twin"):
            p = parts[role]
            mark = launch_counts()
            p["engine"].start()
            if p["tel"] is not None:
                p["tel"].start()
            p["outcomes"], p["callers"] = traffic(p["engine"], p["gate"], p["tracer"], prompt_of)
            if p["tel"] is not None:
                p["tel"].stop()  # its poll is not a request: keep it out of the sync count
            settle(p["engine"], p["probe"], f"{label} {role} to go idle")
            add_launches(p["launches"], since(mark))
        for turn, role in enumerate(("engine", "twin", "twin", "engine")):
            p = parts[role]
            k = len(p["turns"])
            mark, d0 = launch_counts(), p["probe"].n["dispatches"]
            if p["tap"] is not None:
                p["tap"].open = True
            timing, warns = timing_set(torch, p["engine"], p["probe"], p["gate"], p["tracer"],
                                       prompt_of, p["callers"], f".{k}")
            if p["tap"] is not None:
                p["tap"].open = False
            add_launches(p["launches"], since(mark))
            p["turns"].append({
                "turn": turn, "dispatches": p["probe"].n["dispatches"] - d0,
                "sync_warnings": sum(warns.values()), "sync_sites": warns,
                "ms_per_step": per_step_ms([r for r in timing if isinstance(r, GenerationResult)]),
            })
            p["outcomes"].update({f"timing{i}.{k}": r for i, r in enumerate(timing)})
        for role in ("engine", "twin"):
            if not parts[role]["engine"].drain(deadline_s=120):
                raise AssertionError(f"{label} {role}: the drain did not finish")
    finally:
        for role in ("twin", "engine"):  # the probes unwind in reverse
            p = parts[role]
            if p["tel"] is not None:
                p["tel"].stop()
            p["engine"].stop()
            p["probe"].close()
    runs: dict = {}
    for role in ("engine", "twin"):
        p = parts[role]
        for _name, caller in p["callers"].values():
            caller.end()
        probe = p["probe"]
        if probe.n["block_syncs"] != probe.n["dispatches"] or \
                probe.n["first_token_syncs"] != probe.n["monolithic_admissions"]:
            raise AssertionError(f"{label} {role}: syncs {probe.n}")
        run = {"launches": p["launches"], "syncs": dict(probe.n), "timing": p["turns"],
               "ms_per_step": median([t["ms_per_step"] for t in p["turns"]])}
        if role == "engine":
            run["checks"] = check_observed(label, p["engine"], p["manager"], p["tracer"],
                                           p["exporter"], p["callers"], p["outcomes"], probe,
                                           cold_chunks, want_tiers)
            blocks = p["tap"].blocks()
            run["decode_blocks_read"] = len(blocks)
            run["host_ms_per_step_p50"] = median([h for _, h, _ in blocks])
            run["block_ms_p50"] = median([s * 1e3 for s, _, _ in blocks])
            run["block_ms_per_step_p50"] = median([s * 1e3 / n for s, _, n in blocks])
            run["host_share_p50"] = median([h / (s * 1e3 / n) for s, h, n in blocks if s > 0])
            if p["tel"] is not None:
                m = p["manager"]
                run["hbm_used_bytes"] = m.get("app_tpu_hbm_used_bytes").value({"device": "0"})
                run["hbm_limit_bytes"] = m.get("app_tpu_hbm_limit_bytes").value({"device": "0"})
        run["outcomes"] = {n: (r.finish_reason, r.token_ids) if isinstance(r, GenerationResult)
                           else r for n, r in p["outcomes"].items()}
        runs[role] = run
    del parts
    torch.cuda.empty_cache()
    eng, twin = runs["engine"], runs["twin"]
    if set(eng["outcomes"]) != set(twin["outcomes"]):
        raise AssertionError(f"{label}: requests {sorted(eng['outcomes'])} against "
                             f"{sorted(twin['outcomes'])}")
    for name, got in eng["outcomes"].items():
        want = twin["outcomes"][name]
        sampled = name == f"cold{OBS_SAMPLED}"
        if (isinstance(got, tuple) != isinstance(want, tuple)
                or (isinstance(got, tuple) and not sampled and got != want)
                or (not isinstance(got, tuple) and got != want)):
            raise AssertionError(f"{label}: {name} gave {str(got)[:80]} with the instruments, "
                                 f"{str(want)[:80]} without")
    # the same turn of each (cold, then warm): equal sync warnings a dispatch
    per_dispatch = [[t["sync_warnings"] / max(t["dispatches"], 1) for t in r["timing"]]
                    for r in (eng, twin)]
    if per_dispatch[0] != per_dispatch[1]:
        raise AssertionError(f"{label}: sync warnings a dispatch {per_dispatch[0]} with the "
                             f"instruments ({[t['sync_sites'] for t in eng['timing']]}), "
                             f"{per_dispatch[1]} without "
                             f"({[t['sync_sites'] for t in twin['timing']]})")
    for run in (eng, twin):
        del run["outcomes"]
    steps = {r: [round(t["ms_per_step"], 3) for t in runs[r]["timing"]] for r in runs}
    print(f"  {label}: ms a decode step, timing turns engine, twin, twin, engine: "
          f"{steps['engine'][0]:.3f}, {steps['twin'][0]:.3f}, {steps['twin'][1]:.3f}, "
          f"{steps['engine'][1]:.3f}; app_decode_host_ms_per_step p50 "
          f"{eng['host_ms_per_step_p50']:.3f} against {eng['block_ms_per_step_p50']:.3f} ms a "
          f"step from app_decode_block_seconds (p50 {eng['block_ms_p50']:.3f} ms a block): host "
          f"share p50 {eng['host_share_p50']:.3f} (information)")
    print(f"  {label}: syncs {eng['syncs']} with, {twin['syncs']} without; sync warnings a "
          f"timing dispatch, cold then warm: {per_dispatch[0]}")
    print(f"  {label}: span p50 ms {eng['checks']['span_ms_p50']}")
    print_launches(f"{label}", eng["launches"])
    print_launches(f"{label} twin", twin["launches"])
    eng["seconds"] = time.perf_counter() - t0
    return {"engine": eng, "twin": twin}


def run_observability(torch, cfg, params) -> dict:
    """The observability phase at Llama-3-8B widths and the depth of ``cfg``
    (``PLANE_DEPTH`` in ``run_engine``): O1 dense
    bf16 and O2 paged int8, each instrumented (serving metrics catalog,
    tracer, caller spans) beside a bare twin."""
    rng = torch.Generator().manual_seed(SEED + 5)
    prompts: dict = {}

    def prompt_of(key: str, n: int) -> list[int]:
        if key not in prompts:
            prompts[key] = torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()
        return prompts[key]

    card = card_line()
    t0 = time.perf_counter()
    o1_conf = dict(max_slots=8, max_seq_len=2048, kv_layout="dense", multi_step=4,
                   prefill_chunk_tokens=256, prefix_cache_entries=64, prefix_cache_bytes=2 << 30)
    o2_conf = dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32,
                   kv_dtype="int8", multi_step=4, prefill_chunk_tokens=256,
                   prefix_cache_entries=64,
                   prefix_cache_bytes=OBS_TIER_BYTES_A_LAYER * cfg.n_layers,
                   kv_spill_bytes=1 << 30)
    print(f"engine O1: dense bf16 max_seq_len=2048, 8 slots, 256-token chunks, 2 GiB prefix cache, "
          f"{cfg.n_layers} layers, metrics + tracer, and its bare twin ({card})")
    o1 = observe_pair(
        torch, cfg, params, "O1", o1_conf, o1_traffic, prompt_of, telemetry=False,
        cold_chunks={"cold777": 4, "cold1000": 4, **{f"bulk{i}": 3 for i in range(OBS_BULK)}},
        want_tiers={"cold200": "miss", "cold1000": "miss", "hit200": "device",
                    "hit1000": "device"})
    for role in ("engine", "twin"):
        turns = o1[role]["timing"]
        print(f"  O1 {role}: {sum(t['sync_warnings'] for t in turns)} sync warnings over "
              f"{sum(t['dispatches'] for t in turns)} timing dispatches ({card})")
    if o1["engine"]["checks"]["preemptions"] != {"bulk": 1.0} or \
            o1["engine"]["checks"]["shed"].get("metered") != 1.0:
        raise AssertionError(f"O1: preemptions {o1['engine']['checks']['preemptions']}, "
                             f"shed {o1['engine']['checks']['shed']}")
    print(f"engine O2: paged int8 32-token pages, max_seq_len=4096, a "
          f"{OBS_TIER_BYTES_A_LAYER * cfg.n_layers >> 20} MiB device tier over a 1 GiB host tier, "
          f"{cfg.n_layers} layers, metrics + tracer + device telemetry, and its bare twin ({card})")
    o2 = observe_pair(
        torch, cfg, params, "O2", o2_conf, o2_traffic, prompt_of, telemetry=True,
        cold_chunks={"first1000": 4, "first450": 2},
        want_tiers={"first200": "miss", "host200": "host"})
    out = {"card": card, "O1": o1, "O2": o2, "seconds": time.perf_counter() - t0}
    print(f"  observability: {out['seconds']:.1f}s")
    hbm = tuple(o2["engine"].get(k, math.nan) for k in ("hbm_used_bytes", "hbm_limit_bytes"))
    if not all(v > 0 for v in hbm):
        raise AssertionError(f"O2: app_tpu_hbm_used_bytes / _limit_bytes for device 0: {hbm}")
    l1, l2 = o1["engine"]["launches"], o2["engine"]["launches"]
    if not (l1["flash_attention"] and l2["flash_attention"] and l2["paged_decode_attention_q"]):
        raise AssertionError(f"observability launches O1 {l1}, O2 {l2}")
    return out


# ------------------------------------------------------------------------ HA
HA_STORM = 8  # A1: threads that submit one key at once
HA_WINDOW = 16  # A1: the replay window, in frames
HA_GRACE_S = 2.0  # A1: the orphan grace
HA_NEW = 16  # M and D: new tokens a request


def kv_bytes(engine) -> int:
    """Bytes of an engine's KV storage: the page pool or the slot cache,
    K, V and (on int8) their scales."""
    holder = engine.paged_cache if engine.paged_cache is not None else engine.cache
    names = ("k_pool", "v_pool", "ks_pool", "vs_pool") if engine.paged_cache is not None \
        else ("k", "v", "ks", "vs")
    return sum(t.numel() * t.element_size() for t in
               (getattr(holder, n, None) for n in names) if t is not None)


def build_engine(torch, cfg, params, conf: dict, mem: dict, label: str, **kw):
    """A port engine on the card over the shared weights, with
    ``memory_allocated`` before and after it: an engine adds its KV and
    nothing of the weights (within 64 MiB: the rope table, host mirrors'
    device twins, the decode generator)."""
    from gofr_tpu_torch import EngineConfig, ServingEngine
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size),
                           seed=SEED, **kw)
    torch.cuda.synchronize()
    added, kv = torch.cuda.memory_allocated() - before, kv_bytes(engine)
    mem[label] = {"added_mib": added / 2**20, "kv_mib": kv / 2**20}
    print(f"  {label}: memory_allocated +{added / 2**20:.1f} MiB on building it, its KV "
          f"{kv / 2**20:.1f} MiB")
    if added > kv + (64 << 20):
        raise AssertionError(f"{label} added {added / 2**20:.1f} MiB, its KV is "
                             f"{kv / 2**20:.1f} MiB: the weights are not shared")
    return engine


class DispatchSpy:
    """Counts one engine's prefill computes (on its loop thread), ragged
    dispatches with their decode steps, and decode blocks while open."""

    def __init__(self, engine) -> None:
        from gofr_tpu_torch.serving import batch as batch_ops

        self.n = {"prefill": 0, "ragged": 0, "ragged_decode_steps": 0, "decode_blocks": 0}
        self._engine, self._mod = engine, batch_ops
        self._real = {n: getattr(batch_ops, n) for n in
                      ("prefill_compute", "decode_block", "decode_block_paged",
                       "decode_block_paged_q")}
        real_ragged = engine._dispatch_ragged

        def wrap(name, key):
            def fn(*a, **k):
                if threading.current_thread() is engine._thread:
                    self.n[key] += 1
                return self._real[name](*a, **k)
            return fn

        setattr(batch_ops, "prefill_compute", wrap("prefill_compute", "prefill"))
        for name in ("decode_block", "decode_block_paged", "decode_block_paged_q"):
            setattr(batch_ops, name, wrap(name, "decode_blocks"))

        def ragged(state, chunk_rows, steps):
            self.n["ragged"] += 1
            self.n["ragged_decode_steps"] += steps
            return real_ragged(state, chunk_rows, steps)

        engine._dispatch_ragged = ragged

    def close(self) -> None:
        for name, fn in self._real.items():
            setattr(self._mod, name, fn)
        del self._engine._dispatch_ragged


def ha_a1(torch, cfg, params, prompt, mem: dict) -> dict:
    """A1, paged int8 (4096, 32-token pages, 256-token chunks, 8 slots,
    N = 4, a 16-frame replay window): a keyed storm, a dropped and resumed
    stream, a resume behind the window, an orphan reaped, a fenced zombie
    after a warm restart."""
    from gofr_tpu_torch import ErrorEntityNotFound, ErrorStaleEpoch
    from gofr_tpu_torch.serving import ReplayGap

    conf = dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32,
                kv_dtype="int8", multi_step=4, prefill_chunk_tokens=256,
                stream_replay_tokens=HA_WINDOW, stream_orphan_grace_s=HA_GRACE_S)
    print(f"engine A1: paged int8 page=32 max_seq_len=4096 chunk=256, 8 slots, {cfg.n_layers} "
          f"layers, a {HA_WINDOW}-frame replay window")
    engine = build_engine(torch, cfg, params, conf, mem, "A1")
    out: dict = {}
    engine.start()
    try:
        # 8 threads, one key, a 200-token prompt sampled at T 0.8
        storm = prompt(200)
        admitted, done0 = engine._sched.stats()["total_admitted"], \
            engine.timeline.snapshot()["completed_count"]
        barrier, results, errors = threading.Barrier(HA_STORM), [None] * HA_STORM, []
        mark = launch_counts()

        def submit(i):
            try:
                barrier.wait(60)
                results[i] = engine.submit(storm, max_new_tokens=32, temperature=0.8, top_k=50,
                                           top_p=0.95, idempotency_key="a1-storm").result(600)
            except BaseException as exc:  # noqa: BLE001 - raised below
                errors.append(exc)

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(HA_STORM)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if errors:
            raise AssertionError(f"A1 storm: {errors[0]!r}")
        wait_until(lambda: engine.timeline.snapshot()["completed_count"] > done0, 60,
                   "A1's storm terminal mark")
        launches = since(mark)
        tl = engine.timeline.get(results[0].request_id)
        stats = engine.dedup_stats()
        out["storm"] = {
            "admissions": engine._sched.stats()["total_admitted"] - admitted,
            "timelines": engine.timeline.snapshot()["completed_count"] - done0,
            "terminal_marks": tl.terminal_marks,
            "identical": sum(r.token_ids == results[0].token_ids for r in results),
            "hits": stats["hits_live"] + stats["hits_terminal"], "launches": launches,
            "tokens": len(results[0].token_ids)}
        print(f"  A1 storm: {out['storm']}")
        s = out["storm"]
        if (s["admissions"], s["timelines"], s["terminal_marks"], s["identical"], s["hits"]) != \
                (1, 1, 1, HA_STORM, HA_STORM - 1) or launches["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"A1 storm: {s}")

        # a keyed 64-token stream dropped at its 10th frame, orphaned, resumed
        owner, at_ten, resumed = [], threading.Event(), threading.Event()

        def owner_cb(token_id, piece, done):
            owner.append((token_id, done))
            if len(owner) == 10:
                at_ten.set()
                resumed.wait(60)  # the client is gone; its frames stop here

        fut = engine.submit(prompt(100), max_new_tokens=64, idempotency_key="a1-resume",
                            stream_cb=owner_cb)
        wait_until(at_ten.is_set, 600, "A1's stream at frame 10")
        engine.orphan(fut.request_id, grace_s=HA_GRACE_S)
        frames = []
        t0 = time.perf_counter()
        rfut = engine.resume("a1-resume", last_seq=10,
                             stream_cb=lambda s_, t_, p_, d_: frames.append((s_, t_, d_)))
        resume_ms = (time.perf_counter() - t0) * 1e3
        resumed.set()
        r = rfut.result(600)
        wait_until(lambda: frames and frames[-1][2], 60, "A1's resumed terminal frame")
        n = len(r.token_ids)
        seqs = [f[0] for f in frames]
        joined = [t for t, _ in owner[:10]] + [t for _, t, d in frames if not d]
        out["resume"] = {"ms": resume_ms, "tokens": n, "frames": len(frames),
                         "first_seq": seqs[0], "last_seq": seqs[-1],
                         "once": seqs == list(range(11, n + 2)), "identical": joined == r.token_ids,
                         "same_future": rfut is fut}
        print(f"  A1 resume at last_seq=10: {out['resume']}")
        if not (out["resume"]["once"] and out["resume"]["identical"] and rfut is fut):
            raise AssertionError(f"A1 resume: {out['resume']}")

        # a resume behind the 16-frame window: ReplayGap, a 404 at the wire
        at_forty, go = threading.Event(), threading.Event()
        count = [0]

        def windowed_cb(token_id, piece, done):
            count[0] += not done
            if count[0] == 40:
                at_forty.set()
                go.wait(60)

        fut = engine.submit(prompt(100), max_new_tokens=48, idempotency_key="a1-window",
                            stream_cb=windowed_cb)
        wait_until(at_forty.is_set, 600, "A1's windowed stream at frame 40")
        try:
            gap = None
            try:
                engine._dedup.lookup("a1-window").replay.attach(2, lambda *a: None)
            except ReplayGap as exc:
                gap = exc
            try:
                engine.resume("a1-window", last_seq=2, stream_cb=lambda *a: None)
                wire = None
            except ErrorEntityNotFound as exc:
                wire = (exc.status_code, exc.name)
        finally:
            go.set()
        fut.result(600)
        out["window"] = {"replay_gap": repr(gap), "wire": wire}
        print(f"  A1 resume behind the window: {out['window']}")
        if gap is None or wire != (404, "replay window"):
            raise AssertionError(f"A1 window: {out['window']}")

        # an orphan with no resume: canceled within grace plus one block
        started = threading.Event()
        fut = engine.submit(prompt(100), max_new_tokens=400, idempotency_key="a1-orphan",
                            stream_cb=lambda t, p, d: started.set())
        wait_until(started.is_set, 600, "A1's orphan stream")
        t0 = time.monotonic()
        engine.orphan(fut.request_id)  # the config's grace, 2 s
        r = fut.result(600)
        settle_s = time.monotonic() - t0
        step_s = (r.duration_s - r.ttft_s) / max(len(r.token_ids) - 1, 1)
        check_clean(engine, "A1 orphan")
        out["orphan"] = {"reason": r.finish_reason, "tokens": len(r.token_ids),
                         "settled_after_s": settle_s, "block_s": 4 * step_s}
        print(f"  A1 orphan: {out['orphan']} (grace {HA_GRACE_S} s)")
        if r.finish_reason != "cancel" or settle_s > HA_GRACE_S + 4 * step_s + 0.25:
            raise AssertionError(f"A1 orphan: {out['orphan']}")

        # a zombie with the epoch from before a warm restart
        old = engine.epoch
        if not engine.warm_restart(join_timeout=30.0):
            raise AssertionError("A1: warm_restart stood down")
        ids = engine._next_id
        try:
            engine.submit(prompt(20), max_new_tokens=4, fence_epoch=old,
                          idempotency_key="a1-zombie")
            fenced = None
        except ErrorStaleEpoch as exc:
            fenced = exc.status_code
        fresh = engine.submit(prompt(20), max_new_tokens=4, fence_epoch=engine.epoch).result(600)
        out["fence"] = {"status": fenced, "ids_taken": engine._next_id - ids - 1,
                        "epochs": (old, engine.epoch), "fresh": fresh.finish_reason,
                        "dedup": engine.dedup_stats()}
        print(f"  A1 fence: {out['fence']}")
        if fenced != 409 or out["fence"]["ids_taken"] != 0:
            raise AssertionError(f"A1 fence: {out['fence']}")
        out["launches"] = since(mark)
    finally:
        engine.stop()
    del engine
    torch.cuda.empty_cache()
    return out


def ha_m(torch, cfg, params, prompt, mem: dict) -> dict:
    """M, paged bf16 (2048, 16-token pages, 256-token chunks, 64-entry
    prefix caches): a source serves a 1000-token chunked prompt and a
    200-token whole one; a destination whose migrator holds the source
    serves both with no prefill compute; then a kv.migrate fault on a
    prompt that shares the first two chunks."""
    from gofr_tpu_torch import chaos
    from gofr_tpu_torch.metrics import new_metrics_manager
    from gofr_tpu_torch.serving import (KVMigrator, PrefixIndex, local_engine_fetcher,
                                        register_serving_metrics)

    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                prefill_chunk_tokens=256, prefix_cache_entries=64, prefix_cache_bytes=2 << 30)
    print(f"engines M: paged bf16 page=16 max_seq_len=2048 chunk=256, 64-entry prefix caches, "
          f"{cfg.n_layers} layers: a source and a destination migrating from it")
    manager = register_serving_metrics(new_metrics_manager())
    index = PrefixIndex()
    migrator = KVMigrator("dst", index, metrics=manager)
    src = build_engine(torch, cfg, params, conf, mem, "M source")
    dst = build_engine(torch, cfg, params, conf, mem, "M destination", kv_migrator=migrator,
                       metrics=manager)
    migrator.add_peer("src", local_engine_fetcher(src))
    long_p, short_p = prompt(1000), prompt(200)
    shared = long_p[:512] + prompt(488)  # two chunks shared with long_p
    out: dict = {}
    src.start(), dst.start()
    try:
        mark0 = mark = launch_counts()
        cold = {name: src.submit(p, max_new_tokens=HA_NEW).result(600)
                for name, p in (("long", long_p), ("short", short_p))}
        out["source_launches"] = since(mark)
        print(f"  M source, cold: {out['source_launches']}")
        if out["source_launches"]["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"M source launches {out['source_launches']}: the 200-token "
                                 "prompt prefills whole, one flash launch a layer")
        index.observe("src", 1, src.prefix_advertisement(256))
        spy, mark = DispatchSpy(dst), launch_counts()
        try:
            warm = {name: dst.submit(p, max_new_tokens=HA_NEW).result(600)
                    for name, p in (("long", long_p), ("short", short_p))}
            counts = dict(spy.n)
        finally:
            spy.close()
        launches = since(mark)
        tiers = {name: dst.timeline.get(r.request_id).prefix_tier for name, r in warm.items()}
        migrations = manager.get("app_kv_migrations_total").value()
        out["migrated"] = {
            "equal": {n: warm[n].token_ids == cold[n].token_ids for n in warm},
            "ttft_ms": {n: (cold[n].ttft_s * 1e3, warm[n].ttft_s * 1e3) for n in warm},
            "dispatches": counts, "launches": launches, "tiers": tiers,
            "app_kv_migrations_total": migrations}
        print(f"  M migrated: {out['migrated']}")
        for n in warm:
            print(f"  M TTFT {n} prompt: cold {cold[n].ttft_s * 1e3:.2f} ms on the source, "
                  f"migrated {warm[n].ttft_s * 1e3:.2f} ms on the destination")
        if not all(out["migrated"]["equal"].values()) or counts["prefill"] or counts["ragged"] \
                or launches["flash_attention"] or not launches["paged_decode_attention"] \
                or migrations != 2 or set(tiers.values()) != {"remote"}:
            raise AssertionError(f"M migrated: {out['migrated']}")
        want = src.submit(shared, max_new_tokens=HA_NEW).result(600)
        index.observe("src", 2, src.prefix_advertisement(256))
        spy = DispatchSpy(dst)
        try:
            with chaos.active(chaos.ChaosInjector(SEED, {"kv.migrate": 1.0}, max_faults=1)):
                got = dst.submit(shared, max_new_tokens=HA_NEW).result(600)
            counts = dict(spy.n)
        finally:
            spy.close()
        tl = dst.timeline.get(got.request_id)
        chunks = [(c["start"], c["tokens"], c["prefix_hit"]) for c in tl.prefill_chunks]
        out["fault"] = {"equal": got.token_ids == want.token_ids, "chunks": chunks,
                        "dispatches": counts, "failed_fetches": migrator.failed_fetches_total,
                        "app_kv_migrations_total": manager.get("app_kv_migrations_total").value()}
        print(f"  M kv.migrate fault: {out['fault']}")
        if not out["fault"]["equal"] or chunks[0] != (0, 512, True) \
                or sum(c[1] for c in chunks if not c[2]) != 488 or migrator.failed_fetches_total != 1:
            raise AssertionError(f"M fault: {out['fault']}")
        out["launches"] = since(mark0)
    finally:
        src.stop(), dst.stop()
    del src, dst
    torch.cuda.empty_cache()
    return out


def ha_d(torch, cfg, params, prompt, mem: dict) -> dict:
    """D, dense bf16 (the reference's default layout; 2048, 256-token
    chunks, 64-entry prefix caches): a unified engine's tokens first, then
    a prefill engine and a decode engine; the handoff, then a kv.handoff
    fault on a second prompt."""
    from gofr_tpu_torch import chaos
    from gofr_tpu_torch.metrics import new_metrics_manager
    from gofr_tpu_torch.serving import (KVMigrator, PrefixIndex, local_engine_fetcher,
                                        register_serving_metrics)

    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="dense", multi_step=4,
                prefill_chunk_tokens=256, prefix_cache_entries=64, prefix_cache_bytes=2 << 30)
    print(f"engines D: dense bf16 max_seq_len=2048 chunk=256, 64-entry prefix caches, "
          f"{cfg.n_layers} layers: unified, then prefill and decode roles")
    p1, p2 = prompt(1000), prompt(1000)
    out: dict = {}
    unified = build_engine(torch, cfg, params, conf, mem, "D unified")
    unified.start()
    try:
        want = [unified.submit(p, max_new_tokens=HA_NEW).result(600) for p in (p1, p2)]
    finally:
        unified.stop()
    del unified
    torch.cuda.empty_cache()
    manager = register_serving_metrics(new_metrics_manager())
    migrator = KVMigrator("decode", PrefixIndex(), metrics=manager)
    pre = build_engine(torch, cfg, params, {**conf, "role": "prefill"}, mem, "D prefill")
    dec = build_engine(torch, cfg, params, {**conf, "role": "decode"}, mem, "D decode",
                       kv_migrator=migrator, metrics=manager)
    migrator.add_peer("prefill", local_engine_fetcher(pre))
    pre.start(), dec.start()
    try:
        frames = []
        spy, mark = DispatchSpy(pre), launch_counts()
        try:
            r = pre.submit(p1, max_new_tokens=HA_NEW, prefill_only=True,
                           stream_cb=lambda t, p, d: frames.append((t, d))).result(600)
            pcounts = dict(spy.n)
        finally:
            spy.close()
        out["prefill_only"] = {"reason": r.finish_reason, "tokens": len(r.token_ids),
                               "frames": frames, "dispatches": pcounts, "launches": since(mark)}
        print(f"  D prefill_only: {out['prefill_only']}")
        if r.finish_reason != "handoff" or r.token_ids or frames != [(-1, True)] \
                or pcounts["decode_blocks"] or pcounts["ragged_decode_steps"]:
            raise AssertionError(f"D prefill_only: {out['prefill_only']}")
        spy, mark = DispatchSpy(dec), launch_counts()
        try:
            got = dec.submit(p1, max_new_tokens=HA_NEW, handoff_from="prefill").result(600)
            dcounts = dict(spy.n)
        finally:
            spy.close()
        handoffs = manager.get("app_kv_handoffs_total").value()
        out["handoff"] = {"equal": got.token_ids == want[0].token_ids, "dispatches": dcounts,
                          "tier": dec.timeline.get(got.request_id).prefix_tier,
                          "ttft_ms": (want[0].ttft_s * 1e3, got.ttft_s * 1e3),
                          "app_kv_handoffs_total": handoffs, "launches": since(mark)}
        print(f"  D handoff: {out['handoff']}")
        print(f"  D TTFT 1000-token prompt: unified {want[0].ttft_s * 1e3:.2f} ms, handed off "
              f"{got.ttft_s * 1e3:.2f} ms")
        if not out["handoff"]["equal"] or dcounts["prefill"] or dcounts["ragged"] \
                or handoffs != 1 or out["handoff"]["tier"] != "remote":
            raise AssertionError(f"D handoff: {out['handoff']}")
        pre.submit(p2, max_new_tokens=HA_NEW, prefill_only=True).result(600)
        spy = DispatchSpy(dec)
        try:
            with chaos.active(chaos.ChaosInjector(SEED, {"kv.handoff": 1.0}, max_faults=1)):
                got2 = dec.submit(p2, max_new_tokens=HA_NEW, handoff_from="prefill").result(600)
            fcounts = dict(spy.n)
        finally:
            spy.close()
        out["fault"] = {"equal": got2.token_ids == want[1].token_ids, "dispatches": fcounts,
                        "tier": dec.timeline.get(got2.request_id).prefix_tier,
                        "app_kv_handoffs_total": manager.get("app_kv_handoffs_total").value(),
                        "failed_fetches": migrator.failed_fetches_total}
        print(f"  D kv.handoff fault: {out['fault']}")
        if not out["fault"]["equal"] or fcounts["ragged"] < 4 or out["fault"]["tier"] != "miss" \
                or out["fault"]["app_kv_handoffs_total"] != 1:
            raise AssertionError(f"D fault: {out['fault']}")
    finally:
        pre.stop(), dec.stop()
    del pre, dec
    torch.cuda.empty_cache()
    return out


def run_ha(torch, cfg, params) -> dict:
    """The HA and cross-replica KV phase at Llama-3-8B widths and full
    depth, engines built two at a time over the one weight set: A1 keyed
    submits, resume, orphan and fencing on paged int8; M KV migration on
    paged bf16; D the P/D handoff on dense bf16."""
    rng = torch.Generator().manual_seed(SEED + 6)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    t0 = time.perf_counter()
    mem: dict = {}
    out = {"card": card_line()}
    for name, fn in (("A1", ha_a1), ("M", ha_m), ("D", ha_d)):
        out[name] = fn(torch, cfg, params, prompt, mem)
    out["memory"] = mem
    out["seconds"] = time.perf_counter() - t0
    launches = {name: out[name].get("launches", {}) for name in ("A1", "M")}
    for name, ln in launches.items():
        print_launches(name, ln)
    print(f"  ha: {out['seconds']:.1f}s ({out['card']})")
    if not (launches["A1"].get("paged_decode_attention_q") and launches["M"].get("flash_attention")
            and launches["M"].get("paged_decode_attention")):
        raise AssertionError(f"ha launches {launches}")
    return out


# ---------------------------------------------------------------- fleet phase
FLEET_BEAT_S = 0.2  # every replica's heartbeat on the broker
FLEET_NEW = 8  # new tokens of a request whose tokens are held to another run
FLEET_BURST, FLEET_BURST_LEN, FLEET_BURST_NEW = 32, 64, 64  # F3's burst on one replica
# F2's reclamation notice, the shortest a cloud gives (30 s on GCP and Azure,
# 120 s on AWS). The last interactive row has 31 tokens left at the notice, and
# the drain's share (0.65 of it) must hold them on a shared, busy host (PERF.md
# gives the times, from tools_torch/f2_reclaim_probe.py)
FLEET_NOTICE_S = 30.0


class FleetTier:
    """A router over port engines, each announced on one ``InMemoryBroker``
    every ``FLEET_BEAT_S`` (suspect and down timers generous, so a host
    busy with 8B dispatches never loses a beat to them); the router's
    metrics manager holds the serving catalog."""

    def __init__(self) -> None:
        from gofr_tpu_torch.metrics import new_metrics_manager
        from gofr_tpu_torch.pubsub import InMemoryBroker
        from gofr_tpu_torch.serving import Router, RouterConfig, register_serving_metrics

        self.manager = register_serving_metrics(new_metrics_manager())
        self.broker = InMemoryBroker(consumer_group="router", poll_timeout=0.05)
        self.router = Router(RouterConfig(heartbeat_s=FLEET_BEAT_S, suspect_after_s=5.0,
                                          down_after_s=20.0),
                             broker=self.broker, metrics=self.manager)
        self.router.start()
        self.announcers: dict = {}

    def announce(self, rid: str, engine):
        from gofr_tpu_torch.serving import ReplicaAnnouncer

        ann = ReplicaAnnouncer(rid, engine, self.broker, interval_s=FLEET_BEAT_S)
        self.announcers[rid] = ann
        ann.start()
        return ann

    def add(self, rid: str, engine, role: str | None = None) -> None:
        """Start the engine, register it with the router and announce it."""
        from gofr_tpu_torch.serving import LocalReplica

        engine.start()
        self.router.add_replica(LocalReplica(rid, engine, role=role))
        self.announce(rid, engine)

    def wait_up(self, *rids: str) -> None:
        m = self.router.membership
        wait_until(lambda: all(m.state_of(r) == "UP" for r in rids), 60, f"{rids} UP")

    def affine(self, rid: str, make) -> list[int]:
        """A prompt from ``make()`` whose affinity key lands on ``rid``."""
        for _ in range(400):
            p = make()
            if self.router._candidates_for(p)[0][:1] == [rid]:
                return p
        raise AssertionError(f"no prompt affine to {rid}")

    def close(self) -> None:
        for ann in self.announcers.values():
            ann.stop(final_beat=False)
            ann.engine = None
        self.announcers.clear()
        self.router.stop()


def cached_bytes(*engines) -> int:
    """Bytes of the distinct tensors the engines' prefix caches hold: an
    evacuated entry is one tensor on the source and the survivor."""
    seen, total = set(), 0
    for engine in engines:
        cache = engine._prefix_cache
        with cache._lock:  # the engine thread may put meanwhile
            values = list(cache._entries.values())
        for value in values:
            for t in value:
                if t.data_ptr() not in seen:
                    seen.add(t.data_ptr())
                    total += t.numel() * t.element_size()
    return total


def first_token_timer(t0: list):
    """A stream_cb that stamps the first token frame's time into ``t0``."""
    def cb(token_id, piece, done):
        if not done and len(t0) == 1:
            t0.append(time.perf_counter())
    return cb


def fleet_f1(torch, cfg, params, prompt, mem: dict) -> dict:
    """F1, the router tier over two paged bf16 replicas (2048, 16-token
    pages, 256-token chunks, 64-entry prefix caches): affinity with chain
    hits, a route fault's walk, a warm restart under a burst, a keyed
    duplicate, routerz and the router's series."""
    from gofr_tpu_torch import chaos
    from gofr_tpu_torch.metrics import lint_exposition
    from gofr_tpu_torch.serving.router import RETRIABLE_ERRORS

    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                prefill_chunk_tokens=256, prefix_cache_entries=64, prefix_cache_bytes=2 << 30)
    print(f"engines F1: paged bf16 page=16 max_seq_len=2048 chunk=256, 64-entry prefix caches, "
          f"{cfg.n_layers} layers: two replicas behind a router, heartbeats every "
          f"{FLEET_BEAT_S} s")
    tier = FleetTier()
    engines = {rid: build_engine(torch, cfg, params, conf, mem, f"F1 {rid}")
               for rid in ("f1-a", "f1-b")}
    out: dict = {}
    mark0 = launch_counts()
    try:
        for rid, engine in engines.items():
            tier.add(rid, engine)
        tier.wait_up(*engines)
        # 8 prompts sharing a 1000-token prefix, each with its own 20-token tail
        shared = prompt(1000)
        prompts = [shared + prompt(20) for _ in range(8)]
        affine = tier.router._candidates_for(prompts[0])[0][0]
        eng = engines[affine]
        rows = []
        for p in prompts:
            mark = launch_counts()
            r = tier.router.submit(p, max_new_tokens=FLEET_NEW).result(600)
            chunks = eng.timeline.get(r.request_id).prefill_chunks if r.replica_id == affine else []
            rows.append({"replica": r.replica_id, "ttft_ms": r.ttft_s * 1e3,
                         "hit_tokens": sum(c["tokens"] for c in chunks if c["prefix_hit"]),
                         "computed_chunks": sum(1 for c in chunks if not c["prefix_hit"]),
                         "flash": since(mark)["flash_attention"]})
        out["affinity"] = {"affine": affine, "requests": rows,
                           "share": sum(r["replica"] == affine for r in rows) / len(rows)}
        for i, row in enumerate(rows):
            print(f"  F1 affine request {i}: {row}")
        if out["affinity"]["share"] != 1.0 or (rows[0]["computed_chunks"], rows[0]["hit_tokens"]) \
                != (4, 0) or any((r["computed_chunks"], r["hit_tokens"]) != (1, 768) for r in rows[1:]):
            raise AssertionError(f"F1 affinity: {out['affinity']}")

        # a router.route fault on the first attempt: the walk takes the other replica
        p = tier.affine(affine, lambda: prompt(200))
        direct = eng.submit(p, max_new_tokens=FLEET_NEW).result(600)
        with chaos.active(chaos.ChaosInjector(SEED, {"router.route": 1.0}, max_faults=1)) as inj:
            r = tier.router.submit(p, max_new_tokens=FLEET_NEW).result(600)
        out["route_fault"] = {"replica": r.replica_id, "equal": r.token_ids == direct.token_ids,
                              "faults": inj.stats()["router.route"]["faults"]}
        print(f"  F1 router.route fault: {out['route_fault']}")
        if r.replica_id == affine or not out["route_fault"]["equal"] \
                or out["route_fault"]["faults"] != 1:
            raise AssertionError(f"F1 route fault: {out['route_fault']}")

        # warm_restart of the affine replica under a burst of 8 (4 affine to each)
        other = next(rid for rid in engines if rid != affine)
        burst = [tier.affine(rid, lambda: prompt(100)) for rid in (affine, other) for _ in range(4)]
        futs = [tier.router.submit(q, max_new_tokens=32) for q in burst]
        wait_until(lambda: any(s is not None and s.tokens for s in eng.slots), 600,
                   "F1: a burst row decoding on the affine replica")
        t0 = time.perf_counter()
        if not eng.warm_restart(join_timeout=30.0):
            raise AssertionError("F1: warm_restart stood down")
        restart_ms = (time.perf_counter() - t0) * 1e3
        outcomes = []
        for f in futs:
            try:
                res = f.result(600)
                outcomes.append(("ok", res.replica_id, res.finish_reason))
            except RETRIABLE_ERRORS as exc:
                outcomes.append(("retriable", type(exc).__name__))
        out["restart_burst"] = {"warm_restart_ms": restart_ms, "outcomes": outcomes,
                                "terminals": len(outcomes)}
        print(f"  F1 warm_restart under a burst: {out['restart_burst']}")
        if len(outcomes) != len(burst):
            raise AssertionError(f"F1 burst: {out['restart_burst']}")
        for rid, engine in engines.items():
            check_clean(engine, f"F1 {rid} after the burst")
        wait_until(lambda: tier.router.membership.epoch_of(affine) == eng.epoch, 30,
                   "F1: the restarted replica's epoch on a beat")

        # two keyed submits of one key: one admission, through router.claim
        p = prompt(200)
        admitted = {rid: e._sched.stats()["total_admitted"] for rid, e in engines.items()}
        f1 = tier.router.submit(p, max_new_tokens=FLEET_NEW, idempotency_key="f1-key")
        f2 = tier.router.submit(p, max_new_tokens=FLEET_NEW, idempotency_key="f1-key")
        r1, r2 = f1.result(600), f2.result(600)
        out["keyed"] = {"admissions": sum(e._sched.stats()["total_admitted"] - admitted[rid]
                                          for rid, e in engines.items()),
                        "same_replica": r1.replica_id == r2.replica_id,
                        "equal": r1.token_ids == r2.token_ids,
                        "dedup": engines[r1.replica_id].dedup_stats()}
        print(f"  F1 keyed duplicate: {out['keyed']}")
        if out["keyed"]["admissions"] != 1 or not (out["keyed"]["same_replica"]
                                                   and out["keyed"]["equal"]):
            raise AssertionError(f"F1 keyed: {out['keyed']}")

        z = tier.router.routerz()
        print(f"  F1 routerz: {json.dumps(z, default=str)}")
        text = tier.manager.expose_prometheus()
        series = ("app_router_replica_state", "app_router_failovers_total", "app_router_hedges_total",
                  "app_router_last_resort_routes_total", "app_router_queue_wait_seconds")
        out["series"] = {n: {"registered": f"# TYPE {n} " in text,
                             "samples": sum(line.startswith(n) for line in text.splitlines())}
                         for n in series}
        out["promlint"] = lint_exposition(text)
        out["counters"] = z["counters"]
        print(f"  F1 router series: {out['series']}, promlint {out['promlint']}")
        if not all(s["registered"] for s in out["series"].values()) or out["promlint"] \
                or not out["series"]["app_router_replica_state"]["samples"]:
            raise AssertionError(f"F1 series: {out['series']} {out['promlint']}")
        out["launches"] = since(mark0)
    finally:
        tier.close()
        for engine in engines.values():
            engine.stop()
    del engines, eng
    torch.cuda.empty_cache()
    return out


def fleet_f2(torch, cfg, params, prompt, mem: dict) -> dict:
    """F2, reclamation (paged bf16 as F1): a survivor and a preemptible
    replica built by a ``SimulatedPoolDriver``, their ``KVMigrator``s on
    one ``PrefixIndex``, the survivor the preemptible one's push peer;
    4 batch-class then 4 interactive rows of 1000-token prompts on the
    preemptible replica, then a notice."""
    import gc

    from gofr_tpu_torch import ErrorServiceUnavailable, chaos
    from gofr_tpu_torch.metrics import new_metrics_manager
    from gofr_tpu_torch.serving import (KVMigrator, LocalReplica, PrefixIndex, SimulatedPoolDriver,
                                        TenantPolicy, TenantRegistry, local_engine_store,
                                        register_serving_metrics, release_replica)

    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                prefill_chunk_tokens=256, prefix_cache_entries=64, prefix_cache_bytes=2 << 30)
    print(f"engines F2: paged bf16 page=16 max_seq_len=2048 chunk=256, 64-entry prefix caches, "
          f"{cfg.n_layers} layers: a survivor and a preemptible replica, a {FLEET_NOTICE_S:g} s "
          "notice")
    tier = FleetTier()
    index = PrefixIndex()
    tenants = TenantRegistry()
    tenants.set_policy(TenantPolicy(name="gold", deadline_class="interactive", deadline_s=600.0))
    tenants.set_policy(TenantPolicy(name="bulk", deadline_class="batch", deadline_s=600.0))
    engines, migrators, managers = {}, {}, {}

    def factory(role, rid, preemptible=False):
        manager = register_serving_metrics(new_metrics_manager())
        migrator = KVMigrator(rid, index, metrics=manager)
        engine = build_engine(torch, cfg, params, {**conf, "role": role, "preemptible": preemptible},
                              mem, f"F2 {rid}", kv_migrator=migrator, tenants=tenants,
                              metrics=manager)
        engine.start()
        handle = LocalReplica(rid, engine, role=role)
        handle.announcer = tier.announce(rid, engine)
        engines[rid], migrators[rid], managers[rid] = engine, migrator, manager
        return handle

    driver = SimulatedPoolDriver(tier.router, factory, on_reap=release_replica)
    out: dict = {}
    mark0 = launch_counts()
    try:
        (surv,) = driver.scale_up("unified", 1)
        (spot,) = driver.scale_up("unified", 1, preemptible=True)
        migrators[spot].add_push_peer(surv, local_engine_store(engines[surv]))
        tier.wait_up(surv, spot)
        bulk, gold = [prompt(1000) for _ in range(4)], [prompt(1000) for _ in range(4)]
        # the batch prompts cold on the survivor, whose cache is then emptied
        mark = launch_counts()
        cold = [engines[surv].submit(p, max_new_tokens=FLEET_NEW) for p in bulk]
        cold = [f.result(600) for f in cold]
        cold_chunks = [sum(1 for c in engines[surv].timeline.get(r.request_id).prefill_chunks
                           if not c["prefix_hit"]) for r in cold]
        cold_flash = since(mark)["flash_attention"]
        engines[surv]._prefix_cache.clear()

        e = engines[spot]
        firsts = {f"{kind}{i}": threading.Event() for kind in ("bulk", "gold") for i in range(4)}
        frames: dict = {name: [] for name in firsts}  # each row's frame times

        def first_frame(name):
            def on_frame(token_id, piece, done):
                frames[name].append(time.monotonic())
                firsts[name].set()
            return on_frame

        futs = {f"bulk{i}": e.submit(p, max_new_tokens=512, tenant="bulk",
                                     stream_cb=first_frame(f"bulk{i}"))
                for i, p in enumerate(bulk)}
        wait_until(lambda: all(firsts[f"bulk{i}"].is_set() for i in range(4)), 600,
                   "F2's batch rows decoding")
        futs |= {f"gold{i}": e.submit(p, max_new_tokens=32, tenant="gold",
                                      stream_cb=first_frame(f"gold{i}"))
                 for i, p in enumerate(gold)}
        settled: dict = {}  # each future's settling time
        for name, f in futs.items():
            f.add_done_callback(lambda _f, name=name: settled.setdefault(name, time.monotonic()))
        wait_until(lambda: all(ev.is_set() for ev in firsts.values()), 600,
                   "F2's interactive rows decoding")
        out["at_notice"] = {"gold_running": sum(s is not None and s.tenant == "gold"
                                                for s in e.slots)}
        summaries, real = [], e.begin_reclaim
        t_notice = time.monotonic()

        def recorded(deadline_s=None, **kw):
            summary = real(deadline_s, **kw)
            summaries.append((summary, time.monotonic() - t_notice))
            return summary

        e.begin_reclaim = recorded
        gc.collect()  # earlier phases' cyclic garbage is no part of this delta
        torch.cuda.synchronize()
        # the memory outside the prefix caches: the notice's page-outs and
        # the probe's entry land in the survivor's cache, which keeps them
        spot_kv, mem_before = kv_bytes(e), torch.cuda.memory_allocated()
        outside_before = mem_before - cached_bytes(e, engines[surv])
        t_notice = time.monotonic()
        if not driver.notice(spot, deadline_s=FLEET_NOTICE_S):
            raise AssertionError("F2: the notice was not delivered")
        wait_until(lambda: tier.router.membership.state_of(spot) == "RECLAIMING", 10,
                   "F2: RECLAIMING on a beat")
        to_reclaiming = time.monotonic() - t_notice
        probe = tier.router.submit(prompt(50), max_new_tokens=4).result(600)
        routable = tier.router.membership.candidates()
        outcomes = {}
        for name, f in futs.items():
            try:
                r = f.result(600)
                outcomes[name] = ("ok", r.finish_reason, len(r.token_ids))
            except ErrorServiceUnavailable as exc:
                outcomes[name] = ("retriable", exc.status_code, exc.retry_after)
        # a future's waiters wake before its callbacks run
        wait_until(lambda: len(settled) == len(futs), 10, "F2: the settling times")
        wait_until(lambda: summaries, 60, "F2: the reclaim ladder's end")
        summary, ladder_s = summaries[0]
        m = managers[spot]
        drain_hist = m.get("app_reclaim_drain_seconds").snapshot()
        out["reclaim"] = {
            "notice_to_reclaiming_s": to_reclaiming, "probe_replica": probe.replica_id,
            "routable": routable, "outcomes": outcomes, "summary": summary,
            "notice_to_committed_s": ladder_s,
            "frames_at_notice": {n: sum(t < t_notice for t in ts) for n, ts in frames.items()},
            "gold_last_frame_s": {n: frames[n][-1] - t_notice for n in frames
                                  if n.startswith("gold") and frames[n]},
            "bulk_settled_s": {n: settled[n] - t_notice for n in settled if n.startswith("bulk")},
            "app_replica_reclamations_total": m.get("app_replica_reclamations_total").value(),
            "app_kv_evacuations_total_committed": m.get("app_kv_evacuations_total").value(
                {"outcome": "committed"}),
            "app_reclaim_drain_seconds": {"sum": drain_hist[0], "count": drain_hist[1]}}
        print(f"  F2 reclaim: {out['reclaim']}")
        ev = summary["evacuation"]
        # the sweep sheds the batch rows first: every one settles before the
        # last interactive token, not when the drain's share runs out
        shed_first = max(out["reclaim"]["bulk_settled_s"].values()) \
            < max(out["reclaim"]["gold_last_frame_s"].values())
        if probe.replica_id != surv or spot in routable or not shed_first \
                or any(outcomes[f"gold{i}"][:2] != ("ok", "length") for i in range(4)) \
                or any(outcomes[f"bulk{i}"][:2] != ("retriable", 503) for i in range(4)) \
                or ev["outcome"] != "committed" or ev["target"] != surv \
                or ev["committed"] != ev["entries"] \
                or out["reclaim"]["app_replica_reclamations_total"] != 1 \
                or out["reclaim"]["app_kv_evacuations_total_committed"] != 1 or drain_hist[1] != 1:
            raise AssertionError(f"F2 reclaim: {out['reclaim']}")

        # the batch prompts again, through the router: the survivor's chain
        spy, mark = DispatchSpy(engines[surv]), launch_counts()
        try:
            again = [tier.router.submit(p, max_new_tokens=FLEET_NEW).result(600) for p in bulk]
            counts = dict(spy.n)
        finally:
            spy.close()
        tls = [engines[surv].timeline.get(r.request_id) for r in again]
        # the source computed these chunks beside other rows, the cold run
        # beside others again: equal tokens, or a parting inside GAP_TOL
        out["resumed"] = {
            "replicas": [r.replica_id for r in again],
            "equal": [same_or_close(torch, engines[surv], p, r.token_ids, c.token_ids,
                                    f"F2 batch prompt {i}")
                      for i, (p, r, c) in enumerate(zip(bulk, again, cold))],
            "computed_chunks": [sum(1 for c in tl.prefill_chunks if not c["prefix_hit"])
                                for tl in tls],
            "cold_computed_chunks": cold_chunks, "tiers": [tl.prefix_tier for tl in tls],
            "ttft_ms": [r.ttft_s * 1e3 for r in again],
            "cold_ttft_ms": [c.ttft_s * 1e3 for c in cold],
            "flash": since(mark)["flash_attention"], "cold_flash": cold_flash,
            "dispatches": counts}
        print(f"  F2 batch prompts resumed on the survivor: {out['resumed']}")
        res = out["resumed"]
        if set(res["replicas"]) != {surv} \
                or any(a >= b for a, b in zip(res["computed_chunks"], cold_chunks)) \
                or res["flash"] > cold_flash:
            raise AssertionError(f"F2 resumed: {res}")

        # reap: the reclaimed engine's KV leaves the card
        wait_until(lambda: not e._running, 60, "F2: the reclaimed engine's stop")
        if not driver.reap(spot):
            raise AssertionError("F2: reap refused a drained replica")
        tier.announcers.pop(spot, None)
        del e, real, recorded, futs
        engines.pop(spot), migrators.pop(spot)
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        released = outside_before - (mem_after - cached_bytes(engines[surv]))
        out["reap"] = {"released_mib": released / 2**20, "kv_mib": spot_kv / 2**20,
                       "allocated_fell_mib": (mem_before - mem_after) / 2**20}
        print(f"  F2 reap: memory_allocated outside the prefix caches fell "
              f"{released / 2**20:.1f} MiB (the preemptible replica's KV "
              f"{spot_kv / 2**20:.1f} MiB; all of memory_allocated "
              f"{(mem_before - mem_after) / 2**20:.1f} MiB)")
        if released < spot_kv - (64 << 20):
            raise AssertionError(f"F2 reap: {out['reap']}")

        # a notice lost in delivery: the replica keeps serving
        with chaos.active(chaos.ChaosInjector(SEED, {"replica.reclaim": 1.0}, max_faults=1)):
            delivered = driver.notice(surv, deadline_s=FLEET_NOTICE_S)
        still = tier.router.submit(prompt(50), max_new_tokens=4).result(600)
        out["lost_notice"] = {"delivered": delivered, "dropped": driver.notices_dropped_total,
                              "served_by": still.replica_id,
                              "state": engines[surv].health_check()["status"]}
        print(f"  F2 lost notice: {out['lost_notice']}")
        if delivered or driver.notices_dropped_total != 1 or still.replica_id != surv \
                or out["lost_notice"]["state"] != "UP":
            raise AssertionError(f"F2 lost notice: {out['lost_notice']}")
        out["launches"] = since(mark0)
    finally:
        for rid in list(engines):
            handle = driver.handle(rid)
            if handle is not None:
                release_replica(handle)
        tier.close()
        for engine in engines.values():
            engine.stop()
    engines.clear()
    torch.cuda.empty_cache()
    return out


def fleet_f3(torch, cfg, params, prompt, mem: dict) -> dict:
    """F3: an autoscaler over a pool of paged int8 replicas (4096,
    32-token pages) that ``engine_factory`` builds on the card; then a
    dense bf16 prefill replica and a decode replica behind a router."""
    from gofr_tpu_torch import EngineConfig, chaos
    from gofr_tpu_torch.serving import (Autoscaler, AutoscalerConfig, KVMigrator,
                                        SimulatedPoolDriver, engine_factory, local_engine_fetcher,
                                        release_replica)
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    conf = dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32,
                kv_dtype="int8", multi_step=4, prefill_chunk_tokens=256)
    print(f"engines F3: an autoscaled pool of paged int8 replicas (page=32, 4096, chunk=256, "
          f"{cfg.n_layers} layers), min 1 max 2, up 0.5 s, down 1.0 s, cooldown 1.0 s")
    tier = FleetTier()
    factory = engine_factory(cfg, params, EngineConfig(**conf), publisher=tier.broker,
                             heartbeat_s=FLEET_BEAT_S, tokenizer=ByteTokenizer(cfg.vocab_size),
                             seed=SEED)
    driver = SimulatedPoolDriver(tier.router, factory, on_reap=release_replica)
    scaler = Autoscaler(tier.router, driver, AutoscalerConfig(
        interval_s=0.1, min_replicas=1, max_replicas=2, up_stable_s=0.5, down_stable_s=1.0,
        cooldown_s=1.0), metrics=tier.manager)
    out: dict = {}
    mark0 = launch_counts()
    try:
        (first,) = driver.scale_up("unified", 1)
        tier.wait_up(first)
        # the scaler records a decision after its scale_up returns: stamp
        # the call, so the new replica's build is inside the timed span
        calls, real_up = [], driver.scale_up

        def timed_up(role, n, **kw):
            calls.append(time.time())
            return real_up(role, n, **kw)

        driver.scale_up = timed_up
        scaler.start()
        t_burst, done_at = time.time(), []
        futs = [tier.router.submit(prompt(FLEET_BURST_LEN), max_new_tokens=FLEET_BURST_NEW)
                for _ in range(FLEET_BURST)]
        for f in futs:
            f.add_done_callback(lambda _f: done_at.append(time.time()))
        wait_until(lambda: scaler.scale_ups_total >= 1, 300, "F3's scale-up")
        decision, t_decision = scaler.decisions[0], calls[0]
        added = decision["replicas"][0]
        # more traffic until the new replica takes its first route
        t_first, more = None, []
        while t_first is None:
            more.append(tier.router.submit(prompt(FLEET_BURST_LEN), max_new_tokens=8))
            if tier.router.routes_by_replica.get(added, 0):
                t_first = time.time()
            elif time.time() - t_decision > 120:
                raise AssertionError("F3: the new replica never took a route")
            else:
                time.sleep(0.05)
        results = [f.result(600) for f in futs + more]
        out["scale_up"] = {"decision": decision, "burst_to_decision_s": t_decision - t_burst,
                           "build_s": decision["t"] - t_decision,
                           "decision_to_first_route_s": t_first - t_decision,
                           "requests": len(results), "lost": 0,
                           "by_replica": {rid: sum(r.replica_id == rid for r in results)
                                          for rid in (first, added)}}
        print(f"  F3 scale-up: {out['scale_up']}")
        print(f"  F3 time from the scale-up decision to the new replica's first route: "
              f"{(t_first - t_decision) * 1e3:.1f} ms")
        if decision["direction"] != "up" or not all(r.finish_reason in ("length", "stop")
                                                    for r in results):
            raise AssertionError(f"F3 scale-up: {out['scale_up']}")
        # the queue empties: drain (the victim's rows in flight finish) and
        # reap down to the floor
        wait_until(lambda: scaler.scale_downs_total >= 1 and not scaler.snapshot()["draining"]
                   and len(driver.replica_ids("unified")) == 1, 120, "F3's scale-down and reap")
        down = next(d for d in scaler.decisions if d["direction"] == "down")
        out["scale_down"] = {"decision": down, "pool": driver.replica_ids("unified"),
                             "burst_done_after_decision": sum(t > down["t"] for t in done_at),
                             "last_burst_done_to_decision_s": down["t"] - max(done_at)}
        print(f"  F3 scale-down: {out['scale_down']}")
        scaler.stop()
        skipped = scaler.decisions_skipped_total
        with chaos.active(chaos.ChaosInjector(SEED, {"scale.decision": 1.0}, max_faults=1)):
            scaler.tick()
        text = tier.manager.expose_prometheus()
        out["scale_fault"] = {"skipped": scaler.decisions_skipped_total - skipped,
                              "decisions": len(scaler.decisions)}
        out["series"] = {n: sum(line.startswith(n + "{") for line in text.splitlines())
                         for n in ("app_autoscaler_replicas", "app_autoscaler_scale_events_total")}
        print(f"  F3 scale.decision fault: {out['scale_fault']}; series {out['series']}")
        if out["scale_fault"]["skipped"] != 1 or not all(out["series"].values()):
            raise AssertionError(f"F3 autoscaler: {out}")
        out["launches_autoscaler"] = since(mark0)
    finally:
        scaler.stop()
        for rid in driver.replica_ids("unified"):
            release_replica(driver.handle(rid))
        tier.close()
    del driver, scaler, factory
    torch.cuda.empty_cache()

    # P/D: a unified dense bf16 engine first, then a prefill and a decode replica
    pd_conf = dict(max_slots=8, max_seq_len=2048, kv_layout="dense", multi_step=4,
                   prefill_chunk_tokens=256, prefix_cache_entries=64, prefix_cache_bytes=2 << 30)
    print("engines F3 P/D: dense bf16 max_seq_len=2048 chunk=256, 64-entry prefix caches: a "
          "unified engine, then a prefill and a decode replica behind a router")
    p = prompt(1000)
    unified = build_engine(torch, cfg, params, pd_conf, mem, "F3 unified")
    unified.start()
    try:
        t0 = [time.perf_counter()]
        want = unified.submit(p, max_new_tokens=16, stream_cb=first_token_timer(t0)).result(600)
        unified_ttft = (t0[1] - t0[0]) * 1e3
    finally:
        unified.stop()
    del unified
    torch.cuda.empty_cache()
    tier = FleetTier()
    migrator = KVMigrator("decode", tier.router.prefix_index, metrics=tier.manager)
    pre = build_engine(torch, cfg, params, {**pd_conf, "role": "prefill"}, mem, "F3 prefill")
    dec = build_engine(torch, cfg, params, {**pd_conf, "role": "decode"}, mem, "F3 decode",
                       kv_migrator=migrator)
    migrator.add_peer("prefill", local_engine_fetcher(pre))
    mark = launch_counts()
    try:
        tier.add("prefill", pre, role="prefill")
        tier.add("decode", dec, role="decode")
        tier.wait_up("prefill", "decode")
        spy_pre, spy_dec = DispatchSpy(pre), DispatchSpy(dec)
        try:
            t0 = [time.perf_counter()]
            got = tier.router.submit(p, max_new_tokens=16,
                                     stream_cb=first_token_timer(t0)).result(600)
            split_ttft = (t0[1] - t0[0]) * 1e3
            pcounts, dcounts = dict(spy_pre.n), dict(spy_dec.n)
        finally:
            spy_dec.close()
            spy_pre.close()
        out["pd"] = {"replica": got.replica_id, "equal": got.token_ids == want.token_ids,
                     "ttft_ms": {"unified": unified_ttft, "split": split_ttft},
                     "prefill_dispatches": pcounts, "decode_dispatches": dcounts,
                     "handoffs": tier.router.handoffs_total,
                     "app_kv_handoffs_total": tier.manager.get("app_kv_handoffs_total").value(),
                     "tier": dec.timeline.get(got.request_id).prefix_tier,
                     "launches": since(mark)}
        print(f"  F3 P/D: {out['pd']}")
        print(f"  F3 TTFT of the 1000-token prompt: unified {unified_ttft:.2f} ms, prefill then "
              f"decode through the router {split_ttft:.2f} ms")
        if got.replica_id != "decode" or not out["pd"]["equal"] or dcounts["prefill"] \
                or dcounts["ragged"] or out["pd"]["handoffs"] != 1 \
                or out["pd"]["app_kv_handoffs_total"] != 1 or not pcounts["ragged"]:
            raise AssertionError(f"F3 P/D: {out['pd']}")
    finally:
        tier.close()
        pre.stop(), dec.stop()
    del pre, dec
    torch.cuda.empty_cache()
    out["launches"] = since(mark0)
    return out


def run_fleet(torch, cfg, params) -> dict:
    """The fleet phase at Llama-3-8B widths and ``cfg``'s depth
    (``PLANE_DEPTH`` in ``run_engine``), at most two engines at once over the
    one weight set: F1 the router tier, F2 reclamation, F3 the autoscaler and
    P/D routing."""
    rng = torch.Generator().manual_seed(SEED + 7)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    t0 = time.perf_counter()
    mem: dict = {}
    out = {"card": card_line()}
    for name, fn in (("F1", fleet_f1), ("F2", fleet_f2), ("F3", fleet_f3)):
        out[name] = fn(torch, cfg, params, prompt, mem)
    out["memory"] = mem
    out["seconds"] = time.perf_counter() - t0
    total: dict = {}
    for name in ("F1", "F2", "F3"):
        print_launches(name, out[name]["launches"])
        add_launches(total, out[name]["launches"])
    out["launches"] = total
    print(f"  fleet: {out['seconds']:.1f}s ({out['card']})")
    if not (total.get("flash_attention") and total.get("paged_decode_attention")
            and total.get("paged_decode_attention_q")):
        raise AssertionError(f"fleet launches {total}")
    return out


# ------------------------------------------------------------------- the app plane

HTTP_NEW = 32  # H1: new tokens of each of the main path's prompts
HTTP_BURST = 16  # H1: streams queued behind the gate for the shed check
HTTP_BOOT_S = 300.0  # H3: the subprocess answers /.well-known/alive within this
HTTP_EXIT_S = 90.0  # H3: SIGTERM to exit, the drain included
SERVE_ENV = {"SERVE_MODEL": "llama3-8b"}  # H3: the entry point's model (on the card)
# H1: the profiler trace's events of this category must name both kernels
PROFILE_CAT = "kernel"
PROFILE_KERNELS = {"flash": r"flash_fwd_kernel",
                   "paged_int8": r"paged_decode_kernel.*(signed char|EaEE)"}


def http_app(torch, cfg, params, conf: dict, mem: dict, label: str, logbuf, **kw):
    """An ``App`` on free ``127.0.0.1`` ports over a port engine on the card
    (``build_engine``, the shared weights), the engine on the container's
    metrics and tracer and on an INFO logger whose JSON lines go to
    ``logbuf``; the generation routes registered."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.logging import Level, Logger
    from gofr_tpu_torch.serving.handlers import register_generation_routes
    from gofr_tpu_torch.testutil import get_free_port

    app = App(MapConfig({
        "APP_NAME": label, "HTTP_HOST": "127.0.0.1", "HTTP_PORT": str(get_free_port()),
        "METRICS_PORT": str(get_free_port()), "LOG_LEVEL": "INFO",
        "SHUTDOWN_GRACE_PERIOD": "30",
    }, use_env=False))
    app.logger = app.container.logger = Logger(Level.INFO, logbuf, logbuf, exit_on_fatal=False)
    engine = build_engine(torch, cfg, params, conf, mem, label,
                          metrics=app.container.metrics_manager, tracer=app.container.tracer,
                          logger=app.logger, **kw)
    register_generation_routes(app, engine)
    return app, engine


def sse(base: str, payload: dict, headers: dict | None = None, keep: int | None = None,
        on_token=None) -> dict:
    """One ``POST /generate/stream`` over a real socket: its frames as
    (``id:`` or None, data), the client's seconds to the first token frame
    and each token frame's arrival; with ``keep`` the socket is dropped
    after that many frames. ``on_token(token count, head frame)`` runs per
    token frame."""
    import urllib.request

    req = urllib.request.Request(base + "/generate/stream", json.dumps(payload).encode(),
                                 {"Content-Type": "application/json", **(headers or {})},
                                 method="POST")
    t0 = time.perf_counter()
    frames, arrivals, seq = [], [], None
    resp = urllib.request.urlopen(req, timeout=600)
    try:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("id:"):
                seq = int(line[3:])
            elif line.startswith("data:"):
                data = line[5:].strip()
                data = data if data == "[DONE]" else json.loads(data)
                frames.append((seq, data))
                seq = None
                if isinstance(data, dict) and "token" in data:
                    arrivals.append(time.perf_counter() - t0)
                    if on_token is not None:
                        on_token(len(arrivals), frames[0][1])
                if keep is not None and len(frames) >= keep:
                    break
    finally:
        resp.close()
    return {"frames": frames, "arrivals": arrivals,
            "head": frames[0][1] if frames else None,
            "tokens": [d["token"] for _, d in frames if isinstance(d, dict) and "token" in d],
            "terminal": next((d for _, d in frames if isinstance(d, dict) and "finish_reason" in d),
                             None)}


def post(base: str, path: str, payload=None, headers=None, raw: bytes | None = None):
    """(status, headers, decoded JSON body or None) of one POST."""
    from gofr_tpu_torch.testutil import fetch

    body = raw if raw is not None else json.dumps(payload).encode()
    status, hdrs, data = fetch(base + path, "POST", body,
                               {"Content-Type": "application/json", **(headers or {})}, 600)
    try:
        return status, hdrs, json.loads(data) if data else None
    except ValueError:
        return status, hdrs, data


def get_json(url: str):
    from gofr_tpu_torch.testutil import fetch

    status, _, data = fetch(url, timeout=600)
    return status, json.loads(data)


def gap_ms(arrivals: list[float]) -> float | None:
    """Mean ms between a stream's first and last token frames, a token."""
    return (arrivals[-1] - arrivals[0]) * 1e3 / (len(arrivals) - 1) if len(arrivals) > 1 else None


def http_h1(torch, cfg, params, prompt, mem: dict) -> dict:
    """H1: one ``App`` over a paged int8 engine (4096, 32-token pages,
    256-token chunks): the main path's prompts as concurrent SSE streams,
    held to ``engine.submit``'s tokens, under a sync count beside the same
    set submitted directly; then the other routes, the profiler, and the
    admin drain."""
    import io
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from gofr_tpu_torch.metrics import lint_exposition
    from gofr_tpu_torch.serving import DeviceTelemetry
    from gofr_tpu_torch.serving.handlers import register_admin_drain
    from gofr_tpu_torch.testutil import fetch, start_app

    conf = dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32, multi_step=4,
                prefill_chunk_tokens=256, kv_dtype="int8")
    print(f"H1: App + paged int8 engine (page=32, max_seq_len=4096, chunk=256), "
          f"{cfg.n_layers} layers")
    logbuf = io.StringIO()
    app, engine = http_app(torch, cfg, params, conf, mem, "H1", logbuf)
    register_admin_drain(app)
    # sampled by hand for the health check, after the sync count
    telemetry = DeviceTelemetry(engine, metrics=app.container.metrics_manager, interval_s=3600)
    gate, probe = Gate(engine), SyncProbe(engine)
    thread = start_app(app, timeout=120)
    base = f"http://127.0.0.1:{app.http_port}"
    mbase = f"http://127.0.0.1:{app.metrics_port}"
    pool = ThreadPoolExecutor(max_workers=24, thread_name_prefix="client")
    out: dict = {"ports": [app.http_port, app.metrics_port]}
    ids = [prompt(n) for n in MAIN_LENS]
    try:
        mark = launch_counts()
        post(base, "/generate", {"prompt": prompt(40), "max_tokens": 4})  # warm-up

        def queued(n):
            wait_until(lambda: engine._sched.pending() >= n, 120, f"{n} requests queued")

        def http_set():
            # each stream queued before the next is sent: the queue's order,
            # which groups the admissions, is the direct set's
            with gate.closed():
                futs = []
                for i, p in enumerate(ids):
                    futs.append(pool.submit(sse, base, {"prompt": p, "max_tokens": HTTP_NEW}))
                    queued(i + 1)
            return [f.result(600) for f in futs]

        def direct_set():
            with gate.closed():
                futs = [engine.submit(p, max_new_tokens=HTTP_NEW, temperature=0.0) for p in ids]
            return [f.result(600) for f in futs]

        runs = {}
        for name, fn in (("app", http_set), ("direct", direct_set)):
            d0 = probe.n["dispatches"]
            res, sites = sync_warnings(torch, engine, probe, fn)
            runs[name] = {"results": res, "sites": sites,
                          "dispatches": probe.n["dispatches"] - d0}
        parted = {}
        for n, p, s, r in zip(MAIN_LENS, ids, runs["app"]["results"], runs["direct"]["results"]):
            if s["terminal"] is None or s["terminal"]["finish_reason"] != "length" \
                    or len(s["tokens"]) != HTTP_NEW:
                raise AssertionError(f"H1 stream of {n} tokens: {s['frames'][-3:]}")
            seqs = [q for q, _ in s["frames"][:-1]]
            if seqs != list(range(len(seqs))):
                raise AssertionError(f"H1 stream of {n}: id: lines {seqs}")
            parted[n] = same_or_close(torch, engine, p, s["tokens"], r.token_ids,
                                      f"H1 {n}-token prompt, SSE against submit")
        per = {k: sum(v["sites"].values()) / max(v["dispatches"], 1) for k, v in runs.items()}
        out["streams"] = {"equal": sum(v["equal"] for v in parted.values()), "of": len(parted),
                          "parted": {n: v for n, v in parted.items() if not v["equal"]}}
        out["syncs"] = {k: {"dispatches": v["dispatches"], "warnings": sum(v["sites"].values()),
                            "sites": v["sites"]} for k, v in runs.items()}
        print(f"  H1 10 SSE streams: {out['streams']['equal']}/10 token-equal to engine.submit; "
              f"sync warnings a dispatch through the app {per['app']:.3f}, direct "
              f"{per['direct']:.3f} ({out['syncs']})")
        if per["app"] != per["direct"]:
            raise AssertionError(f"H1: serving through the app changed the syncs a dispatch: "
                                 f"{out['syncs']}")
        # the app layer's cost, one 1000-token request at a time, in turns
        ttft, gaps, steps = {"sse": [], "submit": []}, [], []
        long_p = ids[MAIN_LENS.index(1000)]
        for _ in range(3):
            s = sse(base, {"prompt": long_p, "max_tokens": 16})
            tl = engine.timeline.get(s["head"]["id"]).to_dict()
            ttft["sse"].append((s["arrivals"][0] * 1e3, tl["ttft_ms"]))
            gaps.append(gap_ms(s["arrivals"]))
            r = engine.submit(long_p, max_new_tokens=16, temperature=0.0).result(600)
            ttft["submit"].append(r.ttft_s * 1e3)
            steps.append(per_step_ms([r]))
        out["app_cost"] = {"ttft_ms_sse_client_engine": ttft["sse"], "ttft_ms_submit": ttft["submit"],
                           "sse_gap_ms_a_token": gaps, "submit_ms_a_step": steps}
        print(f"  H1 1000-token prompt, 16 tokens, in turns: TTFT through SSE (client, engine) "
              f"{[(round(a, 2), round(b, 2)) for a, b in ttft['sse']]} ms, through submit "
              f"{[round(x, 2) for x in ttft['submit']]} ms; SSE gap "
              f"{[round(g, 2) for g in gaps]} ms a token against {[round(x, 2) for x in steps]} "
              f"ms a step")
        # one plain /generate
        status, _, body = post(base, "/generate", {"prompt": ids[0], "max_tokens": 8})
        if status != 201 or body["data"]["usage"]["completion_tokens"] != 8:
            raise AssertionError(f"H1 /generate: {status} {body}")
        out["generate"] = body["data"]["usage"]
        # a cancel mid-stream
        seen, heads = threading.Event(), []

        def two_tokens(k, head):
            if k == 2:
                heads.append(head)
                seen.set()

        fut = pool.submit(sse, base, {"prompt": prompt(200), "max_tokens": 512},
                          on_token=two_tokens)
        if not seen.wait(120):
            raise AssertionError("H1: the stream to cancel sent no tokens")
        rid = heads[0]["id"]
        t_cancel = time.perf_counter()
        status, _, body = post(base, "/generate/cancel", {"id": rid})
        s = fut.result(600)
        out["cancel"] = {"status": status, "finish_reason": s["terminal"]["finish_reason"],
                         "tokens": len(s["tokens"]),
                         "ms_to_terminal": (time.perf_counter() - t_cancel) * 1e3}
        if status != 201 or s["terminal"]["finish_reason"] != "cancel" or s["head"]["id"] != rid:
            raise AssertionError(f"H1 cancel: {out['cancel']} (request {rid}, {s['head']})")
        # a client that drops its socket mid-stream: its slot is freed
        t_drop = time.perf_counter()
        s = sse(base, {"prompt": prompt(200), "max_tokens": 512}, keep=3)
        wait_until(lambda: not engine._by_id and engine._sched.stats()["busy_slots"] == 0, 60,
                   "H1 the dropped stream's slot")
        out["drop"] = {"frames_read": len(s["frames"]),
                       "ms_to_free": (time.perf_counter() - t_drop) * 1e3}
        # a shed burst: streams queued behind the gate, then requests whose
        # deadline the estimated wait passes
        with gate.closed():
            burst = [pool.submit(sse, base, {"prompt": prompt(64), "max_tokens": 4})
                     for _ in range(HTTP_BURST)]
            queued(HTTP_BURST)
            shed = [post(base, "/generate", {"prompt": prompt(64), "max_tokens": 4},
                         {"X-Request-Timeout": "0.05"}) for _ in range(4)]
        burst = [f.result(600) for f in burst]
        out["shed"] = {"statuses": [s[0] for s in shed],
                       "retry_after": [s[1].get("Retry-After") for s in shed],
                       "burst_finished": sum(b["terminal"]["finish_reason"] == "length"
                                             for b in burst)}
        if any(s[0] != 429 or not s[1].get("Retry-After") for s in shed) \
                or out["shed"]["burst_finished"] != HTTP_BURST:
            raise AssertionError(f"H1 shed: {out['shed']}")
        # bad bodies
        bad = [post(base, "/generate", {"max_tokens": 3})[0],
               post(base, "/generate", {"prompt": "x", "temperature": -1})[0],
               post(base, "/generate", raw=b"{not json")[0],
               post(base, "/generate", {"prompt": "x"}, {"X-Request-Timeout": "soon"})[0],
               post(base, "/generate/stream", {"prompt": [cfg.vocab_size + 5]})[0],
               post(base, "/generate/cancel", {})[0]]
        out["bad_statuses"] = bad
        if bad != [400] * len(bad):
            raise AssertionError(f"H1 bad bodies: {bad}")
        # X-Tenant-Id and Idempotency-Key
        status, _, body = post(base, "/generate", {"prompt": prompt(20), "max_tokens": 4},
                               {"X-Tenant-Id": "gold"})
        tl = get_json(f"{base}/requestz/{body['data']['id']}")[1]["data"]
        before = engine.dedup_stats()
        keyed = [post(base, "/generate", {"prompt": prompt(20), "max_tokens": 4},
                      {"Idempotency-Key": "h1-key"})[2]["data"] for _ in range(2)]
        after = engine.dedup_stats()
        out["tenant"] = tl.get("tenant")
        out["idempotency"] = {"ids": [k["id"] for k in keyed], "texts_equal":
                              keyed[0]["text"] == keyed[1]["text"],
                              "hits": after["hits_terminal"] - before["hits_terminal"]
                              + after["hits_live"] - before["hits_live"]}
        if out["tenant"] != "gold" or len(set(out["idempotency"]["ids"])) != 1 \
                or out["idempotency"]["hits"] != 1:
            raise AssertionError(f"H1 tenant {out['tenant']}, idempotency {out['idempotency']}")
        # /requestz
        status, snap = get_json(base + "/requestz?limit=4")
        snap = snap["data"]
        if status != 200 or len(snap["completed"]) != 4 or "in_flight" not in snap:
            raise AssertionError(f"H1 /requestz: {status} {sorted(snap)}")
        out["requestz"] = sorted(snap)
        # health: the engine's health_check, the card in its telemetry
        telemetry.sample()
        status, health = get_json(base + "/.well-known/health")
        serving = health["data"]["details"]["serving"]
        dev = (serving["details"].get("device", {}).get("devices") or [{}])[0]
        out["health"] = {"status": health["data"]["status"], "serving": serving["status"],
                         "device": dev}
        if status != 200 or health["data"]["status"] != "UP" or serving["status"] != "UP" \
                or dev.get("platform") != "gpu" or not dev.get("hbm_limit_bytes"):
            raise AssertionError(f"H1 health: {out['health']}")
        # /metrics on the metrics port
        scrape_ms, text = [], ""
        for _ in range(3):
            t = time.perf_counter()
            status, _, raw = fetch(mbase + "/metrics")
            scrape_ms.append((time.perf_counter() - t) * 1e3)
            text = raw.decode()
        problems = lint_exposition(text)
        need = ("app_http_response_count", "app_request_ttft_seconds_count", "app_ttft_seconds",
                "app_decode_block_seconds", "app_requests_shed_total", "app_tpu_hbm_used_bytes")
        out["metrics"] = {"scrape_ms": scrape_ms, "bytes": len(text), "lint": problems,
                          "missing": [n for n in need if n not in text]}
        print(f"  H1 /metrics: {len(text)} bytes in {[round(x, 2) for x in scrape_ms]} ms, "
              f"promlint {problems or 'clean'}")
        if status != 200 or problems or out["metrics"]["missing"]:
            raise AssertionError(f"H1 /metrics: {out['metrics']}")
        # log correlation: the request line carries the traceparent's trace id
        trace = "4bf92f3577b34da6a3ce929d0e0e4736"
        post(base, "/generate", {"prompt": prompt(20), "max_tokens": 2},
             {"traceparent": f"00-{trace}-00f067aa0ba902b7-01"})
        lines = [json.loads(line) for line in logbuf.getvalue().splitlines() if line.strip()]
        hits = [e for e in lines if e.get("trace_id") == trace
                and isinstance(e.get("message"), dict) and e["message"].get("uri") == "/generate"]
        out["log_correlation"] = {"lines": len(lines), "with_trace": len(hits)}
        if len(hits) != 1:
            raise AssertionError(f"H1 log correlation: {out['log_correlation']}")
        # the device profiler on the metrics port
        with tempfile.TemporaryDirectory() as tmp:
            st = post(mbase, f"/debug/profiler/start?dir={tmp}", {})[0]
            again = post(mbase, f"/debug/profiler/start?dir={tmp}", {})[0]
            for p in (prompt(200), prompt(31)):
                post(base, "/generate", {"prompt": p, "max_tokens": 8})
            status, _, body = post(mbase, "/debug/profiler/stop", {})
            with open(body["trace"]) as f:
                events = json.load(f).get("traceEvents", [])
        kernels = {e["name"] for e in events if str(e.get("cat", "")).lower() == PROFILE_CAT}
        flash = sorted(k for k in kernels if re.search(PROFILE_KERNELS["flash"], k))
        paged8 = sorted(k for k in kernels if re.search(PROFILE_KERNELS["paged_int8"], k))
        out["profiler"] = {"start": st, "second_start": again, "stop": status,
                           "kernel_names": len(kernels), "flash": flash[:2], "paged_int8": paged8[:2]}
        print(f"  H1 profiler: {len(kernels)} kernel names in the trace; flash {flash[:1]}, "
              f"paged int8 {paged8[:1]}")
        if st != 200 or again != 409 or status != 200 or not flash or not paged8:
            raise AssertionError(f"H1 profiler: {out['profiler']}")
        # the admin drain: in-flight streams finish, new work gets a 503
        started = threading.Event()
        streams = [pool.submit(sse, base, {"prompt": prompt(100), "max_tokens": 64},
                               on_token=lambda k, head: started.set()) for _ in range(2)]
        if not started.wait(120):
            raise AssertionError("H1: the streams to drain under sent no tokens")
        t_drain = time.perf_counter()
        status, _, body = post(base, "/.well-known/drain", {})
        refused = post(base, "/generate", {"prompt": prompt(20), "max_tokens": 2})
        drained = [f.result(600) for f in streams]
        thread.join(timeout=120)
        out["drain"] = {"status": status, "body": body, "new_work": refused[0],
                        "retry_after": refused[1].get("Retry-After"),
                        "in_flight": [d["terminal"]["finish_reason"] for d in drained],
                        "app_stopped": not thread.is_alive(),
                        "seconds": time.perf_counter() - t_drain}
        print(f"  H1 drain: {out['drain']}")
        if status != 201 or refused[0] != 503 or out["drain"]["in_flight"] != ["length"] * 2 \
                or thread.is_alive() or engine._running:
            raise AssertionError(f"H1 drain: {out['drain']}")
        out["launches"] = since(mark)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        probe.close()
        if thread.is_alive():
            app.stop()
            thread.join(timeout=60)
        engine.stop()
    del engine, app
    torch.cuda.empty_cache()
    return out


def http_h2(torch, cfg, params, prompt, mem: dict) -> dict:
    """H2: apps A and B over paged bf16 engines (2048, 16-token pages, whole
    prefills, 64-entry prefix caches) behind a ``Router`` of two
    ``HTTPReplica``s, heartbeats on an ``InMemoryBroker``: migration over
    ``/kv/fetch`` (the binary body, under the migrator's 2.0 s default
    fetch timeout; one entry's JSON and binary bodies side by side), P/D
    through the router, a resumed stream, and failover when A's app
    stops."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    from gofr_tpu_torch.metrics import new_metrics_manager
    from gofr_tpu_torch.pubsub import InMemoryBroker
    from gofr_tpu_torch.serving import (KVMigrator, PrefixIndex, ReplicaAnnouncer, Router,
                                        RouterConfig, register_serving_metrics)
    from gofr_tpu_torch.serving.prefix_index import (KV_WIRE_CONTENT_TYPE, decode_entries_binary,
                                                     decode_entry)
    from gofr_tpu_torch.serving.router import HTTPReplica
    from gofr_tpu_torch.testutil import fetch, start_app

    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                prefill_chunk_tokens=2048, prefix_cache_entries=64, prefix_cache_bytes=2 << 30)
    print(f"H2: apps A and B, paged bf16 engines (page=16, max_seq_len=2048, whole prefills, "
          f"64-entry prefix caches), {cfg.n_layers} layers, a router over two HTTPReplicas")
    logs = {"A": io.StringIO(), "B": io.StringIO()}
    index = PrefixIndex()
    migrator = KVMigrator("B", index)  # the 2.0 s default fetch timeout
    app_a, eng_a = http_app(torch, cfg, params, conf, mem, "H2 A", logs["A"])
    app_b, eng_b = http_app(torch, cfg, params, conf, mem, "H2 B", logs["B"], kv_migrator=migrator)
    broker = InMemoryBroker(consumer_group="router", poll_timeout=0.05)
    router = Router(RouterConfig(heartbeat_s=FLEET_BEAT_S, suspect_after_s=5.0, down_after_s=20.0),
                    broker=broker, metrics=register_serving_metrics(new_metrics_manager()))
    threads = {"A": start_app(app_a, timeout=120), "B": start_app(app_b, timeout=120)}
    url = {"A": f"http://127.0.0.1:{app_a.http_port}", "B": f"http://127.0.0.1:{app_b.http_port}"}
    opened: list = []

    def breaker_open(rid):
        opened.append(rid)
        router.mark_replica_down(rid)

    reps = {r: HTTPReplica(r, url[r], breaker_threshold=2, breaker_interval=60.0,
                           on_breaker_open=breaker_open) for r in ("A", "B")}
    fetches: list = []

    def fetch_a(keys, timeout=2.0, fence_epoch=None):
        t = time.perf_counter()
        got = reps["A"].fetch_kv(keys, timeout=timeout, fence_epoch=fence_epoch)
        fetches.append({"keys": len(keys), "entries": len(got),
                        "ms": (time.perf_counter() - t) * 1e3})
        return got

    migrator.add_peer("A", fetch_a)
    anns = {"A": ReplicaAnnouncer("A", eng_a, broker, interval_s=FLEET_BEAT_S),
            "B": ReplicaAnnouncer("B", eng_b, broker, interval_s=FLEET_BEAT_S)}
    router.start()
    for r in ("A", "B"):
        router.add_replica(reps[r])
        anns[r].start()
    pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix="client")
    out: dict = {}
    try:
        m = router.membership
        wait_until(lambda: m.state_of("A") == "UP" and m.state_of("B") == "UP", 60, "A, B UP")
        mark = launch_counts()
        # migration over the wire: A serves a 1000-token prompt, B fetches
        # A's entry through /kv/fetch
        cold_b = sse(url["B"], {"prompt": prompt(1000), "max_tokens": 8})
        p = prompt(1000)
        on_a = sse(url["A"], {"prompt": p, "max_tokens": 8})
        index.observe("A", 1, eng_a.prefix_advertisement(256))
        spy, m0 = DispatchSpy(eng_b), launch_counts()
        try:
            on_b = sse(url["B"], {"prompt": p, "max_tokens": 8})
            counts = dict(spy.n)
        finally:
            spy.close()
        b_launches = since(m0)
        tier = eng_b.timeline.get(on_b["head"]["id"]).prefix_tier
        keys = [k for k, _ in eng_a.prefix_advertisement(256)][:1]
        t = time.perf_counter()
        status, _, raw = fetch(url["A"] + "/kv/fetch", "POST", json.dumps({"keys": keys}).encode(),
                               {"Content-Type": "application/json"}, 600)
        direct_ms = (time.perf_counter() - t) * 1e3
        # the same entry as the port's binary body (what fetch_kv asks for)
        t = time.perf_counter()
        bin_status, bin_headers, bin_raw = fetch(
            url["A"] + "/kv/fetch", "POST", json.dumps({"keys": keys}).encode(),
            {"Content-Type": "application/json", "Accept": KV_WIRE_CONTENT_TYPE}, 600)
        binary_ms = (time.perf_counter() - t) * 1e3
        from_json = {k: decode_entry(v) for k, v in json.loads(raw)["data"]["entries"].items()}
        from_binary = decode_entries_binary(bin_raw)
        wire_equal = sorted(from_json) == sorted(from_binary) == sorted(keys) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for k in keys for a, b in zip(from_json[k], from_binary[k]))
        # the body's bytes are its header and the slabs its shapes name, each
        # K/V slab [L, S_pad, Hkv, Dh] with L the engine's layers
        slabs = [t for k in keys for t in from_binary[k]]
        shape_bytes = 8 + int.from_bytes(bin_raw[:8], "little") + sum(
            t.numel() * t.element_size() for t in slabs)
        kv_shapes = [list(t.shape) for k in keys for t in from_binary[k][1:]]
        bytes_by_shape = len(bin_raw) == shape_bytes and all(
            s[0] == cfg.n_layers and s[2:] == [cfg.n_kv_heads, cfg.head_dim] for s in kv_shapes)

        def ttft(s, eng):
            return s["arrivals"][0] * 1e3, eng.timeline.get(s["head"]["id"]).to_dict()["ttft_ms"]

        out["migration"] = {
            "equal": on_b["tokens"] == on_a["tokens"], "tier": tier, "dispatches": counts,
            "b_flash": b_launches["flash_attention"], "fetches": fetches[:],
            "ttft_ms_client_engine": {"b_cold": ttft(cold_b, eng_b), "a_cold": ttft(on_a, eng_a),
                                      "b_migrated": ttft(on_b, eng_b)},
            "kv_fetch_bytes": len(raw), "kv_fetch_ms": direct_ms, "kv_fetch_status": status,
            "kv_fetch_binary_bytes": len(bin_raw), "kv_fetch_binary_ms": binary_ms,
            "kv_fetch_binary_status": bin_status, "kv_fetch_binary_equal_to_json": wire_equal,
            "kv_fetch_binary_shapes": kv_shapes, "kv_fetch_binary_bytes_by_shape": bytes_by_shape,
            "fetch_timeout_s": migrator.fetch_timeout_s}
        print(f"  H2 migration: {out['migration']}")
        print(f"  H2 /kv/fetch of one 1000-token entry: JSON {len(raw)} bytes in {direct_ms:.1f} ms, "
              f"binary {len(bin_raw)} bytes in {binary_ms:.1f} ms, the same slabs: {wire_equal}; "
              f"the migrator's fetches under its {migrator.fetch_timeout_s} s timeout: {fetches}")
        if not out["migration"]["equal"] or tier != "remote" or counts["prefill"] \
                or b_launches["flash_attention"] or status != 201 or bin_status != 200 \
                or not wire_equal or not bytes_by_shape or migrator.fetch_timeout_s != 2.0 \
                or not bin_headers.get("Content-Type", "").startswith(KV_WIRE_CONTENT_TYPE):
            raise AssertionError(f"H2 migration: {out['migration']}")
        # P/D through the router: A repurposed to prefill, B to decode
        anns["A"].role, anns["B"].role = "prefill", "decode"
        wait_until(lambda: m.role_of("A") == "prefill" and m.role_of("B") == "decode", 30,
                   "the P/D roles on the router")
        p2 = prompt(1000)
        spy, m0 = DispatchSpy(eng_b), launch_counts()
        try:
            toks: list = []
            r = router.submit(p2, max_new_tokens=8, temperature=0.0,
                              stream_cb=lambda t, s, d: toks.append(t) if not d else None
                              ).result(600)
            counts = dict(spy.n)
        finally:
            spy.close()
        unified = eng_a.submit(p2, max_new_tokens=8, temperature=0.0).result(600)
        out["pd"] = {"replica": r.replica_id, "dispatches_on_b": counts,
                     "ttft_ms_router": r.ttft_s * 1e3,
                     "ttft_ms_unified_cold": out["migration"]["ttft_ms_client_engine"]["a_cold"][1],
                     "ttft_ms_a_after_its_prefill": unified.ttft_s * 1e3,
                     "close": same_or_close(torch, eng_a, p2, r.token_ids, unified.token_ids,
                                            "H2 P/D against A unified"),
                     "streamed": toks == r.token_ids}
        print(f"  H2 P/D: {out['pd']}")
        if r.replica_id != "B" or counts["prefill"] or counts["ragged"] or not out["pd"]["streamed"]:
            raise AssertionError(f"H2 P/D: {out['pd']}")
        anns["A"].role = anns["B"].role = "unified"
        wait_until(lambda: m.role_of("A") == "unified" and m.role_of("B") == "unified", 30,
                   "the unified roles on the router")
        # a keyed stream dropped mid-stream, re-attached with Last-Event-ID
        p3 = prompt(200)
        full = sse(url["B"], {"prompt": p3, "max_tokens": 16})
        key = {"Idempotency-Key": "h2-resume"}
        first = sse(url["B"], {"prompt": p3, "max_tokens": 16}, key, keep=4)
        last = first["frames"][-1][0]
        rest = sse(url["B"], {}, {**key, "Last-Event-ID": str(last)})
        got = first["tokens"] + rest["tokens"]
        out["resume"] = {"dropped_after": last, "replayed": len(rest["tokens"]),
                         "resumed": rest["head"].get("resumed"),
                         "close": same_or_close(torch, eng_b, p3, got, full["tokens"],
                                                "H2 resumed stream against an unbroken one"),
                         "seqs": [q for q, _ in rest["frames"][1:-1]]}
        print(f"  H2 resume: {out['resume']}")
        if rest["head"].get("resumed") != last or len(got) != 16 \
                or out["resume"]["seqs"][:len(rest['tokens'])] != list(range(last + 1, 17)):
            raise AssertionError(f"H2 resume: {out['resume']}")
        # failover: A's app stops under traffic (its announcer dies with it)
        affine = []
        while len(affine) < 12:
            q = prompt(64)
            if router._candidates_for(q)[0][:1] == ["A"]:
                affine.append(q)
        firsts = threading.Event()
        live = [router.submit(q, max_new_tokens=16, temperature=0.0,
                              stream_cb=lambda t, s, d: firsts.set()) for q in affine[:8]]
        if not firsts.wait(120):
            raise AssertionError("H2: no token before the stop")
        t_stop = time.perf_counter()
        anns["A"].stop(final_beat=False)
        app_a.stop()
        threads["A"].join(timeout=120)
        later = [router.submit(q, max_new_tokens=16, temperature=0.0,
                               stream_cb=lambda *a: None).result(600) for q in affine[8:]]
        results = [f.result(600) for f in live]
        wait_until(lambda: m.state_of("A") == "DOWN", 30, "A DOWN on the router")
        out["failover"] = {
            "in_flight": [(x.replica_id, x.finish_reason) for x in results],
            "later": [(x.replica_id, x.finish_reason) for x in later],
            "breaker_opened": opened[:], "state_a": m.state_of("A"),
            "failovers": router.failovers_total,
            "stop_s": time.perf_counter() - t_stop}
        print(f"  H2 failover: {out['failover']}")
        if threads["A"].is_alive() or opened != ["A"] \
                or any(x.replica_id != "B" for x in later) \
                or any(x.finish_reason != "length" for x in results + later):
            raise AssertionError(f"H2 failover: {out['failover']}")
        out["launches"] = since(mark)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        for ann in anns.values():
            ann.stop(final_beat=False)
        router.stop()
        for r in reps.values():
            r.close()
        for name, app in (("A", app_a), ("B", app_b)):
            if threads[name].is_alive():
                app.stop()
                threads[name].join(timeout=120)
        eng_a.stop(), eng_b.stop()
    del eng_a, eng_b, app_a, app_b
    torch.cuda.empty_cache()
    return out


def http_h3() -> dict:
    """H3: ``python -m gofr_tpu_torch.serve`` as a process at Llama-3-8B
    width and full depth (the reference's engine defaults: dense bf16 KV,
    256-token chunks), with ``DB_DIALECT=sqlite`` on a temporary file: boot
    to its first answer, 3 requests (one streamed), a ``/metrics`` scrape,
    ``sql`` UP on ``/.well-known/health``, then SIGTERM: the drain runs, the process exits
    0 within ``HTTP_EXIT_S`` and its port is free after. The process is
    killed in a ``finally`` whatever happens."""
    import os
    import signal
    import socket
    import tempfile

    from gofr_tpu_torch.metrics import lint_exposition
    from gofr_tpu_torch.testutil import fetch, get_free_port

    http_port, metrics_port = get_free_port(), get_free_port()
    base = f"http://127.0.0.1:{http_port}"
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, **SERVE_ENV, HTTP_HOST="127.0.0.1",
                   HTTP_PORT=str(http_port), METRICS_PORT=str(metrics_port), LOG_LEVEL="INFO",
                   GOFR_CONFIGS_DIR=tmp, PYTHONPATH=str(ROOT), DB_DIALECT="sqlite",
                   DB_NAME=str(Path(tmp) / "serve.db"))
        log_path = Path(tmp) / "serve.log"
        print(f"H3: python -m gofr_tpu_torch.serve on :{http_port} (metrics :{metrics_port})")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.Popen([sys.executable, "-m", "gofr_tpu_torch.serve"], cwd=ROOT,
                                    env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + HTTP_BOOT_S
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"H3: the server exited {proc.returncode} at boot: "
                                         f"{log_path.read_text()[-2000:]}")
                try:
                    if fetch(base + "/.well-known/alive", timeout=2)[0] == 200:
                        break
                except OSError:
                    pass
                if time.monotonic() > deadline:
                    raise AssertionError(f"H3: no answer within {HTTP_BOOT_S:g}s")
                time.sleep(0.1)
            out["boot_to_alive_s"] = time.perf_counter() - t0
            t = time.perf_counter()
            first = post(base, "/generate", {"prompt": "The first request", "max_tokens": 8})
            out["first_answer_s"] = time.perf_counter() - t
            second = post(base, "/generate", {"prompt": "x" * 300, "max_tokens": 16})
            stream = sse(base, {"prompt": "a streamed request", "max_tokens": 16})
            status, _, raw = fetch(f"http://127.0.0.1:{metrics_port}/metrics")
            text = raw.decode()
            health = json.loads(fetch(base + "/.well-known/health")[2])["data"]["details"]
            out["health_sql"] = (health.get("sql") or {}).get("status")
            out["requests"] = [first[0], second[0], stream["terminal"]]
            out["metrics"] = {"status": status, "lint": lint_exposition(text),
                              "http_series": "app_http_response_count" in text,
                              "ttft_series": "app_request_ttft_seconds_count" in text}
            print(f"  H3 up in {out['boot_to_alive_s']:.1f}s, first answer "
                  f"{out['first_answer_s'] * 1e3:.1f} ms; {out['requests']}; {out['metrics']}")
            if first[0] != 201 or second[0] != 201 or first[2]["data"]["usage"][
                    "completion_tokens"] != 8 or stream["terminal"] is None \
                    or len(stream["tokens"]) != 16 or status != 200 or out["metrics"]["lint"] \
                    or not out["metrics"]["http_series"] or not out["metrics"]["ttft_series"] \
                    or out["health_sql"] != "UP":
                raise AssertionError(f"H3: {out}")
            t = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=HTTP_EXIT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"H3: no exit within {HTTP_EXIT_S:g}s of SIGTERM") from None
            out["sigterm_to_exit_s"] = time.perf_counter() - t
            out["exit_code"] = rc
            text = log_path.read_text()
            out["drained"] = "serving engine draining" in text and "shutdown complete" in text
            with socket.socket() as s:
                # as a new server binds it (asyncio sets SO_REUSEADDR): a
                # closed connection's TIME_WAIT does not hold the port, a
                # listener left behind does
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", http_port))
            out["port_free"] = True
            print(f"  H3 SIGTERM: exit {rc} in {out['sigterm_to_exit_s']:.2f}s, drained "
                  f"{out['drained']}, port free")
            if rc != 0 or not out["drained"]:
                raise AssertionError(f"H3: {out} {text[-2000:]}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def run_http(torch, cfg, params) -> dict:
    """The app plane at Llama-3-8B widths: H1 one app and H2 two apps behind
    a router over HTTP at ``PLANE_DEPTH`` layers (the first of the same
    weights), H3 the entry point as a process at full depth."""
    rng = torch.Generator().manual_seed(SEED + 8)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    t0 = time.perf_counter()
    mem: dict = {}
    out = {"card": card_line()}
    cut_cfg, cut_params = cut_depth(cfg, params, PLANE_DEPTH)
    out["H1"] = http_h1(torch, cut_cfg, cut_params, prompt, mem)
    out["H2"] = http_h2(torch, cut_cfg, cut_params, prompt, mem)
    del cut_params
    out["H3"] = http_h3()
    out["memory"] = mem
    out["seconds"] = time.perf_counter() - t0
    total: dict = {}
    for name in ("H1", "H2"):
        print_launches(name, out[name]["launches"])
        add_launches(total, out[name]["launches"])
    out["launches"] = total
    print(f"  http: {out['seconds']:.1f}s ({out['card']})")
    if not (total.get("flash_attention") and total.get("paged_decode_attention")
            and total.get("paged_decode_attention_q")):
        raise AssertionError(f"http launches {total}")
    return out


SURFACE_NEW = 32  # W: new tokens of each of the main path's prompts
SURFACE_KEY = "surface-key"  # W: the API key the app accepts
SURFACE_JOBS = 8  # Q: generation jobs through the subscriber
SURFACE_ATTEMPTS = 3  # Q: the generate topic's delivery budget


def ws_stream(url: str, payload: dict, headers: dict | None = None, keep: int | None = None,
              close: bool = False) -> dict:
    """One generation over ``/ws/generate`` with the port's WebSocket client
    (``gofr_tpu_torch.websocket.WSClient``, masked frames over
    ``asyncio.open_connection``): the frames, the client's seconds from the
    send to each token frame, the tokens and the summary frame. With
    ``keep`` the client leaves after that many frames, by a close frame
    (``close``) or by dropping the socket; ``t_left`` is when it left."""
    from gofr_tpu_torch.websocket import WSClient

    async def run() -> dict:
        ws = await WSClient.connect(url, headers=headers, timeout=60)
        frames, arrivals = [], []
        t0 = time.perf_counter()
        await ws.send(payload)
        try:
            while keep is None or len(frames) < keep:
                frame = json.loads(await asyncio.wait_for(ws.recv(), 600))
                frames.append(frame)
                if "token" in frame:
                    arrivals.append(time.perf_counter() - t0)
                if frame.get("done") or "error" in frame:
                    break
        finally:
            t_left = time.perf_counter()
            if keep is not None and not close:
                ws.abort()
            else:
                await ws.close()
        return {"frames": frames, "arrivals": arrivals, "t_left": t_left,
                "tokens": [f["token"] for f in frames if "token" in f],
                "summary": next((f for f in frames if f.get("done")), None)}

    return asyncio.run(run())


def ws_refused(url: str, headers: dict | None = None) -> int:
    """The HTTP status of an upgrade the server refuses (101 if it upgrades)."""
    from gofr_tpu_torch.websocket import WSClient, WSHandshakeError

    async def run() -> int:
        try:
            ws = await WSClient.connect(url, headers=headers, timeout=60)
        except WSHandshakeError as exc:
            return exc.status
        await ws.close()
        return 101

    return asyncio.run(run())


def surface_w(torch, engine, base: str, ws_url: str, prompt, pool, gate, probe,
              submitted: list, out: dict) -> None:
    """W: the main path's prompts as concurrent WebSocket streams behind
    the gate against the same set through ``engine.submit`` (tokens and
    sync warnings a dispatch), the refused requests, a dropped and a closed
    stream, the WebSocket TTFT and gap a token."""
    key = {"X-API-Key": SURFACE_KEY}
    ids = [prompt(n) for n in MAIN_LENS]

    def queued(n):
        wait_until(lambda: engine._sched.pending() >= n, 120, f"{n} requests queued")

    def ws_set():
        # each stream queued before the next is sent: the queue's order,
        # which groups the admissions, is the direct set's
        with gate.closed():
            futs = []
            for i, p in enumerate(ids):
                futs.append(pool.submit(ws_stream, ws_url,
                                        {"prompt": p, "max_tokens": SURFACE_NEW}, key))
                queued(i + 1)
        return [f.result(600) for f in futs]

    def direct_set():
        with gate.closed():
            futs = [engine.submit(p, max_new_tokens=SURFACE_NEW, temperature=0.0) for p in ids]
        return [f.result(600) for f in futs]

    ws_stream(ws_url, {"prompt": prompt(40), "max_tokens": 4}, key)  # warm-up
    runs = {}
    for name, fn in (("ws", ws_set), ("direct", direct_set)):
        d0 = probe.n["dispatches"]
        res, sites = sync_warnings(torch, engine, probe, fn)
        runs[name] = {"results": res, "sites": sites, "dispatches": probe.n["dispatches"] - d0}
    parted = {}
    for n, p, s, r in zip(MAIN_LENS, ids, runs["ws"]["results"], runs["direct"]["results"]):
        summary = s["summary"]
        if summary is None or summary.get("finish_reason") != "length" \
                or summary.get("tokens") != SURFACE_NEW or len(s["tokens"]) != SURFACE_NEW:
            raise AssertionError(f"W stream of {n} tokens: {s['frames'][-3:]}")
        parted[n] = same_or_close(torch, engine, p, s["tokens"], r.token_ids,
                                  f"W {n}-token prompt, WebSocket against submit")
    per = {k: sum(v["sites"].values()) / max(v["dispatches"], 1) for k, v in runs.items()}
    out["streams"] = {"equal": sum(v["equal"] for v in parted.values()), "of": len(parted),
                      "parted": {n: v for n, v in parted.items() if not v["equal"]}}
    out["syncs"] = {k: {"dispatches": v["dispatches"], "warnings": sum(v["sites"].values()),
                        "sites": v["sites"]} for k, v in runs.items()}
    print(f"  W 10 WebSocket streams: {out['streams']['equal']}/10 token-equal to engine.submit; "
          f"sync warnings a dispatch through the socket {per['ws']:.3f}, direct "
          f"{per['direct']:.3f} ({out['syncs']})")
    if out["streams"]["equal"] != len(ids):
        raise AssertionError(f"W: streams not token-equal to engine.submit: {out['streams']}")
    if per["ws"] != per["direct"]:
        raise AssertionError(f"W: serving through the socket changed the syncs a dispatch: "
                             f"{out['syncs']}")
    # refused: no key, a wrong key, a POST with no key; the probe stays open
    n0 = len(submitted)
    refused = {"upgrade_no_key": ws_refused(ws_url),
               "upgrade_wrong_key": ws_refused(ws_url, {"X-API-Key": "wrong"}),
               "generate_no_key": post(base, "/generate", {"prompt": ids[0], "max_tokens": 4})[0],
               "health_no_key": get_json(base + "/.well-known/health")[0]}
    refused["admitted"] = len(submitted) - n0
    out["refused"] = refused
    print(f"  W refused: {refused}")
    if refused != {"upgrade_no_key": 401, "upgrade_wrong_key": 401, "generate_no_key": 401,
                   "health_no_key": 200, "admitted": 0}:
        raise AssertionError(f"W refused requests: {refused}")
    # a client that drops its socket mid-stream, one that sends a close frame
    for how in ("drop", "close"):
        s = ws_stream(ws_url, {"prompt": prompt(200), "max_tokens": 512}, key, keep=3,
                      close=how == "close")
        pc = engine.paged_cache
        wait_until(lambda: not engine._by_id and engine._sched.stats()["busy_slots"] == 0
                   and pc.stats()["free_blocks"] == pc.stats()["total_blocks"], 60,
                   f"W the {how} stream's row and pages")
        released = time.perf_counter()
        tl = engine.timeline.get(submitted[-1])
        wait_until(lambda: tl.finish_reason is not None, 60, f"W the {how} stream's terminal")
        out[how] = {"frames_read": len(s["frames"]), "ms_to_release": (released - s["t_left"]) * 1e3,
                    "finish_reason": tl.finish_reason}
        print(f"  W {how}: {out[how]}")
        if out[how]["finish_reason"] != "cancel":
            raise AssertionError(f"W {how}: {out[how]}")
    # the app layer's cost, one 1000-token request at a time, in turns
    ttft, gaps, steps = {"ws": [], "submit": []}, [], []
    long_p = ids[MAIN_LENS.index(1000)]
    for _ in range(3):
        s = ws_stream(ws_url, {"prompt": long_p, "max_tokens": 16}, key)
        tl = engine.timeline.get(submitted[-1])
        wait_until(lambda: tl.finish_reason is not None, 60, "W the TTFT stream's terminal")
        tl = tl.to_dict()
        ttft["ws"].append((s["arrivals"][0] * 1e3, tl["ttft_ms"]))
        gaps.append(gap_ms(s["arrivals"]))
        r = engine.submit(long_p, max_new_tokens=16, temperature=0.0).result(600)
        ttft["submit"].append(r.ttft_s * 1e3)
        steps.append(per_step_ms([r]))
    out["app_cost"] = {"ttft_ms_ws_client_engine": ttft["ws"], "ttft_ms_submit": ttft["submit"],
                       "ws_gap_ms_a_token": gaps, "submit_ms_a_step": steps}
    print(f"  W 1000-token prompt, 16 tokens, in turns: TTFT through the socket (client, engine) "
          f"{[(round(a, 2), round(b, 2)) for a, b in ttft['ws']]} ms, through submit "
          f"{[round(x, 2) for x in ttft['submit']]} ms; WebSocket gap "
          f"{[round(g, 2) for g in gaps]} ms a token against {[round(x, 2) for x in steps]} "
          f"ms a step")


def surface_q(torch, engine, app, mbase: str, base: str, prompt, out: dict) -> None:
    """Q: generation jobs through ``app.subscribe("generate", ...)`` on the
    in-memory broker, each result published to ``generate.results``: one
    injected ``pubsub.handler`` fault (one redelivery, no dead letter),
    then a poison job (an empty prompt, a 400 at submit) that lands in
    ``generate.dlq`` after the topic's attempts while the next job flows."""
    from gofr_tpu_torch import chaos

    broker = app.container.pubsub
    consumer = app.subscription_manager._consumers["generate"]
    lens = MAIN_LENS[:SURFACE_JOBS]
    ids = [prompt(n) for n in lens]
    # the subscriber runs one job at a time: the reference is each alone
    want = [engine.submit(p, max_new_tokens=SURFACE_NEW, temperature=0.0).result(600)
            for p in ids]

    def results(n: int) -> list[dict]:
        got = []
        t_end = time.monotonic() + 300
        while len(got) < n:
            if time.monotonic() > t_end:
                raise AssertionError(f"Q: {len(got)} of {n} results")
            msg = broker.subscribe("generate.results")
            if msg is not None:
                got.append({**json.loads(msg.value), "t_result": time.perf_counter()})
                msg.commit()
        return got

    with chaos.active(chaos.ChaosInjector(SEED, {"pubsub.handler": 1.0}, max_faults=1)) as inj:
        for k, p in enumerate(ids):
            broker.publish("generate", json.dumps({"job": k, "prompt": p,
                                                   "t_publish": time.perf_counter()}).encode())
        got = sorted(results(len(ids)), key=lambda r: r["job"])
    faults = inj.stats()["pubsub.handler"]
    after_fault = {"redeliveries": consumer.redeliveries, "dlq": consumer.dlq}
    parted = {n: same_or_close(torch, engine, p, g["tokens"], w.token_ids,
                               f"Q {n}-token job against submit")
              for n, p, g, w in zip(lens, ids, got, want)}
    # the poison job, then one more good job behind it
    broker.publish("generate", json.dumps({"job": "poison", "prompt": [],
                                           "t_publish": time.perf_counter()}).encode())
    broker.publish("generate", json.dumps({"job": "after", "prompt": ids[0],
                                           "t_publish": time.perf_counter()}).encode())
    behind = results(1)[0]
    wait_until(lambda: consumer.dlq == 1, 60, "Q the poison job's dead letter")
    dead = broker.subscribe("generate.dlq")
    out["jobs"] = {"equal": sum(v["equal"] for v in parted.values()), "of": len(parted),
                   "parted": {n: v for n, v in parted.items() if not v["equal"]}}
    out["delivery"] = {"after_fault": after_fault, "faults": faults,
                       "redeliveries": consumer.redeliveries, "dlq": consumer.dlq,
                       "dlq_message": dead is not None and json.loads(dead.value)["job"],
                       "dlq_attempts": dead.metadata.get("gofr_dlq_attempts") if dead else None,
                       "behind_poison_equal": behind["tokens"] == want[0].token_ids}
    out["job_ms"] = {"publish_to_result": [(g["t_result"] - g["t_publish"]) * 1e3 for g in got],
                     "ttft": [g["ttft_ms"] for g in got]}
    print(f"  Q {len(ids)} jobs: {out['jobs']['equal']}/{len(ids)} token-equal to engine.submit; "
          f"delivery {out['delivery']}")
    print(f"  Q publish to result {[round(x, 1) for x in out['job_ms']['publish_to_result']]} ms, "
          f"TTFT a job {[round(x, 2) for x in out['job_ms']['ttft']]} ms")
    if out["jobs"]["equal"] != len(ids) or after_fault != {"redeliveries": 1, "dlq": 0} \
            or consumer.redeliveries != 1 + SURFACE_ATTEMPTS - 1 or consumer.dlq != 1 \
            or out["delivery"]["dlq_message"] != "poison" \
            or out["delivery"]["dlq_attempts"] != str(SURFACE_ATTEMPTS) \
            or not out["delivery"]["behind_poison_equal"]:
        raise AssertionError(f"Q: jobs {out['jobs']}, delivery {out['delivery']}")
    # the consumer's series on /metrics, its state on the health route
    from gofr_tpu_torch.testutil import fetch

    text = fetch(mbase + "/metrics")[2].decode()
    series = {}
    for name in ("app_pubsub_subscribe_total_count", "app_pubsub_subscribe_success_count",
                 "app_pubsub_redeliveries_total", "app_pubsub_dlq_total",
                 "app_pubsub_handler_duration_seconds_count", "app_pubsub_publish_total_count"):
        vals = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith(name + "{") and 'topic="generate' in line]
        series[name] = sum(vals)
    health = get_json(base + "/.well-known/health")[1]["data"]
    consumers = health["details"].get("pubsub_consumers", {})
    out["metrics"] = series
    out["health"] = {"status": health["status"], "pubsub_consumers": consumers.get("status"),
                     "generate": consumers.get("details", {}).get("topics", {}).get("generate")}
    print(f"  Q /metrics {series}; health {out['health']['status']}, consumers "
          f"{out['health']['pubsub_consumers']}")
    if not all(series.values()) or health["status"] != "UP" or consumers.get("status") != "UP":
        raise AssertionError(f"Q metrics {series}, health {out['health']}")


def surface_c(engine, prompt, out: dict) -> None:
    """C: a ``new_cmd`` app with a ``generate`` subcommand over the engine:
    its printed tokens against ``engine.submit``'s, help, an unknown
    command."""
    import io

    from gofr_tpu_torch.app import new_cmd
    from gofr_tpu_torch.cli import run_cmd
    from gofr_tpu_torch.config import MapConfig

    cmd = new_cmd(MapConfig({"APP_NAME": "surface-cmd", "LOG_LEVEL": "ERROR"}, use_env=False))

    def generate(ctx):
        ids = [int(x) for x in ctx.params("prompt_ids")]
        r = engine.submit(ids, max_new_tokens=int(ctx.param("max_new_tokens") or 8),
                          temperature=0.0).result(600)
        return {"tokens": r.token_ids, "finish_reason": r.finish_reason}

    cmd.sub_command("generate", generate, "greedy tokens of a prompt of token ids")
    ids = prompt(120)
    want = engine.submit(ids, max_new_tokens=8, temperature=0.0).result(600)

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = run_cmd(cmd, argv)
        return code, buf.getvalue()

    code, text = run(["generate", "prompt_ids=" + ",".join(map(str, ids)), "max_new_tokens=8"])
    got = json.loads(text)
    help_code, help_text = run(["--help"])
    bad_code, bad_text = run(["nope"])
    out["cmd"] = {"exit": code, "equal": got["tokens"] == want.token_ids,
                  "finish_reason": got["finish_reason"], "help_exit": help_code,
                  "unknown_exit": bad_code, "unknown_lists": "generate" in bad_text}
    print(f"  C CMD mode: {out['cmd']}")
    if out["cmd"] != {"exit": 0, "equal": True, "finish_reason": "length", "help_exit": 0,
                      "unknown_exit": 1, "unknown_lists": True} or "generate" not in help_text:
        raise AssertionError(f"C: {out['cmd']}")
    cmd.container.close()


def run_surface(torch, cfg, params) -> dict:
    """The rest of the app surface at Llama-3-8B widths and ``cfg``'s depth
    (``PLANE_DEPTH`` in ``run_engine``): one
    ``App`` with API-key auth over a paged bf16 engine (2048, 16-token
    pages, whole prefills, 8 slots, N = 4) serving the generation routes,
    ``/ws/generate``, the admin drain, a subscriber and a cron job; W
    (WebSocket and auth), Q (subscribers), C (CMD mode) and the drain."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.logging import Level, Logger
    from gofr_tpu_torch.serving import DeviceTelemetry
    from gofr_tpu_torch.serving.handlers import (
        register_admin_drain,
        register_generation_routes,
        register_generation_ws,
    )
    from gofr_tpu_torch.testutil import get_free_port, start_app

    rng = torch.Generator().manual_seed(SEED + 9)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    t0 = time.perf_counter()
    zero_launches()
    out: dict = {"card": card_line()}
    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                prefill_chunk_tokens=2048)
    print(f"surface: App + paged bf16 engine (page=16, max_seq_len=2048, whole prefills), "
          f"{cfg.n_layers} layers")
    logbuf = io.StringIO()
    app = App(MapConfig({
        "APP_NAME": "surface", "HTTP_HOST": "127.0.0.1", "HTTP_PORT": str(get_free_port()),
        "METRICS_PORT": str(get_free_port()), "LOG_LEVEL": "INFO", "SHUTDOWN_GRACE_PERIOD": "30",
        "PUBSUB_BACKEND": "MEMORY", "PUBSUB_RETRY_BACKOFF_SECONDS": "0.05",
        "PUBSUB_GENERATE_MAX_ATTEMPTS": str(SURFACE_ATTEMPTS),
    }, use_env=False))
    app.logger = app.container.logger = Logger(Level.INFO, logbuf, logbuf, exit_on_fatal=False)
    mem: dict = {}
    engine = build_engine(torch, cfg, params, conf, mem, "surface",
                          metrics=app.container.metrics_manager, tracer=app.container.tracer,
                          logger=app.logger)
    out["memory"] = mem
    app.enable_api_key_auth(SURFACE_KEY)
    register_generation_routes(app, engine)
    register_generation_ws(app, engine)
    register_admin_drain(app)
    submitted: list = []
    real_submit = engine.submit

    def counted_submit(*a, **k):
        fut = real_submit(*a, **k)
        submitted.append(fut.request_id)
        return fut

    engine.submit = counted_submit
    # the cron job: the engine's device telemetry into a gauge, every second
    telemetry = DeviceTelemetry(engine, metrics=app.container.metrics_manager, interval_s=3600)
    app.container.metrics_manager.new_gauge("surface_cron_hbm_used_bytes",
                                            "HBM in use, read by the cron job")
    ticks: list[float] = []

    def cron_job(ctx):
        telemetry.sample()
        dev = ctx.serving.health_check()["details"]["device"]["devices"][0]
        ctx.metrics.set_gauge("surface_cron_hbm_used_bytes", float(dev["hbm_used_bytes"]))
        ticks.append(time.monotonic())

    app.add_cron_job("* * * * * *", "device-telemetry", cron_job)

    async def generate_job(ctx):
        job = json.loads(ctx.request.value)
        fut = engine.submit(job["prompt"], max_new_tokens=SURFACE_NEW, temperature=0.0)
        r = await asyncio.wrap_future(fut)  # the loop keeps serving meanwhile
        ctx.get_publisher().publish("generate.results", json.dumps({
            "job": job["job"], "t_publish": job["t_publish"], "tokens": r.token_ids,
            "finish_reason": r.finish_reason, "ttft_ms": r.ttft_s * 1e3}).encode())

    app.subscribe("generate", generate_job)
    gate, probe = Gate(engine), SyncProbe(engine)
    thread = start_app(app, timeout=120)
    base = f"http://127.0.0.1:{app.http_port}"
    mbase = f"http://127.0.0.1:{app.metrics_port}"
    ws_url = f"ws://127.0.0.1:{app.http_port}/ws/generate"
    pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix="client")
    try:
        surface_w(torch, engine, base, ws_url, prompt, pool, gate, probe, submitted,
                  out.setdefault("W", {}))
        surface_q(torch, engine, app, mbase, base, prompt, out.setdefault("Q", {}))
        surface_c(engine, prompt, out.setdefault("C", {}))
        # cron: ticks while the phase ran, their spacing, the gauge
        spacing = [(b - a) * 1e3 for a, b in zip(ticks, ticks[1:])]
        gauge = app.container.metrics_manager.get("surface_cron_hbm_used_bytes").value({})
        out["cron"] = {"ticks": len(ticks), "spacing_ms_min": min(spacing, default=None),
                       "spacing_ms_median": median(spacing),
                       "spacing_ms_max": max(spacing, default=None), "hbm_gauge": gauge}
        print(f"  cron: {out['cron']}")
        if len(ticks) < 5 or not gauge or max(spacing) > 2000:
            raise AssertionError(f"cron: {out['cron']}")
        # the drain behind auth (Queue C 30): refused without the key
        refused = post(base, "/.well-known/drain", {})[0]
        still = {"draining": app.container.draining, "engine_running": engine._running}
        status, _, body = post(base, "/.well-known/drain", {}, {"X-API-Key": SURFACE_KEY})
        thread.join(timeout=120)
        out["drain"] = {"no_key": refused, "after_no_key": still, "with_key": status,
                        "app_stopped": not thread.is_alive(), "engine_stopped": not engine._running}
        print(f"  drain: {out['drain']}")
        if out["drain"] != {"no_key": 401, "after_no_key": {"draining": False,
                                                           "engine_running": True},
                            "with_key": 201, "app_stopped": True, "engine_stopped": True}:
            raise AssertionError(f"drain: {out['drain']}")
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        probe.close()
        if thread.is_alive():
            app.stop()
            thread.join(timeout=60)
        engine.stop()
    out["launches"] = launch_counts()
    out["seconds"] = time.perf_counter() - t0
    print_launches("surface", out["launches"])
    print(f"  surface: {out['seconds']:.1f}s ({out['card']})")
    if not (out["launches"].get("flash_attention") and out["launches"].get("paged_decode_attention")):
        raise AssertionError(f"surface launches {out['launches']}")
    del engine, app
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- the models phase
MODELS_E_LENS = (16, 128, 512)  # E: tokens of a single-text request (BOS + one byte each)
MODELS_E_REQUESTS = 50  # E: single-text requests, one at a time
MODELS_E_BATCH = 32  # E: texts of the one batched request
COSINE_BATCH_TOL = 0.999  # E: a text's embedding alone against inside the batch
COSINE_F32_TOL = 0.99  # E: a served (bf16) embedding against the f32 forward's
MODELS_ASR_SECONDS = (5, 12, 30)  # A: seconds of 16 kHz audio a job
MODELS_ASR_TOKENS = 32  # A: max_tokens a job
MODELS_L_DEPTH = 2  # L: layers of the Llama-3-8B-wide checkpoint (full depth writes 16 GB)
MODELS_L_NEW = 16  # L: new tokens a request
MODELS_L_MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("e", "r"), ("a", "n"),
                   ("Ġ", "a"), ("o", "n"), ("r", "e"), ("1", "2"), ("12", "3")]
MODELS_L_TEXTS = ["the quick brown fox jumps over the lazy dog",
                  "Hello, WORLD's 12345 caffè 東京 🚀\r\n\r\n  don't", "<|begin_of_text|>the end"]


def tree_equal(torch, a: dict, b: dict) -> bool:
    """The same keys at every level and every leaf equal bit for bit."""
    if set(a) != set(b):
        return False
    for k, v in a.items():
        w = b[k]
        if isinstance(v, dict):
            if not (isinstance(w, dict) and tree_equal(torch, v, w)):
                return False
        elif v.dtype != w.dtype or v.shape != w.shape or not torch.equal(v, w):
            return False
    return True


def write_safetensors(torch, path: str, tensors: dict) -> int:
    """The script's own safetensors writer: an 8-byte little-endian header
    length, the JSON header (dtype, shape, data offsets), then each
    tensor's little-endian bytes, copied to the host one at a time.
    Returns the bytes written."""
    import struct

    names = {torch.bfloat16: "BF16", torch.float32: "F32", torch.float16: "F16"}
    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(blob) + offset


def write_hf_checkpoint(torch, path: str, tensors: dict, config: dict) -> int:
    import os

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return write_safetensors(torch, os.path.join(path, "model.safetensors"), tensors)


def whisper_hf(torch, cfg, params) -> tuple[dict, dict]:
    """The tree as ``WhisperForConditionalGeneration`` names and lays it out
    (projections ``[out, in]``, convolutions ``[out, in, k]``), and its
    ``config.json`` (openai/whisper-large-v3's fields)."""
    from gofr_tpu_torch.models.whisper import _sinusoids

    t = {"model.encoder.conv1.weight": params["conv1"].permute(2, 1, 0),
         "model.encoder.conv1.bias": params["conv1_b"],
         "model.encoder.conv2.weight": params["conv2"].permute(2, 1, 0),
         "model.encoder.conv2.bias": params["conv2_b"],
         # HF keeps the sinusoid table; the loader recomputes it
         "model.encoder.embed_positions.weight": _sinusoids(
             cfg.max_audio_len, cfg.d_model, params["conv1"].device).to(cfg.dtype)}
    attn = {"q_proj": ("wq", "bq"), "k_proj": ("wk", None), "v_proj": ("wv", "bv"),
            "out_proj": ("wo", "bo")}
    for side, n, stack in (("encoder", cfg.n_audio_layers, params["enc"]),
                           ("decoder", cfg.n_text_layers, params["dec"])):
        blocks = [("self_attn", "")] + ([("encoder_attn", "x")] if side == "decoder" else [])
        for i in range(n):
            pre = f"model.{side}.layers.{i}."
            for block, x in blocks:
                for proj, (w, b) in attn.items():
                    t[f"{pre}{block}.{proj}.weight"] = stack[x + w][i].T
                    if b is not None:
                        t[f"{pre}{block}.{proj}.bias"] = stack[x + b][i]
            for fc, (w, b) in (("fc1", ("w1", "b1")), ("fc2", ("w2", "b2"))):
                t[f"{pre}{fc}.weight"] = stack[w][i].T
                t[f"{pre}{fc}.bias"] = stack[b][i]
            norms = [("self_attn_layer_norm", "ln1"), ("final_layer_norm", "ln2")]
            if side == "decoder":
                norms.append(("encoder_attn_layer_norm", "lnx"))
            for hf, ours in norms:
                t[f"{pre}{hf}.weight"] = stack[ours + "_s"][i]
                t[f"{pre}{hf}.bias"] = stack[ours + "_b"][i]
    t["model.encoder.layer_norm.weight"] = params["enc_ln_s"]
    t["model.encoder.layer_norm.bias"] = params["enc_ln_b"]
    t["model.decoder.embed_tokens.weight"] = params["tok_embedding"]
    t["model.decoder.embed_positions.weight"] = params["pos_embedding"]
    t["model.decoder.layer_norm.weight"] = params["dec_ln_s"]
    t["model.decoder.layer_norm.bias"] = params["dec_ln_b"]
    config = {"architectures": ["WhisperForConditionalGeneration"], "model_type": "whisper",
              "num_mel_bins": cfg.n_mels, "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
              "encoder_layers": cfg.n_audio_layers, "decoder_layers": cfg.n_text_layers,
              "encoder_attention_heads": cfg.n_heads, "decoder_attention_heads": cfg.n_heads,
              "encoder_ffn_dim": cfg.d_ff, "decoder_ffn_dim": cfg.d_ff,
              "max_source_positions": cfg.max_audio_len,
              "max_target_positions": cfg.max_text_len,
              "decoder_start_token_id": cfg.sot_id, "eos_token_id": cfg.eot_id,
              "pad_token_id": cfg.eot_id, "activation_function": "gelu",
              "torch_dtype": "bfloat16"}
    return t, config


def llama_hf(torch, cfg, params) -> tuple[dict, dict]:
    """The tree as ``LlamaForCausalLM`` names and lays it out (projections
    ``[out, in]``), and its ``config.json``."""
    lay = params["layers"]
    t = {"model.embed_tokens.weight": params["embedding"]}
    names = {"self_attn.q_proj": "wq", "self_attn.k_proj": "wk", "self_attn.v_proj": "wv",
             "self_attn.o_proj": "wo", "mlp.gate_proj": "w_gate", "mlp.up_proj": "w_up",
             "mlp.down_proj": "w_down"}
    for i in range(cfg.n_layers):
        for hf, ours in names.items():
            t[f"model.layers.{i}.{hf}.weight"] = lay[ours][i].T
        t[f"model.layers.{i}.input_layernorm.weight"] = lay["attn_norm"][i]
        t[f"model.layers.{i}.post_attention_layernorm.weight"] = lay["mlp_norm"][i]
    t["model.norm.weight"] = params["final_norm"]
    t["lm_head.weight"] = params["lm_head"].T
    config = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
              "intermediate_size": cfg.d_ff, "num_hidden_layers": cfg.n_layers,
              "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
              "max_position_embeddings": cfg.max_seq_len, "rope_theta": cfg.rope_theta,
              "rms_norm_eps": cfg.norm_eps, "tie_word_embeddings": False,
              "torch_dtype": "bfloat16"}
    return t, config


def rss_mib() -> float:
    """This process's resident set (VmRSS), MiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class PeakRss:
    """The largest resident set of this process while the block runs,
    sampled every 5 ms on a thread (the kernel's own peak, VmHWM, cannot
    be reset where /proc/self/clear_refs is not writable)."""

    def __enter__(self) -> "PeakRss":
        self.before = self.peak = rss_mib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True, name="rss")
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, rss_mib())

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(5.0)
        self.peak = max(self.peak, rss_mib())


def cosine(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def models_app(name: str, **values):
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.testutil import get_free_port

    return App(MapConfig({"APP_NAME": name, "HTTP_HOST": "127.0.0.1",
                          "HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
                          "LOG_LEVEL": "ERROR", **values}, use_env=False))


def models_e(torch, cfg, dev) -> dict:
    """E: BERT /embed on an ``App`` over real sockets: 50 single-text
    requests one at a time at 16, 128 and 512 tokens (after one warm-up
    request of each length), then one request of 32 texts of mixed
    lengths, and a request with no input."""
    import dataclasses

    import numpy as np

    from gofr_tpu_torch.models import bert
    from gofr_tpu_torch.serving.handlers import register_embedding_routes
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer, pad_batch
    from gofr_tpu_torch.testutil import fetch, start_app, stop_app

    t0 = time.perf_counter()
    params = bert.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 20), device=dev)
    rng = np.random.default_rng(SEED + 20)
    chars = list("abcdefghijklmnopqrstuvwxyz        .,;")

    def text(n_tokens: int) -> str:  # BOS plus one token a byte
        return "".join(rng.choice(chars, n_tokens - 1))

    singles = [(n, text(n)) for n in (MODELS_E_LENS * MODELS_E_REQUESTS)[:MODELS_E_REQUESTS]]
    app = models_app("models-embed")
    register_embedding_routes(app, cfg, params, ByteTokenizer())
    thread = start_app(app, timeout=120)
    url = f"http://127.0.0.1:{app.http_port}/embed"

    def post(payload) -> tuple[int, dict]:
        status, _, body = fetch(url, "POST", json.dumps(payload).encode(),
                                {"Content-Type": "application/json"}, timeout=300)
        return status, json.loads(body)

    out: dict = {"config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                            "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
                            "vocab_size": cfg.vocab_size, "max_seq_len": cfg.max_seq_len,
                            "dtype": str(cfg.dtype)}}
    try:
        for n in MODELS_E_LENS:  # cuBLAS picks each shape's GEMMs on its first call
            post({"input": text(n)})
        ms: dict = {n: [] for n in MODELS_E_LENS}
        served, meta = [], set()
        for n, t in singles:
            t1 = time.perf_counter()
            status, body = post({"input": t})
            ms[n].append((time.perf_counter() - t1) * 1e3)
            data = body.get("data", {})
            if status != 201 or data.get("usage", {}).get("prompt_tokens") != n:
                raise AssertionError(f"E: a {n}-token request answered {status} {body}")
            served.append(np.asarray(data["embeddings"][0], np.float32))
            meta.add((data["engine"], data["dim"]))
        t1 = time.perf_counter()
        status_b, body_b = post({"input": [t for _, t in singles[:MODELS_E_BATCH]]})
        batch_ms = (time.perf_counter() - t1) * 1e3
        batch = np.asarray(body_b["data"]["embeddings"], np.float32)
        refused = [post(payload)[0] for payload in ({}, {"input": []}, {"other": "x"})]
    finally:
        stop_app(app, thread)
    from gofr_tpu_torch.tree import tree_map

    params32 = tree_map(lambda v: v.float(), params)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    tok = ByteTokenizer()
    f32_cos = []
    for (_, t), emb in zip(singles, served):
        arr, lens = pad_batch(tok, [t], cfg.max_seq_len)
        want = bert.embed(cfg32, params32, torch.from_numpy(arr).to(dev),
                          torch.tensor(lens, dtype=torch.int32, device=dev))[0].cpu().numpy()
        f32_cos.append(cosine(emb, want))
    norms = np.linalg.norm(np.concatenate([np.stack(served), batch]), axis=-1)
    batch_cos = [cosine(served[i], batch[i]) for i in range(MODELS_E_BATCH)]
    out.update({
        "requests": len(singles), "engine_dim": sorted(meta),
        "ms": {n: {"p50": median(v), "p95": percentile(v, 95), "n": len(v)} for n, v in ms.items()},
        "batch": {"texts": MODELS_E_BATCH, "status": status_b, "ms": batch_ms},
        "norm_err_max": float(np.abs(norms - 1).max()),
        "cosine_alone_vs_batch_min": min(batch_cos), "cosine_f32_min": min(f32_cos),
        "no_input": refused, "seconds": time.perf_counter() - t0,
    })
    for n, v in out["ms"].items():
        print(f"  E /embed {n} tokens: p50 {v['p50']:.2f} ms, p95 {v['p95']:.2f} ms "
              f"({v['n']} requests, client clock)")
    print(f"  E a batch of {MODELS_E_BATCH} mixed-length texts: {batch_ms:.2f} ms; |norm - 1| max "
          f"{out['norm_err_max']:.2e}; cosine alone vs batch min {min(batch_cos):.6f} (tol "
          f"{COSINE_BATCH_TOL}), vs f32 min {min(f32_cos):.6f} (tol {COSINE_F32_TOL}); no input "
          f"{refused}; engine, dim {sorted(meta)}")
    if not (out["norm_err_max"] <= 1e-3 and min(batch_cos) >= COSINE_BATCH_TOL
            and min(f32_cos) >= COSINE_F32_TOL and status_b == 201
            and refused == [400, 400, 400] and meta == {("torch", cfg.d_model)}
            and len(batch) == MODELS_E_BATCH):
        raise AssertionError(f"E: {out}")
    return out


def asr_clip(rng, seconds: float):
    """Seeded 16 kHz audio: a few tones and noise, within [-1, 1]."""
    import numpy as np

    t = np.arange(int(16000 * seconds)) / 16000.0
    x = sum(0.2 * np.sin(2 * np.pi * f * t + p)
            for f, p in zip(rng.uniform(80, 4000, 4), rng.uniform(0, 6.3, 4)))
    return (x + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def models_a(torch, cfg, dev, tmp: str) -> dict:
    """A: Whisper ASR over Pub/Sub from a checkpoint this phase writes in the
    HF layout and loads back: 3 jobs of seeded audio and an empty one
    through ``app.subscribe("asr-jobs", worker.handler)`` on the in-memory
    broker, one at a time, each reply against a direct ``transcribe``."""
    import base64
    import dataclasses
    import os
    import shutil

    import numpy as np

    from gofr_tpu_torch.models import whisper
    from gofr_tpu_torch.models.whisper_import import load_whisper_from_hf
    from gofr_tpu_torch.serving.asr import ASRWorker
    from gofr_tpu_torch.testutil import start_app, stop_app
    from gofr_tpu_torch.testutil.params import perturb_norms_and_biases

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    params = whisper.init_params(cfg, gen, device=dev)
    perturb_norms_and_biases(params, gen)
    torch.cuda.synchronize()
    path = os.path.join(tmp, "whisper")
    t1 = time.perf_counter()
    nbytes = write_hf_checkpoint(torch, path, *whisper_hf(torch, cfg, params))
    write_s = time.perf_counter() - t1
    with PeakRss() as rss:
        t1 = time.perf_counter()
        lcfg, loaded = load_whisper_from_hf(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
    out: dict = {"checkpoint_bytes": nbytes, "write_s": write_s, "load_s": load_s,
                 "load_gb_s": nbytes / load_s / 1e9, "host_rss_mib_before": rss.before,
                 "host_rss_peak_mib": rss.peak,
                 "loaded_equal": tree_equal(torch, loaded, params) and lcfg == cfg}
    shutil.rmtree(path)
    del params
    print(f"  A Whisper checkpoint {nbytes / 1e9:.3f} GB written in {write_s:.2f} s, loaded in "
          f"{load_s:.2f} s ({out['load_gb_s']:.2f} GB/s), host RSS {rss.before:.0f} MiB before, "
          f"{rss.peak:.0f} MiB at its peak during the load; loaded params bit-identical: "
          f"{out['loaded_equal']}")
    if not out["loaded_equal"]:
        raise AssertionError("A: the loaded Whisper params differ from the written ones")
    worker = ASRWorker(lcfg, loaded)
    rng = np.random.default_rng(SEED + 21)
    clips = {s: asr_clip(rng, s) for s in MODELS_ASR_SECONDS}
    # the reference of each reply (and the first call of each shape)
    direct = {s: whisper.transcribe(lcfg, loaded, worker.mel(c), MODELS_ASR_TOKENS)[0]
              for s, c in clips.items()}
    app = models_app("models-asr", PUBSUB_BACKEND="MEMORY")
    app.subscribe("asr-jobs", worker.handler)
    thread = start_app(app, timeout=120)
    broker = app.container.pubsub
    replies, job_ms = {}, {}
    try:
        for s in [*MODELS_ASR_SECONDS, "empty"]:
            raw = b"" if s == "empty" else clips[s].tobytes()
            job = {"id": f"{s}", "audio_b64": base64.b64encode(raw).decode(),
                   "sample_rate": 16000, "max_tokens": MODELS_ASR_TOKENS,
                   "reply_topic": "asr-results"}
            t1 = time.perf_counter()
            broker.publish("asr-jobs", json.dumps(job).encode())
            t_end = time.monotonic() + 300
            msg = None
            while msg is None:
                if time.monotonic() > t_end:
                    raise AssertionError(f"A: no reply to the {s} job")
                msg = broker.subscribe("asr-results")
            job_ms[f"{s}"] = (time.perf_counter() - t1) * 1e3
            msg.commit()
            replies[f"{s}"] = json.loads(msg.value)
    finally:
        stop_app(app, thread)
    equal = {f"{s}": replies[f"{s}"].get("token_ids") == direct[s] for s in MODELS_ASR_SECONDS}
    # timings on the 30 s clip: the encoder, then the decode loop as
    # ``transcribe`` runs it (one host read a token)
    mel = worker.mel(clips[MODELS_ASR_SECONDS[-1]])
    enc = whisper.encode_audio(lcfg, loaded, mel)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    enc = whisper.encode_audio(lcfg, loaded, mel)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t1) * 1e3
    cache = whisper.DecCache.create(lcfg, 1, dev)
    tokens = torch.full((1,), lcfg.sot_id, dtype=torch.int64, device=dev)
    steps = min(MODELS_ASR_TOKENS, lcfg.max_text_len - 1)
    t1 = time.perf_counter()
    for step in range(steps):
        pos = torch.full((1,), step, dtype=torch.int64, device=dev)
        logits, cache = whisper.decode_text_step(lcfg, loaded, enc, tokens, cache, pos)
        tokens = torch.argmax(logits, dim=-1)
        tokens.cpu()
    token_ms = (time.perf_counter() - t1) * 1e3 / steps
    # the first step's logits against an f32 run of the same weights
    first = whisper.decode_text_step(lcfg, loaded, enc, torch.full((1,), lcfg.sot_id, device=dev),
                                     whisper.DecCache.create(lcfg, 1, dev),
                                     torch.zeros(1, dtype=torch.int64, device=dev))[0]
    cfg32 = dataclasses.replace(lcfg, dtype=torch.float32)
    from gofr_tpu_torch.tree import tree_map

    params32 = tree_map(lambda v: v.float(), loaded)
    enc32 = whisper.encode_audio(cfg32, params32, mel)
    want = whisper.decode_text_step(cfg32, params32, enc32, torch.full((1,), lcfg.sot_id,
                                                                        device=dev),
                                    whisper.DecCache.create(cfg32, 1, dev),
                                    torch.zeros(1, dtype=torch.int64, device=dev))[0]
    rel = ((first - want).norm() / want.norm()).item()
    del params32, enc32
    out.update({
        "config": {"n_mels": lcfg.n_mels, "vocab_size": lcfg.vocab_size,
                   "d_model": lcfg.d_model, "n_audio_layers": lcfg.n_audio_layers,
                   "n_text_layers": lcfg.n_text_layers, "n_heads": lcfg.n_heads,
                   "d_ff": lcfg.d_ff, "dtype": str(lcfg.dtype)},
        "jobs": {s: {"tokens": len(r.get("token_ids") or []), "publish_to_reply_ms": job_ms[s]}
                 for s, r in replies.items()},
        "token_equal": equal, "empty_reply": replies["empty"],
        "encode_ms_30s": encode_ms, "encoder_frames_30s": int(enc.shape[1]),
        "ms_per_token": token_ms, "first_logits_rel_l2": rel,
        "seconds": time.perf_counter() - t0,
    })
    print(f"  A jobs (publish to reply): "
          f"{ {s: round(v['publish_to_reply_ms'], 1) for s, v in out['jobs'].items()} } ms, "
          f"tokens {[v['tokens'] for v in out['jobs'].values()]}; replies equal to transcribe "
          f"{equal}; empty job {replies['empty']}")
    print(f"  A encode of 30 s ({out['encoder_frames_30s']} frames) {encode_ms:.2f} ms; "
          f"{token_ms:.2f} ms a decoded token; first-step logits rel_l2 against f32 {rel:.3e} "
          f"(tol {LOGITS_REL_TOL})")
    if not (all(equal.values()) and replies["empty"] == {"id": "empty", "error": "empty audio"}
            and rel <= LOGITS_REL_TOL and all(v["tokens"] > 0 for s, v in out["jobs"].items()
                                              if s != "empty")):
        raise AssertionError(f"A: {out}")
    return out


def models_l(torch, cfg, dev, tmp: str) -> dict:
    """L: an HF-layout Llama checkpoint at the configured width and a small
    byte-level BPE ``tokenizer.json`` with Llama-3's Split pattern, served
    by ``ServingEngine.from_hf`` (paged bf16, 16-token pages, whole
    prefills) beside an engine built from the same params."""
    import os

    from gofr_tpu_torch import EngineConfig, ServingEngine
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.testutil.assets import bpe_spec, write_bpe_asset
    from gofr_tpu_torch.testutil.params import perturb_norms_and_biases
    from gofr_tpu_torch.tokenizer import BPETokenizer

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    params = llama.init_params(cfg, gen, device=dev)
    perturb_norms_and_biases(params, gen)
    torch.cuda.synchronize()
    path = os.path.join(tmp, "llama")
    t1 = time.perf_counter()
    nbytes = write_hf_checkpoint(torch, path, *llama_hf(torch, cfg, params))
    write_bpe_asset(path, bpe_spec(MODELS_L_MERGES),
                    {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>"})
    write_s = time.perf_counter() - t1
    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                prefill_chunk_tokens=2048)
    with PeakRss() as rss:
        t1 = time.perf_counter()
        engine = ServingEngine.from_hf(path, engine_config=EngineConfig(**conf), device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
    out: dict = {"checkpoint_bytes": nbytes, "write_s": write_s, "load_s": load_s,
                 "load_gb_s": nbytes / load_s / 1e9, "host_rss_mib_before": rss.before,
                 "host_rss_peak_mib": rss.peak,
                 "loaded_equal": tree_equal(torch, engine.params, params)
                 and engine.model_cfg == cfg}
    tok = engine.tokenizer
    round_trip = {t: tok.decode(tok.encode(t)) == t.replace("<|begin_of_text|>", "")
                  for t in MODELS_L_TEXTS}
    out["tokenizer"] = {"kind": f"{type(tok).__module__}.{type(tok).__name__}",
                        "vocab_size": tok.vocab_size, "round_trip": round_trip}
    print(f"  L checkpoint {nbytes / 1e9:.3f} GB ({cfg.n_layers} layers at d {cfg.d_model}) "
          f"written in {write_s:.2f} s; from_hf in {load_s:.2f} s ({out['load_gb_s']:.2f} GB/s), "
          f"host RSS {rss.before:.0f} MiB before, {rss.peak:.0f} MiB at its peak during the "
          f"load; loaded params bit-identical: {out['loaded_equal']}; tokenizer {out['tokenizer']}")
    if not (out["loaded_equal"] and isinstance(tok, BPETokenizer) and all(round_trip.values())):
        raise AssertionError(f"L: {out}")
    rng = torch.Generator().manual_seed(SEED + 22)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist() for n in MAIN_LENS]
    prompts += MODELS_L_TEXTS
    direct = ServingEngine(cfg, params, EngineConfig(**conf), tokenizer=tok, device=dev)
    got = {}
    mark = launch_counts()
    for name, eng in (("from_hf", engine), ("direct", direct)):
        eng.start()
        try:
            futs = [eng.submit(p, max_new_tokens=MODELS_L_NEW, temperature=0.0) for p in prompts]
            got[name] = [f.result(600).token_ids for f in futs]
        finally:
            eng.stop()
        if name == "from_hf":
            out["launches"] = since(mark)
    out["tokens_equal"] = sum(a == b for a, b in zip(got["from_hf"], got["direct"]))
    print(f"  L from_hf engine against the direct engine: {out['tokens_equal']}/{len(prompts)} "
          f"greedy requests token-equal ({MODELS_L_NEW} new tokens each)")
    print_launches("L from_hf engine", out["launches"])
    del direct
    # without the tokenizer asset the engine keeps its ByteTokenizer
    for name in ("tokenizer.json", "tokenizer_config.json"):
        os.remove(os.path.join(path, name))
    bare = ServingEngine.from_hf(path, engine_config=EngineConfig(**conf), device=dev)
    out["fallback_tokenizer"] = type(bare.tokenizer).__name__
    del bare
    # forward's last position (plain attention) against the flash prefill's
    lcfg, lparams = engine.model_cfg, engine.params
    ids = torch.tensor([prompts[MAIN_LENS.index(1000)]], device=dev)
    lens = torch.tensor([ids.shape[1]], dtype=torch.int32, device=dev)
    fwd = llama.forward(lcfg, lparams, ids)[:, -1]
    pre = llama._prefill_slabs(lcfg, lparams, ids, lens)[0]
    out["forward_vs_prefill_rel_l2"] = ((fwd - pre).norm() / pre.norm()).item()
    out["seconds"] = time.perf_counter() - t0
    print(f"  L fallback tokenizer without tokenizer.json: {out['fallback_tokenizer']}; "
          f"forward vs flash prefill logits rel_l2 {out['forward_vs_prefill_rel_l2']:.3e} "
          f"(tol {LOGITS_REL_TOL}, {ids.shape[1]} tokens)")
    if not (out["tokens_equal"] == len(prompts) and out["fallback_tokenizer"] == "ByteTokenizer"
            and out["forward_vs_prefill_rel_l2"] <= LOGITS_REL_TOL):
        raise AssertionError(f"L: {out}")
    return out


def run_models(torch, bert_cfg, whisper_cfg, llama_cfg) -> dict:
    """The other served model families at the widths given (the card run
    gives BERT-base, Whisper-large-v3 and Llama-3-8B at 2 layers): E (BERT
    /embed), A (Whisper ASR over Pub/Sub from a written-and-loaded
    checkpoint), L (a Llama checkpoint and tokenizer through ``from_hf``).
    The counters are reset before the phase; L's ``from_hf`` engine must
    launch flash and the bf16 paged kernel."""
    import tempfile

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    zero_launches()
    out: dict = {"card": card_line()}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_models_", dir=ROOT) as tmp:
        print(f"E: BERT /embed ({bert_cfg.n_layers} layers, d {bert_cfg.d_model}, "
              f"{bert_cfg.dtype}) on an App")
        out["E"] = models_e(torch, bert_cfg, dev)
        print(f"A: Whisper ASR over Pub/Sub ({whisper_cfg.n_audio_layers}+"
              f"{whisper_cfg.n_text_layers} layers, d {whisper_cfg.d_model}, "
              f"{whisper_cfg.n_mels} mels), from a checkpoint written and loaded back")
        out["A"] = models_a(torch, whisper_cfg, dev, tmp)
        torch.cuda.empty_cache()
        print(f"L: Llama through from_hf (d {llama_cfg.d_model}, {llama_cfg.n_layers} layers, "
              f"vocab {llama_cfg.vocab_size})")
        out["L"] = models_l(torch, llama_cfg, dev, tmp)
    out["launches"] = out["L"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    print(f"  models: {out['seconds']:.1f}s ({out['card']})")
    if not (out["launches"].get("flash_attention") and out["launches"].get("paged_decode_attention")):
        raise AssertionError(f"models launches {out['launches']}")
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- device phase
DEVICE_T_BATCH, DEVICE_T_SEQ, DEVICE_T_STEPS = 2, 512, 4  # T: the training batch and steps
# T: the resumed run's final loss, and each param leaf (relative L2), against
# 4 straight steps. Only the embedding's gradient (an accumulating index put
# over repeated token ids) may sum in another order, so they agree to far
# better than this
RESUME_REL_TOL = 1e-3
DEVICE_K_NEW = 32  # K: new tokens a request
DEVICE_D_REPS = 20  # D: timed calls of each executable, replay and eager
DEVICE_D_WINDOW_S = 10.5  # D: executes for longer than the duty-cycle window (10 s)
DEVICE_D_PACE_S = 0.05  # D: the gap between those executes (a served request rate)
DEVICE_D_LLAMA_SEQ = 128  # D: llama8's tokens
MOE_DEPTH, MOE_SEQ = 2, 512  # X: layers of Mixtral-8x7B's 32, and tokens
MOE_FEW = 2  # X: tokens of the short backward, too few to reach every expert


def device_t(torch, cfg, tmp: str, dev) -> tuple[dict, dict]:
    """T: ``make_train_step`` at ``cfg`` (Llama-3-8B widths, ``DEVICE_T_DEPTH``
    layers): 4 steps on one repeated batch, the loss falling and every
    gradient finite (the optimizer's first moments after step 1 are
    0.1 × the gradient); then a second run of 2 steps, a checkpoint of
    params and optimizer state, a restore and 2 more, held to the 4
    straight steps. Returns the report and the trained params."""
    from gofr_tpu_torch.checkpoint import CheckpointManager
    from gofr_tpu_torch.models import llama, train
    from gofr_tpu_torch.tree import leaves

    init_opt, step = train.make_train_step(cfg)

    def fresh():
        return llama.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 16),
                                 device=dev)

    tokens = torch.randint(0, cfg.vocab_size, (DEVICE_T_BATCH, DEVICE_T_SEQ), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 17))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    params = fresh()
    n_params = sum(t.numel() for t in leaves(params))
    opt = init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, grads_finite, grads_reach = [], [], None, None
    for i in range(DEVICE_T_STEPS):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if i == 0:
            moments = leaves(opt["exp_avg"])
            grads_finite = all(bool(torch.isfinite(m).all()) for m in moments)
            grads_reach = all(bool((m != 0).any()) for m in moments)
    peak = torch.cuda.max_memory_allocated()
    out: dict = {"params": n_params, "layers": cfg.n_layers, "batch": [DEVICE_T_BATCH, DEVICE_T_SEQ],
                 "losses": losses, "step_ms": step_ms, "median_step_ms": median(step_ms[1:]),
                 "peak_memory_allocated_bytes": peak, "memory_allocated_before_bytes": before,
                 "grads_finite": grads_finite,
                 "grads_reach_every_leaf": grads_reach,
                 "params_finite": all(bool(torch.isfinite(t).all()) for t in leaves(params))}
    print(f"  T {n_params / 1e9:.2f}B params ({cfg.n_layers} layers), batch {DEVICE_T_BATCH}x"
          f"{DEVICE_T_SEQ}: losses {losses}, ms a step {[round(x, 1) for x in step_ms]} (median "
          f"of steps 2-4 {out['median_step_ms']:.1f}), peak memory_allocated {peak / 1e9:.2f} GB "
          f"({before / 1e9:.2f} GB of it allocated before the phase), "
          f"gradients finite {grads_finite} and reaching every leaf {grads_reach}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0] and grads_finite
            and grads_reach and out["params_finite"]):
        raise AssertionError(f"T: {out}")
    del opt
    torch.cuda.empty_cache()
    # resume: 2 steps, a checkpoint of params and optimizer state, 2 more
    p2 = fresh()
    s2 = init_opt(p2)
    for _ in range(2):
        p2, s2, _ = step(p2, s2, tokens)
    mgr = CheckpointManager(os.path.join(tmp, "resume"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(2, {"params": p2, "opt": s2})
    save_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in leaves({"params": p2, "opt": s2}))
    abstract = {"params": p2, "opt": s2}
    t0 = time.perf_counter()
    restored = mgr.restore(abstract, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del p2, s2, abstract
    torch.cuda.empty_cache()
    p3, s3 = restored["params"], restored["opt"]
    del restored
    for _ in range(2):
        p3, s3, loss = step(p3, s3, tokens)
    resumed = float(loss)
    leaf_rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                   for a, b in zip(leaves(p3), leaves(params)))
    bit_equal = all(torch.equal(a, b) for a, b in zip(leaves(p3), leaves(params)))
    out["resume"] = {"checkpoint_bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
                     "save_gb_s": nbytes / save_s / 1e9, "restore_gb_s": nbytes / restore_s / 1e9,
                     "loss_resumed": resumed, "loss_straight": losses[-1],
                     "loss_rel_diff": abs(resumed - losses[-1]) / abs(losses[-1]),
                     "max_leaf_rel_l2": leaf_rel, "bit_equal": bit_equal, "tol": RESUME_REL_TOL}
    print(f"  T resume: {nbytes / 1e9:.2f} GB of params and optimizer state saved in {save_s:.2f} s "
          f"and restored in {restore_s:.2f} s; final loss {resumed} against {losses[-1]} straight "
          f"(rel {out['resume']['loss_rel_diff']:.2e}), params max leaf rel_l2 {leaf_rel:.2e} "
          f"(tol {RESUME_REL_TOL}), bit-equal {bit_equal}")
    if not (out["resume"]["loss_rel_diff"] <= RESUME_REL_TOL and leaf_rel <= RESUME_REL_TOL):
        raise AssertionError(f"T resume: {out['resume']}")
    del p3, s3
    shutil.rmtree(os.path.join(tmp, "resume"), ignore_errors=True)
    torch.cuda.empty_cache()
    return out, params


def device_k(torch, cfg, params, tmp: str, dev) -> dict:
    """K: T's params through ``CheckpointManager`` (npz, keep=3), then
    ``ServingEngine.from_checkpoint`` (paged bf16, 8 slots, N = 4, 16-token
    pages, 2048) serving the main prompts greedy, token-equal to an engine
    built from the same params; flash and bf16 paged launches counted."""
    from gofr_tpu_torch import EngineConfig, ServingEngine
    from gofr_tpu_torch.checkpoint import CheckpointManager
    from gofr_tpu_torch.models.llama import param_bytes

    path = os.path.join(tmp, "serve")
    mgr = CheckpointManager(path, keep=3)
    nbytes = param_bytes(params)
    torch.cuda.synchronize()
    with PeakRss() as save_rss:
        t0 = time.perf_counter()
        mgr.save(DEVICE_T_STEPS, params, metadata={"source": "chip_smoke device T"})
        save_s = time.perf_counter() - t0
    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                prefill_chunk_tokens=2048)
    with PeakRss() as load_rss:
        t0 = time.perf_counter()
        engine = ServingEngine.from_checkpoint(cfg, path, engine_config=EngineConfig(**conf),
                                               device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    out: dict = {"checkpoint_bytes": nbytes, "save_s": save_s, "save_gb_s": nbytes / save_s / 1e9,
                 "from_checkpoint_s": load_s, "restore_gb_s": nbytes / load_s / 1e9,
                 "save_rss_mib": [save_rss.before, save_rss.peak],
                 "restore_rss_mib": [load_rss.before, load_rss.peak],
                 "restored_equal": tree_equal(torch, engine.params, params),
                 "steps": mgr.all_steps()}
    print(f"  K {nbytes / 1e9:.2f} GB saved in {save_s:.2f} s ({out['save_gb_s']:.2f} GB/s, host RSS "
          f"{save_rss.before:.0f} -> {save_rss.peak:.0f} MiB), from_checkpoint in {load_s:.2f} s "
          f"({out['restore_gb_s']:.2f} GB/s, RSS {load_rss.before:.0f} -> {load_rss.peak:.0f} MiB); "
          f"restored bit-identical: {out['restored_equal']}")
    if not out["restored_equal"] or out["steps"] != [DEVICE_T_STEPS]:
        raise AssertionError(f"K: {out}")
    rng = torch.Generator().manual_seed(SEED + 18)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist() for n in MAIN_LENS]
    direct = ServingEngine(cfg, params, EngineConfig(**conf), device=dev)
    got, launches = {}, {}
    for name, eng in (("from_checkpoint", engine), ("direct", direct)):
        mark = launch_counts()
        eng.start()
        try:
            futs = [eng.submit(p, max_new_tokens=DEVICE_K_NEW, temperature=0.0) for p in prompts]
            got[name] = [f.result(600).token_ids for f in futs]
        finally:
            eng.stop()
        launches[name] = since(mark)
    out["tokens_equal"] = sum(a == b for a, b in zip(got["from_checkpoint"], got["direct"]))
    out["launches"] = launches
    print(f"  K from_checkpoint engine against the direct engine: {out['tokens_equal']}/"
          f"{len(prompts)} greedy requests token-equal ({DEVICE_K_NEW} new tokens each)")
    for name, counts in launches.items():
        print_launches(f"K {name} engine", counts)
    if out["tokens_equal"] != len(prompts) or not all(
            launches[n]["flash_attention"] and launches[n]["paged_decode_attention"]
            for n in launches):
        raise AssertionError(f"K: {out}")
    del engine, direct
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def timed_ms(torch, fn, reps: int) -> float:
    """Median host ms of ``fn()`` then a sync, over ``reps`` calls after one."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return median(times)


def device_d(torch, cfg, params, dev) -> dict:
    """D: an ``App`` on 127.0.0.1 with ``app.add_tpu(new_tpu(config))``;
    handlers call ``ctx.tpu.execute`` on three executables captured as CUDA
    graphs: ``flash`` (B=1, S=1024, H=32, Hkv=8, D=128, causal), ``paged``
    (bf16, B=8 over 2851 tokens, page 16) and ``llama8`` (``llama.forward``
    at ``cfg``, B=1, S=128). Each replay is held to an eager call on the
    same inputs (flash and paged bit-equal; llama8 within
    ``LOGITS_REL_TOL``), then again on fresh arguments of the same shapes,
    flash and paged to their plain versions; replay
    and eager ms (median of 20); a wrong shape is a ``TPUError`` and a
    503; health and ``/metrics`` carry the datasource."""
    from gofr_tpu_torch.datasource.tpu import TPUError, new_tpu
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_ref
    from gofr_tpu_torch.testutil import fetch, start_app, stop_app

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    inputs = {
        "flash": flash_inputs(torch, gen, 1024, [1024], device=dev),
        "paged": paged_inputs(torch, gen, DECODE_LENS, device=dev),
        "llama8": (torch.randint(0, cfg.vocab_size, (1, DEVICE_D_LLAMA_SEQ), device=dev,
                                 generator=gen),),
    }
    fns = {
        "flash": lambda q, k, v, n: flash_attention(q, k, v, n, causal=True),
        "paged": paged_decode_attention,
        "llama8": lambda tokens: llama.forward(cfg, params, tokens),
    }
    app = models_app("device-d")
    client = new_tpu(app.config, device=dev)
    app.add_tpu(client)
    out: dict = {"compile": {}}
    mark = launch_counts()
    for name, fn in fns.items():
        client.compile(name, fn, *inputs[name])
        meta = client._exec_meta[name]
        out["compile"][name] = {k: meta[k] for k in ("compile_seconds", "flops", "graph",
                                                     "captured_launches")}
    results: dict = {}

    def run(ctx):
        name = ctx.path_param("name")
        args = inputs.get(name, inputs["flash"])
        if (ctx.bind(dict) or {}).get("wrong_shape"):
            args = (args[0][:, : args[0].shape[1] // 2].contiguous(), *args[1:])
        y = ctx.tpu.execute(name, *args)
        results[name] = y
        return {"shape": list(y.shape), "dtype": str(y.dtype)}

    app.post("/exec/{name}", run)
    thread = start_app(app, timeout=120)
    base = f"http://127.0.0.1:{app.http_port}"
    mbase = f"http://127.0.0.1:{app.metrics_port}"

    def call(path: str, payload=None, method="POST"):
        body = json.dumps(payload or {}).encode() if method == "POST" else None
        status, _, raw = fetch(base + path, method, body, {"Content-Type": "application/json"}, 120)
        return status, json.loads(raw)

    try:
        t_first = time.perf_counter()
        checks = {}
        for name in fns:
            status, body = call(f"/exec/{name}")
            want = fns[name](*inputs[name])
            got = results[name]
            torch.cuda.synchronize()
            rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
            checks[name] = {"status": status, "bit_equal_to_eager": bool(torch.equal(got, want)),
                            "rel_l2_to_eager": rel, "finite": bool(torch.isfinite(got).all())}
        # fresh arguments at the same shapes: execute copies them in (an
        # executable replaying what it was compiled on would differ here)
        fresh = {
            "flash": (torch.randn(inputs["flash"][0].shape, device=dev, generator=gen,
                                  dtype=torch.bfloat16), *inputs["flash"][1:]),
            "paged": (torch.randn(inputs["paged"][0].shape, device=dev, generator=gen,
                                  dtype=torch.bfloat16), *inputs["paged"][1:]),
            "llama8": (torch.randint(0, cfg.vocab_size, (1, DEVICE_D_LLAMA_SEQ), device=dev,
                                     generator=gen),),
        }
        for name, fn in fns.items():
            got = client.execute(name, *fresh[name])
            want = fn(*fresh[name])
            torch.cuda.synchronize()
            checks[name]["fresh_args"] = {
                "bit_equal_to_eager": bool(torch.equal(got, want)),
                "rel_l2_to_eager": ((got.float() - want.float()).norm()
                                    / want.float().norm()).item(),
                "differs_from_first": not torch.equal(got, results[name])}
        q, k, v, n = inputs["flash"]
        checks["flash"]["row_rel_err_to_plain"] = row_rel_err(
            results["flash"], flash_attention_ref(q, k, v, n, causal=True))
        checks["paged"]["row_rel_err_to_plain"] = row_rel_err(
            results["paged"], paged_decode_attention_ref(*inputs["paged"]))
        out["checks"] = checks
        print(f"  D replay against eager and plain: {checks}")
        if not (all(c["status"] == 201 and c["finite"] and c["fresh_args"]["differs_from_first"]
                    for c in checks.values())
                and all(checks[n]["bit_equal_to_eager"] and checks[n]["fresh_args"]["bit_equal_to_eager"]
                        for n in ("flash", "paged"))
                and checks["llama8"]["rel_l2_to_eager"] <= LOGITS_REL_TOL
                and checks["llama8"]["fresh_args"]["rel_l2_to_eager"] <= LOGITS_REL_TOL
                and checks["flash"]["row_rel_err_to_plain"] <= FLASH_ROW_TOL
                and checks["paged"]["row_rel_err_to_plain"] <= PAGED_ROW_TOL):
            raise AssertionError(f"D checks: {checks}")
        # a wrong shape: a TPUError before anything runs, a 503 through the app
        try:
            client.execute("flash", q[:, :512].contiguous(), k, v, n)
            direct_err = None
        except TPUError as exc:
            direct_err = str(exc)
        status, body = call("/exec/flash", {"wrong_shape": True})
        _, health_bad = call("/.well-known/health", method="GET")
        call("/exec/flash")
        _, health_ok = call("/.well-known/health", method="GET")
        tpu_bad, tpu_ok = health_bad["data"]["details"]["tpu"], health_ok["data"]["details"]["tpu"]
        out["wrong_shape"] = {"direct": direct_err, "status": status,
                              "message": body.get("error", {}).get("message"),
                              "health_after": tpu_bad["status"],
                              "last_error": tpu_bad["details"].get("last_error"),
                              "health_after_success": tpu_ok["status"],
                              "hbm": tpu_ok["details"]["hbm"]}
        print(f"  D wrong shape and health: {out['wrong_shape']}")
        if not (direct_err and "argument 0" in direct_err and status == 503
                and tpu_bad["status"] == "DEGRADED" and tpu_bad["details"].get("last_error")
                and tpu_ok["status"] == "UP" and tpu_ok["details"]["hbm"][0]["bytes_in_use"] > 0):
            raise AssertionError(f"D wrong shape: {out['wrong_shape']}")
        # replay against eager, median of DEVICE_D_REPS each
        timing = {}
        for name, fn in fns.items():
            args = inputs[name]
            timing[name] = {
                "replay_ms": timed_ms(torch, lambda: client.execute(name, *args), DEVICE_D_REPS),
                "eager_ms": timed_ms(torch, lambda: fn(*args), DEVICE_D_REPS)}
        out["timing"] = timing
        print(f"  D replay (execute: copy in, replay, clone out) against eager ms, median of "
              f"{DEVICE_D_REPS}: {timing}")
        # keep executing past the 10 s duty-cycle window, then read /metrics
        while time.perf_counter() - t_first < DEVICE_D_WINDOW_S:
            client.execute("paged", *inputs["paged"], block=True)
            time.sleep(DEVICE_D_PACE_S)
        client.execute("flash", *inputs["flash"], block=True)
        _, _, raw = fetch(mbase + "/metrics", "GET", None, None, 60)
        text = raw.decode()
        duty = re.search(r"^app_tpu_duty_cycle (\S+)$", text, re.M)
        out["metrics"] = {"hbm_used_bytes": bool(re.search(r'^app_tpu_hbm_used_bytes\{device="\d+"\} '
                                                           r"[1-9]", text, re.M)),
                          "duty_cycle": float(duty.group(1)) if duty else None,
                          "tpu_execute_series": 'type="tpu_execute"' in text}
        print(f"  D /metrics: {out['metrics']}")
        if not (out["metrics"]["hbm_used_bytes"] and duty and out["metrics"]["tpu_execute_series"]):
            raise AssertionError(f"D metrics: {out['metrics']}")
        out["replays"] = {name: client._exec_meta[name]["replays"] for name in fns}
        out["launches_replayed"] = {}
        for name in fns:
            for kernel, n in client._exec_meta[name]["captured_launches"].items():
                out["launches_replayed"][kernel] = out["launches_replayed"].get(kernel, 0) \
                    + n * out["replays"][name]
        out["launches_counted"] = since(mark)  # warm-ups, captures and the eager calls
        print(f"  D replays {out['replays']}: captured launches x replays "
              f"{out['launches_replayed']}; counted by the wrappers (warm-ups, captures, eager "
              f"calls) {out['launches_counted']}")
        if not (out["launches_replayed"].get("flash_attention")
                and out["launches_replayed"].get("paged_decode_attention")):
            raise AssertionError(f"D launches: {out['launches_replayed']}")
    finally:
        stop_app(app, thread)
    client.close()
    torch.cuda.empty_cache()
    return out


def device_x(torch, cfg, dev) -> dict:
    """X: the MoE at ``cfg`` (the card run: ``MoeConfig.mixtral_8x7b()``
    widths at ``MOE_DEPTH`` layers), B=1, S=512: finite logits, a finite positive load-balance loss equal to
    ``load_balance_loss``'s own pass, and a backward through CE plus the
    aux loss reaching every expert a token was routed to (and no other),
    at S=512 and on ``MOE_FEW`` tokens, which leave experts unrouted."""
    from gofr_tpu_torch.models import moe, train
    from gofr_tpu_torch.ops import moe as moe_ops
    from gofr_tpu_torch.tree import leaves

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    params = moe.init_params(cfg, gen, device=dev)
    experts = sum(params["layers"][k].numel() * params["layers"][k].element_size()
                  for k in ("w_gate", "w_up", "w_down"))
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_SEQ), device=dev, generator=gen)
    with torch.no_grad():
        fwd_ms = timed_ms(torch, lambda: moe.forward(cfg, params, tokens), 3)
        logits, (f, p) = moe.forward(cfg, params, tokens, return_aux=True)
        aux = moe.load_balance_loss_from_stats(cfg, f, p)
        own = moe.load_balance_loss(cfg, params, tokens)
    out: dict = {"layers": cfg.n_layers, "experts_bytes": experts, "forward_ms": fwd_ms,
                 "logits_finite": bool(torch.isfinite(logits).all()), "aux": float(aux),
                 "aux_own_pass": float(own), "aux_bit_equal": bool(torch.equal(aux, own))}
    del logits
    for t in leaves(params):
        t.requires_grad_(True)

    def backward(toks):
        """(loss, experts routed a layer, gradients finite, gradients on
        exactly the routed experts) of one backward through CE plus aux."""
        routed: list = []
        for t in leaves(params):
            t.grad = None
        with spying(moe_ops, "router_topk", lambda bound, res: routed.append(
                set(res[0].flatten().tolist()))):
            logits, (f, p) = moe.forward(cfg, params, toks, return_aux=True)
            loss = train.next_token_nll(logits, toks) + cfg.aux_loss_coef * \
                moe.load_balance_loss_from_stats(cfg, f, p)
            loss.backward()
        layers = params["layers"]
        reach = [all(bool(layers[w].grad[layer, e].abs().sum() > 0)
                     for w in ("w_gate", "w_up", "w_down")) == (e in chosen)
                 for layer, chosen in enumerate(routed) for e in range(cfg.n_experts)]
        return (float(loss.detach()), [sorted(c) for c in routed],
                all(bool(torch.isfinite(t.grad).all()) for t in leaves(params)),
                all(reach) and len(routed) == cfg.n_layers)

    # MOE_FEW tokens route to at most MOE_FEW x top_k experts a layer, so
    # the experts that got none (and must get no gradient) are checked too
    few = tokens[:, :MOE_FEW].contiguous()
    few_loss, few_routed, few_finite, few_match = backward(few)
    loss, routed, finite, match = backward(tokens)
    out.update({"loss": loss, "routed": routed, "grads_finite": finite and few_finite,
                "grads_match_routing": match and few_match,
                "few": {"tokens": MOE_FEW, "loss": few_loss, "routed": few_routed,
                        "unrouted_experts": any(len(c) < cfg.n_experts for c in few_routed)}})
    print(f"  X d {cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, {cfg.n_layers} layers "
          f"({experts / 1e9:.2f} GB of experts), "
          f"B=1 S={MOE_SEQ}: forward {fwd_ms:.2f} ms, logits finite {out['logits_finite']}, aux "
          f"{out['aux']} (own pass {out['aux_own_pass']}, bit-equal {out['aux_bit_equal']}), "
          f"loss {out['loss']}, experts routed {out['routed']} ({MOE_FEW} tokens: "
          f"{out['few']['routed']}), gradients finite {out['grads_finite']} and on exactly the "
          f"routed experts {out['grads_match_routing']}")
    if not (out["logits_finite"] and math.isfinite(out["aux"]) and out["aux"] > 0
            and abs(out["aux"] - out["aux_own_pass"]) <= 1e-6 * out["aux"]
            and math.isfinite(loss) and math.isfinite(few_loss)
            and out["grads_finite"] and out["grads_match_routing"]
            and out["few"]["unrouted_experts"]):
        raise AssertionError(f"X: {out}")
    del params
    torch.cuda.empty_cache()
    return out


def run_device(torch, cfg, moe_cfg, dev) -> dict:
    """The device phase at the configs given (the card run: Llama-3-8B
    widths at ``DEVICE_T_DEPTH`` layers and Mixtral-8x7B's at ``MOE_DEPTH``): T
    (training with a checkpointed resume), K (checkpoint and warm restart
    through ``from_checkpoint``), D (the device datasource: ``ctx.tpu`` on
    an ``App``, executables as CUDA graphs), X (the MoE). The counters are reset before it; ``launches``
    are K's engines' counted launches plus D's captured launches times
    their replays."""
    import tempfile

    t0 = time.perf_counter()
    zero_launches()
    out: dict = {"card": card_line()}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_device_", dir=ROOT) as tmp:
        print(f"T: make_train_step (d {cfg.d_model}, {cfg.n_layers} layers, {cfg.dtype})")
        out["T"], params = device_t(torch, cfg, tmp, dev)
        print("K: CheckpointManager and ServingEngine.from_checkpoint (paged bf16)")
        out["K"] = device_k(torch, cfg, params, tmp, dev)
    print("D: the device datasource (ctx.tpu.execute on an App, executables as CUDA graphs)")
    out["D"] = device_d(torch, cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    print(f"X: MoE (d {moe_cfg.d_model}, {moe_cfg.n_experts} experts, {moe_cfg.n_layers} layers)")
    out["X"] = device_x(torch, moe_cfg, dev)
    launches = {n: 0 for n in counters()}
    for engine_counts in out["K"]["launches"].values():
        add_launches(launches, engine_counts)
    add_launches(launches, out["D"]["launches_replayed"])
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"  device: {out['seconds']:.1f}s ({out['card']}); launches {launches}")
    return out


SQL_FILLER = 10_000  # S1: filler rows of the prompt table (the wire dialects take the first 1,000)
SQL_WIRE_FILLER = 1_000  # S4: filler rows a wire dialect holds
SQL_CRUD_N = 200  # S2: single requests of each verb, one at a time
SQL_NEW = 32  # S3: greedy tokens a generation job
SQL_HOLD_WRITERS = 8  # S2: POSTs sent while a handler holds a transaction open
SQL_HOLD_S = 0.5  # S2: how long the writers must stay waiting on the held transaction


# the sql phase's CRUD entities (made with real types: this module's
# annotations are strings, which a dataclass resolves through sys.modules,
# and a test loads this file without registering it there): a prompt's
# token ids as JSON text, and a generation job's record
Prompt = dataclasses.make_dataclass("Prompt", [("id", int, 0), ("tokens", str, ""),
                                               ("max_new", int, 0)])
Generation = dataclasses.make_dataclass("Generation", [("id", int, 0), ("prompt_id", int, 0),
                                                       ("tokens", str, ""), ("finish", str, "")])


SQL_TABLES = (
    "CREATE TABLE prompt (id INTEGER PRIMARY KEY, tokens TEXT NOT NULL, max_new INTEGER)",
    "CREATE TABLE generation (id INTEGER PRIMARY KEY, prompt_id INTEGER NOT NULL, "
    "tokens TEXT NOT NULL, finish TEXT)",
)


def sql_rows(torch, vocab: int) -> list[tuple[int, str, int]]:
    """The prompt table's rows: the main path's ten prompts (ids 1-10) and
    ``SQL_FILLER`` short filler prompts (ids 11…), all from the seed."""
    rng = torch.Generator().manual_seed(SEED + 23)
    rows = [(i + 1, json.dumps(torch.randint(3, vocab, (n,), generator=rng).tolist()), SQL_NEW)
            for i, n in enumerate(MAIN_LENS)]
    filler = torch.randint(3, vocab, (SQL_FILLER, 8), generator=rng).tolist()
    rows += [(len(MAIN_LENS) + 1 + i, json.dumps(t), 8) for i, t in enumerate(filler)]
    return rows


def sql_app(name: str, **values):
    """An ``App`` on free 127.0.0.1 ports with the given DB_* configs."""
    return models_app(name, SHUTDOWN_GRACE_PERIOD="30", **values)


def timed_up(times: dict, version: int, up):
    """``up`` wrapped to record its own ms in ``times``."""
    def run(ds):
        t = time.perf_counter()
        try:
            up(ds)
        finally:
            times[version] = (time.perf_counter() - t) * 1e3
    return run


def sql_base_migrations(rows: list, times: dict) -> dict:
    """S1's versions 1 (the tables) and 2 (the rows, in the migration's
    transaction)."""
    def v1(ds):
        for stmt in SQL_TABLES:
            ds.sql.exec(stmt)

    def v2(ds):
        for row in rows:
            ds.sql.exec("INSERT INTO prompt (id, tokens, max_new) VALUES (?, ?, ?)", *row)

    return {1: timed_up(times, 1, v1), 2: timed_up(times, 2, v2)}


def sql_s1(torch, dev, app, rows: list) -> dict:
    """S1: ``app.migrate`` with versions 1 (tables), 2 (the prompts and the
    filler rows), 3 (a ``ds.tpu`` warm-up: a paged bf16 executable at D's
    shape, one execute held bit-equal to an eager call and within
    ``PAGED_ROW_TOL`` of the plain version) and 4 (raises after an insert:
    a ``MigrationError``, nothing of it left, ``MAX(version)`` 3)."""
    from gofr_tpu_torch.migration import Migrate, MigrationError
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_ref

    times: dict = {}
    out: dict = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    inputs = paged_inputs(torch, gen, DECODE_LENS, device=dev)

    def v3(ds):
        ds.tpu.compile("paged", paged_decode_attention, *inputs)
        got = ds.tpu.execute("paged", *inputs, block=True)
        want = paged_decode_attention(*inputs)
        out["v3"] = {"bit_equal_to_eager": bool(torch.equal(got, want)),
                     "row_rel_err_to_plain": row_rel_err(got, paged_decode_attention_ref(*inputs)),
                     "captured_launches": dict(ds.tpu._exec_meta["paged"]["captured_launches"]),
                     "graph": ds.tpu._exec_meta["paged"]["graph"]}
        if not (out["v3"]["bit_equal_to_eager"]
                and out["v3"]["row_rel_err_to_plain"] <= PAGED_ROW_TOL):
            raise AssertionError(f"S1 version 3: {out['v3']}")
        ds.sql.exec("CREATE TABLE warm (name TEXT)")
        ds.sql.exec("INSERT INTO warm (name) VALUES (?)", "paged")

    def v4(ds):
        ds.sql.exec("INSERT INTO prompt (id, tokens, max_new) VALUES (?, ?, ?)", 99999, "[]", 1)
        ds.sql.exec("CREATE TABLE doomed (v INTEGER)")
        raise RuntimeError("version 4 fails on purpose")

    migrations = {v: Migrate(up=up) for v, up in sql_base_migrations(rows, times).items()}
    migrations[3] = Migrate(up=timed_up(times, 3, v3))
    t = time.perf_counter()
    app.migrate(migrations)
    out["migrate_ms"] = (time.perf_counter() - t) * 1e3
    try:
        app.migrate({**migrations, 4: Migrate(up=timed_up(times, 4, v4))})
        out["v4"] = "applied"
    except MigrationError as exc:
        out["v4"] = str(exc)
    sql = app.container.sql
    out["version_ms"] = times
    out["max_version"] = sql.query_row("SELECT MAX(version) AS v FROM gofr_migration")["v"]
    out["prompt_rows"] = sql.query_row("SELECT COUNT(*) AS n FROM prompt")["n"]
    out["v4_left"] = {"row": sql.query_row("SELECT id FROM prompt WHERE id = ?", 99999),
                      "table": sql.query_row("SELECT name FROM sqlite_master WHERE name = 'doomed'")}
    print(f"  S1 migrations: {out}")
    if not (out["v4"] == "migration 4 failed: version 4 fails on purpose" and out["max_version"] == 3
            and out["prompt_rows"] == len(rows) and out["v4_left"] == {"row": None, "table": None}
            and set(times) == {1, 2, 3, 4}):
        raise AssertionError(f"S1: {out}")
    return out


def ms_stats(ms: list[float]) -> dict:
    return {"n": len(ms), "p50": percentile(ms, 50), "p95": percentile(ms, 95)}


def crud_sequence(base: str, first_id: int, n: int) -> dict:
    """``n`` single requests of each verb, one at a time, on rows
    ``first_id``…: POST, GET by id, PUT, DELETE; the client's ms of each
    (p50/p95) and every status."""
    from gofr_tpu_torch.testutil import fetch

    ms: dict = {v: [] for v in ("POST", "GET", "PUT", "DELETE")}
    bad: list = []
    want = {"POST": 201, "GET": 200, "PUT": 200, "DELETE": 204}
    for verb in ms:
        for i in range(first_id, first_id + n):
            body = json.dumps({"id": i, "tokens": json.dumps([i, i + 1]),
                               "max_new": 1 if verb == "POST" else 2}).encode() \
                if verb in ("POST", "PUT") else None
            path = "/prompt" if verb == "POST" else f"/prompt/{i}"
            t = time.perf_counter()
            status, _, raw = fetch(base + path, verb, body, {"Content-Type": "application/json"}, 60)
            ms[verb].append((time.perf_counter() - t) * 1e3)
            if status != want[verb] or (verb == "GET" and json.loads(raw)["data"]["max_new"] != 1):
                bad.append((verb, i, status, raw[:200]))
    out = {v: ms_stats(x) for v, x in ms.items()}
    if bad:
        raise AssertionError(f"CRUD sequence: {bad[:5]} ({len(bad)} bad)")
    return out


def sql_s2(app, base: str, rows: list, held: dict) -> dict:
    """S2: the CRUD routes over HTTP (the port's client): ``SQL_CRUD_N``
    single requests of each verb, a GET of every row (ms and bytes), 404 and
    400, then Queue C 42: ``SQL_HOLD_WRITERS`` POSTs sent while a handler
    holds a ``ctx.sql.begin()`` open; they wait until it rolls back, then
    land, and its own row does not."""
    from gofr_tpu_torch.testutil import fetch

    out: dict = {"verbs": crud_sequence(base, 20001, SQL_CRUD_N)}
    t = time.perf_counter()
    status, _, raw = fetch(base + "/prompt", timeout=120)
    out["get_all"] = {"status": status, "ms": (time.perf_counter() - t) * 1e3, "bytes": len(raw),
                      "rows": len(json.loads(raw)["data"])}
    status_404 = fetch(base + "/prompt/424242")[0]
    status_400 = fetch(base + "/prompt/abc")[0]
    out["missing_malformed"] = [status_404, status_400]
    print(f"  S2 CRUD: {out}")
    if out["get_all"]["status"] != 200 or out["get_all"]["rows"] != len(rows) \
            or out["missing_malformed"] != [404, 400]:
        raise AssertionError(f"S2: {out}")
    # Queue C 42 through the app: /hold opens a Tx, inserts row 30000 and
    # waits; the writers' POSTs wait on the Tx; the rollback frees them
    holder = threading.Thread(target=lambda: held.__setitem__(
        "reply", fetch(base + "/hold", "POST", b"{}", {"Content-Type": "application/json"}, 120)))
    holder.start()
    if not held["open"].wait(60):
        held["release"].set()
        holder.join(120)
        raise AssertionError("S2: the holding handler never opened its transaction")
    done: dict = {}

    def write(i: int) -> None:
        body = json.dumps({"id": i, "tokens": "[1]", "max_new": 1}).encode()
        status = fetch(base + "/prompt", "POST", body, {"Content-Type": "application/json"}, 120)[0]
        done[i] = (status, time.perf_counter())

    ids = list(range(30001, 30001 + SQL_HOLD_WRITERS))
    writers = [threading.Thread(target=write, args=(i,)) for i in ids]
    for w in writers:
        w.start()
    time.sleep(SQL_HOLD_S)
    early = len(done)
    t_release = time.perf_counter()
    held["release"].set()
    holder.join(120)
    for w in writers:
        w.join(120)
    landed = [fetch(base + f"/prompt/{i}")[0] for i in ids]
    rolled = fetch(base + "/prompt/30000")[0]
    out["queue_c42"] = {"done_before_rollback": early, "statuses": sorted(s for s, _ in done.values()),
                        "waited_ms": sorted((at - t_release) * 1e3 for _, at in done.values()),
                        "landed": landed, "rolled_back_row": rolled,
                        "holder": held["reply"][0] if "reply" in held else None}
    print(f"  S2 Queue C 42: {out['queue_c42']}")
    if early or len(done) != SQL_HOLD_WRITERS or set(s for s, _ in done.values()) != {201} \
            or landed != [200] * SQL_HOLD_WRITERS or rolled != 404 \
            or out["queue_c42"]["holder"] != 201:
        raise AssertionError(f"S2 Queue C 42: {out['queue_c42']}")
    for i in ids:  # back to the migrated rows
        fetch(base + f"/prompt/{i}", "DELETE")
    return out


def sql_s3(torch, engine, app, base: str, gate, jobs: dict) -> dict:
    """S3: ``POST /jobs/{id}`` for the ten main prompts at once behind the
    gate (all admitted in one step), each job's tokens held to
    ``engine.submit`` of the same prompts in the same order on the same
    engine; each ``generation`` row read back through CRUD equal to its
    reply; the ``app_sql_stats`` count equal to the statements issued; sql
    UP on the health route; TTFT through the handler against submit and ms
    of each job's SQL write."""
    from concurrent.futures import ThreadPoolExecutor

    from gofr_tpu_torch.testutil import fetch

    hist = app.container.metrics_manager.get("app_sql_stats")
    labels = {"hostname": app.container.sql.database, "database": "sqlite"}
    n0 = hist.snapshot(labels)[1]
    ids = list(range(1, len(MAIN_LENS) + 1))
    replies: dict = {}
    client_ms: list = []

    def post_job(i: int):
        t = time.perf_counter()
        status, _, raw = fetch(base + f"/jobs/{i}", "POST", b"{}",
                               {"Content-Type": "application/json"}, 600)
        client_ms.append((time.perf_counter() - t) * 1e3)
        return status, json.loads(raw)

    with ThreadPoolExecutor(max_workers=len(ids)) as pool:
        with gate.closed():
            futs = {i: pool.submit(post_job, i) for i in ids}
            wait_until(lambda: engine._sched.pending() >= len(ids), 120, "S3 jobs queued")
        replies = {i: f.result(600) for i, f in futs.items()}
    bad = {i: r for i, r in replies.items() if r[0] != 201}
    if bad:
        raise AssertionError(f"S3 jobs: {bad}")
    prompts = {i: json.loads(app.container.sql.query_row(
        "SELECT tokens FROM prompt WHERE id = ?", i)["tokens"]) for i in ids}
    with gate.closed():  # the same prompts directly, in the order the jobs submitted them
        direct = {i: engine.submit(prompts[i], max_new_tokens=SQL_NEW, temperature=0.0)
                  for i in jobs["order"]}
        wait_until(lambda: engine._sched.pending() >= len(ids), 120, "S3 direct set queued")
    direct = {i: f.result(600) for i, f in direct.items()}
    parted, readback = {}, {}
    for i in ids:
        data = replies[i][1]["data"]
        parted[i] = same_or_close(torch, engine, prompts[i], data["tokens"], direct[i].token_ids,
                                  f"S3 job {i} ({MAIN_LENS[i - 1]} tokens) against submit")
        status, _, raw = fetch(base + f"/generation/{data['generation_id']}")
        row = json.loads(raw)["data"]
        readback[i] = status == 200 and json.loads(row["tokens"]) == data["tokens"] \
            and row["prompt_id"] == i and row["finish"] == "length"
    statements = hist.snapshot(labels)[1] - n0
    health = json.loads(fetch(base + "/.well-known/health")[2])["data"]
    out = {"equal": sum(p["equal"] for p in parted.values()), "of": len(ids),
           "parted": {i: p for i, p in parted.items() if not p["equal"]},
           "order": jobs["order"], "readback_equal": sum(readback.values()),
           "sql_statements": {"observed": statements, "issued": 3 * len(ids)},
           "health_sql": health["details"]["sql"]["status"],
           # both sets queued behind the gate: a job's TTFT includes the
           # other jobs' HTTP arrival, and the first set meets a cold engine
           "ttft_ms_gated_handler": ms_stats([replies[i][1]["data"]["ttft_ms"] for i in ids]),
           "ttft_ms_gated_submit": ms_stats([direct[i].ttft_s * 1e3 for i in ids]),
           "sql_write_ms": ms_stats(jobs["write_ms"]),
           "job_ms_client_gated": ms_stats(client_ms)}
    print(f"  S3 generation jobs: {out}")
    # issued: each job's prompt read, the phase's own read of each prompt
    # (query_row) and each read-back (select); a Tx's statements are not
    # observed, as on the reference
    if out["readback_equal"] != len(ids) or statements != 3 * len(ids) \
            or out["health_sql"] != "UP" or len(jobs["write_ms"]) != len(ids):
        raise AssertionError(f"S3: {out}")
    # TTFT of the 1000-token prompt alone, through the handler and through
    # submit, in turns (engine clock; the job's round trip by the client's)
    long_id = MAIN_LENS.index(1000) + 1
    turns: dict = {"handler": [], "submit": [], "job_ms_client": []}
    for who in ("handler", "submit", "submit", "handler", "handler", "submit"):
        if who == "handler":
            n = len(client_ms)
            status, body = post_job(long_id)
            if status != 201:
                raise AssertionError(f"S3 turn: {status} {body}")
            turns["handler"].append(body["data"]["ttft_ms"])
            turns["job_ms_client"].append(client_ms[n])
        else:
            r = engine.submit(prompts[long_id], max_new_tokens=SQL_NEW,
                              temperature=0.0).result(600)
            turns["submit"].append(r.ttft_s * 1e3)
    out["ttft_ms_turns_1000"] = turns
    print(f"  S3 1000-token prompt alone, in turns: TTFT through the handler "
          f"{[round(x, 2) for x in turns['handler']]} ms, through submit "
          f"{[round(x, 2) for x in turns['submit']]} ms; the job's round trip "
          f"{[round(x, 2) for x in turns['job_ms_client']]} ms")
    return out


def sql_jobs(engine, jobs: dict, lock):
    """``POST /jobs/{id}``: the prompt row through ``ctx.sql``, greedy
    tokens from the engine (a sync handler on the app's executor, never the
    engine thread), the ``generation`` row in one transaction."""
    from gofr_tpu_torch.http.errors import ErrorEntityNotFound

    def job(ctx):
        pid = int(ctx.path_param("id"))
        row = ctx.sql.query_row("SELECT tokens, max_new FROM prompt WHERE id = ?", pid)
        if row is None:
            raise ErrorEntityNotFound("prompt", str(pid))
        with lock:  # the order of submission, for the direct set
            jobs["order"].append(pid)
            fut = engine.submit(json.loads(row["tokens"]), max_new_tokens=row["max_new"],
                                temperature=0.0)
        res = fut.result(600)
        t = time.perf_counter()
        tx = ctx.sql.begin()
        try:
            tx.exec("INSERT INTO generation (prompt_id, tokens, finish) VALUES (?, ?, ?)",
                    pid, json.dumps(res.token_ids), res.finish_reason)
            gid = tx.query_row("SELECT last_insert_rowid() AS id")["id"]
            tx.commit()
        except BaseException:
            tx.rollback()
            raise
        with lock:
            jobs["write_ms"].append((time.perf_counter() - t) * 1e3)
        return {"prompt_id": pid, "generation_id": gid, "tokens": res.token_ids,
                "ttft_ms": res.ttft_s * 1e3}
    return job


def sql_hold(held: dict):
    """``POST /hold``: a transaction held open until the phase releases it,
    then rolled back (Queue C 42)."""
    def hold(ctx):
        tx = ctx.sql.begin()
        try:
            tx.exec("INSERT INTO prompt (id, tokens, max_new) VALUES (?, ?, ?)", 30000, "[0]", 1)
            held["open"].set()
            if not held["release"].wait(60):
                raise RuntimeError("never released")
        finally:
            tx.rollback()
        return {"rolled_back": True}
    return hold


def sql_restart(torch, dev, db_path: str, rows: list) -> dict:
    """S4, the restart: a second ``App`` on the same file with versions 1-3
    and a new 5; only 5 runs, and its fresh ``TPUClient`` compiles and
    launches nothing."""
    from gofr_tpu_torch.datasource.tpu import new_tpu
    from gofr_tpu_torch.migration import Migrate

    app = sql_app("sql-restart", DB_DIALECT="sqlite", DB_NAME=db_path)
    client = new_tpu(app.config, device=dev)
    app.add_tpu(client)
    ran: list = []

    def mark(v):
        return lambda ds: ran.append(v)

    def v5(ds):
        ran.append(5)
        ds.sql.exec("CREATE INDEX generation_prompt ON generation (prompt_id)")

    m0 = launch_counts()
    t = time.perf_counter()
    try:
        app.migrate({1: Migrate(up=mark(1)), 2: Migrate(up=mark(2)), 3: Migrate(up=mark(3)),
                     5: Migrate(up=v5)})
        ms = (time.perf_counter() - t) * 1e3
        sql = app.container.sql
        versions = [r["version"] for r in sql.query("SELECT version FROM gofr_migration ORDER BY "
                                                    "version")]
        out = {"ran": ran, "versions": versions, "migrate_ms": ms,
               "executables": list(client._exec_meta), "launches": since(m0),
               "generation_rows": sql.query_row("SELECT COUNT(*) AS n FROM generation")["n"]}
    finally:
        app.container.close()
    print(f"  S4 restart: {out}")
    if ran != [5] or versions != [1, 2, 3, 5] or out["executables"] \
            or any(out["launches"].values()):
        raise AssertionError(f"S4 restart: {out}")
    return out


def sql_wire(dialect: str, rows: list) -> dict:
    """S4, a wire dialect: S1's versions 1-2 (the prompts and
    ``SQL_WIRE_FILLER`` filler rows) and S2's CRUD sequence on an ``App``
    with ``DB_DIALECT=dialect`` against the port's fake server on
    127.0.0.1; the rows read back, the pool gauges, ms a statement."""
    from gofr_tpu_torch.migration import Migrate
    from gofr_tpu_torch.testutil import fetch, start_app, stop_app
    from gofr_tpu_torch.testutil.mysql_server import MiniMySQLServer
    from gofr_tpu_torch.testutil.postgres_server import MiniPostgresServer

    server = (MiniPostgresServer if dialect == "postgres" else MiniMySQLServer)()
    out: dict = {}
    try:
        app = sql_app(f"sql-{dialect}", DB_DIALECT=dialect, DB_HOST="127.0.0.1",
                      DB_PORT=str(server.port), DB_USER=server.user,
                      DB_PASSWORD=server.password, DB_NAME=server.database)
        times: dict = {}
        app.migrate({v: Migrate(up=up) for v, up in sql_base_migrations(
            rows[:len(MAIN_LENS) + SQL_WIRE_FILLER], times).items()})
        app.add_rest_handlers(Prompt)
        thread = start_app(app, timeout=120)
        base = f"http://127.0.0.1:{app.http_port}"
        try:
            out["version_ms"] = times
            out["verbs"] = crud_sequence(base, 20001, SQL_CRUD_N)
            status, _, raw = fetch(base + "/prompt", timeout=120)
            out["crud_rows"] = json.loads(raw)["data"]
            sql = app.container.sql
            out["raw_rows"] = sql.query("SELECT id, tokens, max_new FROM prompt ORDER BY id")
            ms = []
            for i in range(1, 201):
                t = time.perf_counter()
                sql.query_row("SELECT tokens FROM prompt WHERE id = ?", i)
                ms.append((time.perf_counter() - t) * 1e3)
            out["statement_ms"] = ms_stats(ms)
            m = app.container.metrics_manager
            out["gauges"] = {g: m.get(g).value({"dialect": dialect}) for g in
                             ("app_sql_open_connections", "app_sql_inuse_connections")}
            out["pool"] = sql.pool_stats()
            out["health"] = json.loads(fetch(base + "/.well-known/health")[2])["data"][
                "details"]["sql"]["status"]
        finally:
            stop_app(app, thread)
    finally:
        server.close()
    return out


def run_sql(torch, cfg, params, dev) -> dict:
    """The sql phase: S1 migrations (with a ``ds.tpu`` warm-up), S2 CRUD over
    HTTP with Queue C 42's held transaction, S3 generation jobs recorded in
    SQL on a paged bf16 engine at ``cfg``, S4 a restart on the same file and
    the Postgres and MySQL wire dialects. The counters are reset before it;
    ``launches`` are S3's engine's counted launches plus S1's captured
    launches times their replays."""
    import tempfile

    from gofr_tpu_torch.datasource.tpu import new_tpu
    from gofr_tpu_torch.serving.handlers import register_generation_routes
    from gofr_tpu_torch.testutil import start_app, stop_app

    t0 = time.perf_counter()
    zero_launches()
    out: dict = {"card": card_line()}
    rows = sql_rows(torch, cfg.vocab_size)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_sql_", dir=ROOT) as tmp:
        db_path = os.path.join(tmp, "app.db")
        app = sql_app("sql", DB_DIALECT="sqlite", DB_NAME=db_path)
        client = new_tpu(app.config, device=dev)
        app.add_tpu(client)
        print(f"S1: app.migrate on sqlite ({len(rows)} prompt rows, a ds.tpu paged executable)")
        out["S1"] = sql_s1(torch, dev, app, rows)
        replayed = {k: n * client._exec_meta["paged"]["replays"]
                    for k, n in out["S1"]["v3"]["captured_launches"].items()}
        s1_counted = launch_counts()
        app.add_rest_handlers(Prompt)
        app.add_rest_handlers(Generation)
        held = {"open": threading.Event(), "release": threading.Event()}
        app.post("/hold", sql_hold(held))
        mem: dict = {}
        conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16,
                    multi_step=4, max_new_tokens_default=SQL_NEW, prefill_chunk_tokens=2048)
        engine = build_engine(torch, cfg, params, conf, mem, "S3",
                              metrics=app.container.metrics_manager,
                              tracer=app.container.tracer, logger=app.logger)
        register_generation_routes(app, engine)
        jobs = {"order": [], "write_ms": []}
        app.post("/jobs/{id}", sql_jobs(engine, jobs, threading.Lock()))
        gate = Gate(engine)
        thread = start_app(app, timeout=120)
        base = f"http://127.0.0.1:{app.http_port}"
        try:
            print(f"S2: CRUD over HTTP ({SQL_CRUD_N} of each verb, all rows, Queue C 42's held "
                  f"transaction with {SQL_HOLD_WRITERS} writers)")
            out["S2"] = sql_s2(app, base, rows, held)
            print(f"S3: {len(MAIN_LENS)} generation jobs recorded in SQL (paged bf16, "
                  f"{cfg.n_layers} layers)")
            mark = launch_counts()
            out["S3"] = sql_s3(torch, engine, app, base, gate, jobs)
            engine_launches = since(mark)
        finally:
            stop_app(app, thread)
            engine.stop()
        out["memory"] = mem
        del engine
        torch.cuda.empty_cache()
        print("S4: a restart on the same file, then the postgres and mysql wire dialects")
        out["S4"] = {"restart": sql_restart(torch, dev, db_path, rows)}
    for dialect in ("postgres", "mysql"):
        out["S4"][dialect] = sql_wire(dialect, rows)
    n_wire = len(MAIN_LENS) + SQL_WIRE_FILLER
    want = [{"id": r[0], "tokens": r[1], "max_new": r[2]} for r in rows[:n_wire]]
    compare = {}
    for dialect in ("postgres", "mysql"):
        w = out["S4"][dialect]
        compare[dialect] = {
            "crud_rows_equal": w.pop("crud_rows") == want,
            "raw_rows_equal": w.pop("raw_rows") == (
                want if dialect == "postgres" else
                [{k: str(v) for k, v in r.items()} for r in want]),
        }
        w.update(compare[dialect])
    print(f"  S4 wire dialects: {out['S4']}")
    for dialect in ("postgres", "mysql"):
        w = out["S4"][dialect]
        if not (w["crud_rows_equal"] and w["raw_rows_equal"] and w["health"] == "UP"
                and w["gauges"]["app_sql_open_connections"] >= 1
                and w["gauges"]["app_sql_inuse_connections"] == 0):
            raise AssertionError(f"S4 {dialect}: {w}")
    out["launches_counted_s1"] = s1_counted
    out["launches_replayed_s1"] = replayed
    launches = dict(engine_launches)
    add_launches(launches, replayed)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"  sql: {out['seconds']:.1f}s ({out['card']}); launches {launches}")
    if not (launches.get("flash_attention") and launches.get("paged_decode_attention")) \
            or launches.get("paged_decode_attention_q"):
        raise AssertionError(f"sql launches {launches}")
    return out


# ------------------------------------------------------------- the pubsub phase
PUBSUB_BACKENDS = ("KAFKA", "NATS", "MQTT", "EVENTHUB")
PUBSUB_NEW = 32  # greedy tokens a generation job
PUBSUB_ATTEMPTS = 3  # P3: the generate topic's delivery budget
PUBSUB_RESTART_JOBS = 3  # P4: jobs published while the Kafka app is down
# the NATS fake redelivers a job whose ack has not come within this (the
# JetStream default); a job here takes about a second, and only a nack may
# redeliver it
PUBSUB_NATS_ACK_WAIT_S = 30.0
# Event Hubs partitions: a release rewinds its partition and the fake sends
# again what the client already holds behind it (Queue C 48), so P3's poison
# job and the job behind it go to partitions of their own
PUBSUB_EVENTHUB_PARTITIONS = 4
PUBSUB_TURNS = ("handler", "submit", "submit", "handler", "handler", "submit")


def pubsub_fake(backend: str):
    """The port's in-process fake of ``backend`` on 127.0.0.1, the App's
    configs for it, a user's client of it (the jobs' publisher and the
    results' reader) and the fake's closer."""
    from gofr_tpu_torch.pubsub.eventhub import EventHubClient
    from gofr_tpu_torch.pubsub.kafka import KafkaClient
    from gofr_tpu_torch.pubsub.mqtt import MQTTClient
    from gofr_tpu_torch.pubsub.nats import NatsClient
    from gofr_tpu_torch.testutil import (MiniEventHubServer, MiniKafkaBroker, MiniMQTTBroker,
                                         MiniNatsBroker)

    if backend == "KAFKA":
        fake = MiniKafkaBroker()
        return (fake, {"PUBSUB_BROKER": fake.address, "CONSUMER_ID": "app"},
                KafkaClient(fake.address, consumer_group="user"), fake.close)
    if backend == "NATS":
        fake = MiniNatsBroker(ack_wait=PUBSUB_NATS_ACK_WAIT_S)
        return (fake, {"NATS_SERVER": fake.address, "CONSUMER_ID": "app"},
                NatsClient(fake.address, consumer_group="user"), fake.close)
    if backend == "MQTT":
        fake = MiniMQTTBroker().start()
        return (fake, {"MQTT_HOST": "127.0.0.1", "MQTT_PORT": str(fake.port),
                       "MQTT_CLIENT_ID": "app", "MQTT_QOS": "1"},
                MQTTClient("127.0.0.1", fake.port, client_id="user"), fake.stop)
    fake = MiniEventHubServer(partitions=PUBSUB_EVENTHUB_PARTITIONS).start()
    return (fake, {"EVENTHUB_HOST": "127.0.0.1", "EVENTHUB_PORT": str(fake.port),
                   "EVENTHUB_NAME": "hub", "EVENTHUB_PARTITIONS": str(PUBSUB_EVENTHUB_PARTITIONS)},
            EventHubClient(host="127.0.0.1", port=fake.port, eventhub_name="hub",
                           consumer_group="user", partitions=PUBSUB_EVENTHUB_PARTITIONS),
            fake.close)


def pubsub_app(backend: str, configs: dict, handler):
    """An ``App`` on 127.0.0.1 with ``PUBSUB_BACKEND=backend`` and the
    generation subscriber, started; (app, thread)."""
    from gofr_tpu_torch.testutil import start_app

    app = models_app(f"pubsub-{backend.lower()}", PUBSUB_BACKEND=backend, LOG_LEVEL="FATAL",
                     PUBSUB_RETRY_BACKOFF_SECONDS="0.05", SHUTDOWN_GRACE_PERIOD="30",
                     PUBSUB_GENERATE_MAX_ATTEMPTS=str(PUBSUB_ATTEMPTS), **configs)
    if app.container.health()["details"]["pubsub"]["status"] != "UP":
        raise AssertionError(f"{backend}: the app's broker is not UP at boot")
    app.subscription_manager._rng.seed(SEED)  # the redelivery backoff's jitter
    app.subscribe("generate", handler)
    return app, start_app(app, timeout=120)


def pubsub_handler(engine, record: dict):
    """The generation subscriber: each delivery's handler entry on the
    host's clock, the job through ``engine.submit`` (awaited, the loop keeps
    polling other topics), its result published to ``generate.results``
    and that publish's ms."""
    async def generate_job(ctx):
        entered = time.perf_counter()
        job = json.loads(ctx.request.value)
        record["entries"].setdefault(str(job["job"]), []).append(entered)
        fut = engine.submit(job["prompt"], max_new_tokens=PUBSUB_NEW, temperature=0.0)
        r = await asyncio.wrap_future(fut)
        t = time.perf_counter()
        ctx.get_publisher().publish("generate.results", json.dumps({
            "job": job["job"], "t_publish": job["t_publish"], "t_entry": entered,
            "tokens": r.token_ids, "finish_reason": r.finish_reason,
            "ttft_ms": r.ttft_s * 1e3}).encode())
        record["publish_ms"].append((time.perf_counter() - t) * 1e3)
    return generate_job


def pubsub_publish(user, job, prompt: list[int]) -> None:
    user.publish("generate", json.dumps({"job": job, "prompt": prompt,
                                         "t_publish": time.perf_counter()}).encode())


def pubsub_results(user, n: int, what: str, timeout: float = 300) -> list[dict]:
    """``n`` results read by the user's client, each with the time it was
    read."""
    got, t_end = [], time.monotonic() + timeout
    while len(got) < n:
        if time.monotonic() > t_end:
            raise AssertionError(f"{what}: {len(got)} of {n} results")
        msg = user.subscribe("generate.results")
        if msg is not None:
            got.append({**json.loads(msg.value), "t_result": time.perf_counter()})
            msg.commit()
    return got


def pubsub_timing(results: list[dict]) -> dict:
    return {"round_trip_ms": ms_stats([(g["t_result"] - g["t_publish"]) * 1e3 for g in results]),
            "broker_share_ms": ms_stats([(g["t_entry"] - g["t_publish"]) * 1e3 for g in results])}


def pubsub_backend(torch, engine, backend: str, prompts: list, gold: list) -> dict:
    """P1, P2, P3 and P5 over one backend's fake, then (Kafka) P4."""
    from gofr_tpu_torch import chaos
    from gofr_tpu_torch.testutil import stop_app

    fake, configs, user, close_fake = pubsub_fake(backend)
    record: dict = {"entries": {}, "publish_ms": []}
    handler = pubsub_handler(engine, record)
    out: dict = {}
    user.connect()
    for topic in ("generate.results", "generate.dlq"):
        user.subscribe(topic)  # NATS and MQTT drop what no one subscribed to
    mark = launch_counts()
    app, thread = pubsub_app(backend, configs, handler)
    try:
        consumer = app.subscription_manager._consumers["generate"]
        # P1: the ten prompts at once; the subscriber serves one job at a time
        for k, p in enumerate(prompts):
            pubsub_publish(user, k, p)
        got = sorted(pubsub_results(user, len(prompts), f"P1 {backend}"), key=lambda r: r["job"])
        parted = {n: same_or_close(torch, engine, p, g["tokens"], w.token_ids,
                                   f"P1 {backend} {n}-token job against submit")
                  for n, p, g, w in zip(MAIN_LENS, prompts, got, gold)}
        out["P1"] = {"equal": sum(v["equal"] for v in parted.values()), "of": len(parted),
                     "parted": {n: v for n, v in parted.items() if not v["equal"]},
                     "served_once": sum(len(record["entries"].get(str(k), ())) == 1
                                        for k in range(len(prompts))),
                     **pubsub_timing(got)}
        # P2: one job meets an injected handler fault
        faulted: list = []

        def fault(point: str, n: int):
            faulted.append(time.perf_counter())
            return chaos.ChaosFault(point, n)

        with chaos.active(chaos.ChaosInjector(SEED, {"pubsub.handler": 1.0}, max_faults=1,
                                              fault_factories={"pubsub.handler": fault})) as inj:
            pubsub_publish(user, "fault", prompts[0])
            redone = pubsub_results(user, 1, f"P2 {backend}")[0]
        served = record["entries"].get("fault", [])
        out["P2"] = {"faults": inj.stats()["pubsub.handler"]["faults"], "served": len(served),
                     "redeliveries": consumer.redeliveries, "dlq": consumer.dlq,
                     "equal": redone["tokens"] == gold[0].token_ids,
                     "redelivery_ms": (served[0] - faulted[0]) * 1e3 if served and faulted
                     else None}
        # P3: a poison job (an empty prompt, a 400 at submit), a good one behind it
        pubsub_publish(user, "poison", [])
        pubsub_publish(user, "after", prompts[1])
        behind = pubsub_results(user, 1, f"P3 {backend}")[0]
        wait_until(lambda: consumer.dlq == 1, 60, f"P3 {backend} the poison job's dead letter")
        dead, t_end = None, time.monotonic() + 30
        while dead is None and time.monotonic() < t_end:
            dead = user.subscribe("generate.dlq")
        if dead is not None:
            dead.commit()
        wait_until(lambda: consumer.delivered == len(prompts) + 2, 30,
                   f"P3 {backend} the last commit")
        health = app.container.health()["details"]
        out["P3"] = {"poison_deliveries": len(record["entries"].get("poison", ())),
                     "dead": dead is not None and json.loads(dead.value)["job"],
                     "dead_attempts": dead.metadata.get("gofr_dlq_attempts") if dead else None,
                     "after_served": len(record["entries"].get("after", ())),
                     "behind_equal": behind["job"] == "after"
                     and behind["tokens"] == gold[1].token_ids,
                     "redeliveries": consumer.redeliveries, "dlq": consumer.dlq,
                     "health_pubsub": health["pubsub"]["status"],
                     "health_consumers": health["pubsub_consumers"]["status"]}
        # P5: the 1000-token prompt alone, in turns through the handler and submit
        long_k = MAIN_LENS.index(1000)
        turns: dict = {"handler": [], "submit": []}
        alone: list = []
        for i, who in enumerate(PUBSUB_TURNS):
            if who == "handler":
                pubsub_publish(user, f"turn-{i}", prompts[long_k])
                alone.append(pubsub_results(user, 1, f"P5 {backend}")[0])
                turns["handler"].append(alone[-1]["ttft_ms"])
            else:
                r = engine.submit(prompts[long_k], max_new_tokens=PUBSUB_NEW,
                                  temperature=0.0).result(600)
                turns["submit"].append(r.ttft_s * 1e3)
        out["P5"] = {"ttft_ms_handler": turns["handler"], "ttft_ms_submit": turns["submit"],
                     "equal": sum(a["tokens"] == gold[long_k].token_ids for a in alone),
                     **pubsub_timing(alone)}
    finally:
        stop_app(app, thread)
    if backend == "KAFKA":
        # P4: at-least-once across a restart, from the committed offset
        before = {k: len(v) for k, v in record["entries"].items()}
        for i in range(PUBSUB_RESTART_JOBS):
            pubsub_publish(user, f"restart-{i}", prompts[i])
        app, thread = pubsub_app(backend, configs, handler)
        try:
            got = sorted(pubsub_results(user, PUBSUB_RESTART_JOBS, "P4"), key=lambda r: r["job"])
            wait_until(lambda: fake.committed("app", "generate") == len(fake.log("generate")),
                       30, "P4 the restarted app's commits")
        finally:
            stop_app(app, thread)
        out["P4"] = {"served_once": sum(len(record["entries"].get(f"restart-{i}", ())) == 1
                                        for i in range(PUBSUB_RESTART_JOBS)),
                     "equal": sum(g["tokens"] == gold[i].token_ids for i, g in enumerate(got)),
                     "earlier_again": sum(len(record["entries"][k]) - n
                                          for k, n in before.items()),
                     "committed": fake.committed("app", "generate"),
                     "log": len(fake.log("generate"))}
    user.close()
    close_fake()
    launches = since(mark)
    out["launches"] = launches
    out["result_publish_ms"] = {"p50": percentile(record["publish_ms"], 50),
                                "max": max(record["publish_ms"])}
    return out


def pubsub_check(backend: str, out: dict) -> None:
    """The phase's verdict on one backend."""
    n = len(MAIN_LENS)
    want_attempts = None if backend == "MQTT" else str(PUBSUB_ATTEMPTS)  # no metadata on MQTT
    bad = []
    if out["P1"]["equal"] != n or out["P1"]["served_once"] != n:
        bad.append(f"P1 {out['P1']}")
    if out["P2"] != {**out["P2"], "faults": 1, "served": 1, "redeliveries": 1, "dlq": 0,
                     "equal": True}:
        bad.append(f"P2 {out['P2']}")
    if out["P3"] != {**out["P3"], "poison_deliveries": PUBSUB_ATTEMPTS, "dead": "poison",
                     "dead_attempts": want_attempts, "after_served": 1, "behind_equal": True,
                     "redeliveries": 1 + PUBSUB_ATTEMPTS - 1, "dlq": 1, "health_pubsub": "UP",
                     "health_consumers": "UP"}:
        bad.append(f"P3 {out['P3']}")
    if out["P5"]["equal"] != PUBSUB_TURNS.count("handler"):
        bad.append(f"P5 {out['P5']}")
    if backend == "KAFKA" and out["P4"] != {**out["P4"], "served_once": PUBSUB_RESTART_JOBS,
                                            "equal": PUBSUB_RESTART_JOBS, "earlier_again": 0}:
        bad.append(f"P4 {out['P4']}")
    if not (out["launches"].get("flash_attention") and out["launches"].get("paged_decode_attention")):
        bad.append(f"launches {out['launches']}")
    if bad:
        raise AssertionError(f"pubsub {backend}: " + "; ".join(bad))


def run_pubsub(torch, cfg, params) -> dict:
    """The pubsub phase: one paged bf16 engine at ``cfg`` behind an ``App``
    over each networked broker in turn (P1-P5). The counters are reset
    before it; ``launches`` are the whole phase's."""
    t0 = time.perf_counter()
    zero_launches()
    out: dict = {"card": card_line()}
    rng = torch.Generator().manual_seed(SEED + 29)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist() for n in MAIN_LENS]
    mem: dict = {}
    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                max_new_tokens_default=PUBSUB_NEW, prefill_chunk_tokens=2048)
    engine = build_engine(torch, cfg, params, conf, mem, "pubsub")
    out["memory"] = mem
    engine.start()
    try:
        # the subscriber serves one job at a time: the gold is each prompt alone
        gold = [engine.submit(p, max_new_tokens=PUBSUB_NEW, temperature=0.0).result(600)
                for p in prompts]
        for backend in PUBSUB_BACKENDS:
            t = time.perf_counter()
            got = pubsub_backend(torch, engine, backend, prompts, gold)
            got["seconds"] = time.perf_counter() - t
            out[backend] = got
            print(f"  {backend}: P1 {got['P1']['equal']}/{got['P1']['of']} token-equal, round "
                  f"trip p50 {got['P1']['round_trip_ms']['p50']:.1f} p95 "
                  f"{got['P1']['round_trip_ms']['p95']:.1f} ms (ten queued), alone p50 "
                  f"{got['P5']['round_trip_ms']['p50']:.1f} ms, broker share alone p50 "
                  f"{got['P5']['broker_share_ms']['p50']:.2f} ms; P2 {got['P2']}; P3 {got['P3']}; "
                  f"P5 TTFT handler {[round(x, 2) for x in got['P5']['ttft_ms_handler']]} "
                  f"submit {[round(x, 2) for x in got['P5']['ttft_ms_submit']]} ms; result "
                  f"publish {got['result_publish_ms']}; "
                  + (f"P4 {got['P4']}; " if "P4" in got else "")
                  + f"launches {got['launches']}; {got['seconds']:.1f}s")
            pubsub_check(backend, got)
    finally:
        engine.stop()
    out["launches"] = launch_counts()
    out["seconds"] = time.perf_counter() - t0
    print_launches("pubsub", out["launches"])
    print(f"  pubsub: {out['seconds']:.1f}s ({out['card']})")
    if not (out["launches"].get("flash_attention") and out["launches"].get("paged_decode_attention")) \
            or out["launches"].get("paged_decode_attention_q"):
        raise AssertionError(f"pubsub launches {out['launches']}")
    del engine
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- files phase
FILES_NEW = 32  # F-S2: greedy tokens a job
FILES_TTL_S = 600.0  # F-S2: a cached result's TTL (SET ... PX 600000)
FILES_HIT_REPEATS = 5  # F-S2: all-hit batches a backend, for the handler's round trip
FILES_BLOB = 64 << 20  # F-S2: the blob FTP and SFTP write and read whole
FILES_WEIGHT_BACKENDS = ("local", "s3", "gcs", "ftp")  # F-S1 (SFTP reads 32 KiB a request)
FILES_S1_DEPTH = 1  # F-S1: layers of its 8B-wide checkpoint (2.54 GB: the embedding and head)
FILES_JOB_BACKENDS = ("local", "s3", "gcs", "ftp", "sftp")  # F-S2, in this order
FILES_WRONG_FINGERPRINT = "ab" * 32


def has_cryptography() -> str | None:
    """The ``cryptography`` version, or None where it is not installed (the
    SFTP legs need it)."""
    try:
        import cryptography
    except ImportError:
        return None
    return cryptography.__version__


def series_counts(manager, name: str) -> dict:
    """Observations of a histogram by label set, as ``k=v,...`` strings."""
    hist = manager.get(name)
    with hist._lock:
        return {",".join(f"{k}={v}" for k, v in key): state[2]
                for key, state in sorted(hist._series.items())}


def files_servers(tmp: str, crypto: bool) -> dict:
    from gofr_tpu_torch.testutil import FakeObjectStore, MiniFTPServer, MiniRedisServer

    out = {"object": FakeObjectStore(), "ftp": MiniFTPServer(os.path.join(tmp, "ftp-root")),
           "redis": MiniRedisServer()}
    if crypto:
        from gofr_tpu_torch.testutil import MiniSFTPServer

        out["sftp"] = MiniSFTPServer(os.path.join(tmp, "sftp-root"))
    return out


def sftp_fingerprint(server) -> str:
    import hashlib

    from gofr_tpu_torch.datasource.file.ssh_transport import ed25519_blob

    return hashlib.sha256(ed25519_blob(server.host_key.public_key())).hexdigest()


def files_fs(kind: str, servers: dict, tmp: str, fingerprint: str = ""):
    """A port file system of ``kind`` on its server, unconnected. Local, FTP
    and SFTP sit behind ``ObservedFileSystem`` (``app_file_stats`` by
    operation); the object stores record it themselves (by backend)."""
    from gofr_tpu_torch.datasource.file import (FTPFileSystem, GCSProvider, LocalFileSystem,
                                                ObjectFileSystem, ObservedFileSystem,
                                                S3Provider, SFTPFileSystem)

    fake = servers["object"]
    if kind == "s3":
        return ObjectFileSystem(S3Provider("test-bucket", endpoint=fake.s3_endpoint,
                                           region=fake.region, access_key=fake.access_key,
                                           secret_key=fake.secret_key, timeout=600), name="s3")
    if kind == "gcs":
        return ObjectFileSystem(GCSProvider("test-bucket", endpoint=fake.gcs_endpoint,
                                            timeout=600), name="gcs")
    if kind == "local":
        inner = LocalFileSystem(os.path.join(tmp, "local-root"))
        os.makedirs(inner.getwd(), exist_ok=True)
    elif kind == "ftp":
        inner = FTPFileSystem(host="127.0.0.1", port=servers["ftp"].port, user="gofr",
                              password="secret", connect_timeout=600)
    else:
        inner = SFTPFileSystem(host="127.0.0.1", port=servers["sftp"].port, user="gofr",
                               password="secret", host_key_fingerprint=fingerprint,
                               connect_timeout=600)
    return ObservedFileSystem(inner)


def files_put(fs, src_dir: str, name: str) -> int:
    """Copy every file of ``src_dir`` into ``fs`` under ``name`` (64 MiB
    reads); returns the bytes written."""
    fs.mkdir(name)
    total = 0
    for fname in sorted(os.listdir(src_dir)):
        with open(os.path.join(src_dir, fname), "rb") as src, fs.open(f"{name}/{fname}", "wb") as dst:
            shutil.copyfileobj(src, dst, 64 << 20)
            total += src.tell()
    return total


def files_s1(torch, cfg, dev, tmp: str, servers: dict) -> dict:
    """F-S1: a checkpoint written through each file system and loaded back
    with ``from_hf(path, fs=...)``."""
    from gofr_tpu_torch import EngineConfig, ServingEngine
    from gofr_tpu_torch.metrics import new_metrics_manager
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.models.hf_import import load_llama_from_hf
    from gofr_tpu_torch.testutil.assets import bpe_spec, write_bpe_asset
    from gofr_tpu_torch.testutil.params import perturb_norms_and_biases
    from gofr_tpu_torch.tokenizer import BPETokenizer

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    params = llama.init_params(cfg, gen, device=dev)
    perturb_norms_and_biases(params, gen)
    torch.cuda.synchronize()
    src = os.path.join(tmp, "src")
    t = time.perf_counter()
    nbytes = write_hf_checkpoint(torch, src, *llama_hf(torch, cfg, params))
    write_bpe_asset(src, bpe_spec(MODELS_L_MERGES),
                    {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>"})
    out: dict = {"checkpoint_bytes": nbytes, "source_write_s": time.perf_counter() - t}
    _, direct = load_llama_from_hf(src, device=dev)
    out["plain_load_equal"] = tree_equal(torch, direct, params)
    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                prefill_chunk_tokens=2048)
    rng = torch.Generator().manual_seed(SEED + 31)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist() for n in MAIN_LENS]
    with open(os.path.join(src, "model.safetensors"), "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
    for kind in FILES_WEIGHT_BACKENDS:
        fs = files_fs(kind, servers, tmp)
        m = new_metrics_manager()
        m.new_histogram("app_file_stats", "Duration of file-system operations in milliseconds")
        fs.use_metrics(m)
        fs.connect()
        t = time.perf_counter()
        written = files_put(fs, src, "ckpt")
        write_s = time.perf_counter() - t
        with PeakRss() as rss:
            t = time.perf_counter()
            engine = ServingEngine.from_hf("ckpt", fs=fs, engine_config=EngineConfig(**conf),
                                           device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
        tok = engine.tokenizer
        leg = {"bytes_written": written, "write_s": write_s, "write_gb_s": written / write_s / 1e9,
               "load_s": load_s, "load_gb_s": nbytes / load_s / 1e9,
               "host_rss_mib_before": rss.before, "host_rss_peak_mib": rss.peak,
               "loaded_equal": tree_equal(torch, engine.params, direct) and engine.model_cfg == cfg,
               "tokenizer": isinstance(tok, BPETokenizer) and all(
                   tok.decode(tok.encode(x)) == x.replace("<|begin_of_text|>", "")
                   for x in MODELS_L_TEXTS)}
        if kind in ("s3", "gcs"):  # the header alone, not the weights
            t = time.perf_counter()
            head = fs.read_range("ckpt/model.safetensors", 0, 8)
            header = fs.read_range("ckpt/model.safetensors", 8, int.from_bytes(head, "little"))
            leg["read_range"] = {"ms": (time.perf_counter() - t) * 1e3,
                                 "bytes": len(head) + len(header),
                                 "tensors": len(json.loads(header)),
                                 "header_len": header_len}
            if leg["read_range"]["bytes"] != 8 + header_len:
                raise AssertionError(f"F-S1 {kind} read_range: {leg['read_range']}")
        if kind == "s3":  # this engine serves, beside one built from the same params
            twin = ServingEngine(cfg, params, EngineConfig(**conf), tokenizer=tok, device=dev)
            got = {}
            for name, eng in (("s3", engine), ("direct", twin)):
                mark = launch_counts()
                eng.start()
                try:
                    futs = [eng.submit(p, max_new_tokens=FILES_NEW, temperature=0.0)
                            for p in prompts]
                    got[name] = [f.result(600).token_ids for f in futs]
                finally:
                    eng.stop()
                if name == "s3":
                    leg["launches"] = since(mark)
            leg["tokens_equal"] = sum(a == b for a, b in zip(got["s3"], got["direct"]))
            del twin
        fs.remove_all("ckpt")
        leg["app_file_stats"] = series_counts(m, "app_file_stats")
        fs.close()
        del engine
        torch.cuda.empty_cache()
        out[kind] = leg
        print(f"  F-S1 {kind}: {written / 1e9:.3f} GB written in {write_s:.2f} s "
              f"({leg['write_gb_s']:.2f} GB/s); from_hf in {load_s:.2f} s "
              f"({leg['load_gb_s']:.2f} GB/s), host RSS {rss.before:.0f} MiB before, "
              f"{rss.peak:.0f} MiB at its peak; bit-identical {leg['loaded_equal']}; tokenizer "
              f"{leg['tokenizer']}" + (f"; read_range {leg['read_range']}" if "read_range" in leg
                                       else "")
              + (f"; {leg['tokens_equal']}/{len(prompts)} requests token-equal to the direct "
                 f"engine" if "tokens_equal" in leg else "") + f"; {leg['app_file_stats']}")
        if not (leg["loaded_equal"] and leg["tokenizer"]
                and leg.get("tokens_equal", len(prompts)) == len(prompts)):
            raise AssertionError(f"F-S1 {kind}: {leg}")
    if not out["plain_load_equal"]:
        raise AssertionError("F-S1: the plain-path load differs from the written params")
    out["launches"] = out["s3"]["launches"]
    del params, direct
    torch.cuda.empty_cache()
    return out


def files_key(prompt: list[int]) -> str:
    import hashlib

    return "jobs:" + hashlib.sha256(json.dumps(prompt).encode()).hexdigest()


def files_handler(engine):
    """``POST /batch/{name}`` (the handler of ``examples_torch/using-file-jobs``
    with its steps timed): ``{name}/jobs.jsonl`` through ``JSONRowReader`` on
    ``ctx.file``, each prompt from ``ctx.redis`` or, on a miss, the engine
    (its first token stamped on the host's clock) and then cached with a
    TTL, ``{name}/results.jsonl`` written back. A sync handler: it runs on
    the app's executor."""
    from gofr_tpu_torch.datasource.file import JSONRowReader

    def batch(ctx):
        name = ctx.path_param("name")
        t0 = time.perf_counter()
        with ctx.file.open(f"{name}/jobs.jsonl") as f:
            prompts = [row["prompt"] for row in JSONRowReader(f)]
        t1 = time.perf_counter()
        keys = [files_key(p) for p in prompts]
        tokens, pending, stamps = {}, {}, {}
        for prompt, key in zip(prompts, keys):
            cached = ctx.redis.get(key)
            if cached is not None:
                tokens[key] = json.loads(cached)
            elif key not in pending:
                stamps[key] = [time.perf_counter()]
                pending[key] = engine.submit(prompt, max_new_tokens=FILES_NEW, temperature=0.0,
                                             stream_cb=first_token_timer(stamps[key]))
        t2 = time.perf_counter()
        for key, fut in pending.items():
            tokens[key] = fut.result(timeout=600).token_ids
            ctx.redis.set(key, json.dumps(tokens[key]), ttl_seconds=FILES_TTL_S)
        t3 = time.perf_counter()
        body = "".join(json.dumps({"prompt": p, "tokens": tokens[k]}) + "\n"
                       for p, k in zip(prompts, keys))
        with ctx.file.create(f"{name}/results.jsonl") as f:
            f.write(body.encode())
        t4 = time.perf_counter()
        return {"jobs": len(prompts), "misses": len(pending), "read_ms": (t1 - t0) * 1e3,
                "lookup_ms": (t2 - t1) * 1e3, "write_ms": (t4 - t3) * 1e3,
                "first_token_at": [s[1] for s in stamps.values() if len(s) > 1]}
    return batch


def files_read(fs, name: str) -> list[dict]:
    with fs.open(name, "rb") as f:
        return [json.loads(line) for line in f.read().decode().splitlines()]


def files_blob(kind: str, servers: dict, tmp: str, fingerprint: str) -> dict:
    """One ``FILES_BLOB`` blob written and read whole; MB/s each way."""
    fs = files_fs(kind, servers, tmp, fingerprint)
    fs.connect()
    blob = os.urandom(FILES_BLOB)
    try:
        t = time.perf_counter()
        with fs.create("blob.bin") as f:
            f.write(blob)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        with fs.open("blob.bin", "rb") as f:
            back = f.read()
        read_s = time.perf_counter() - t
        fs.remove("blob.bin")
    finally:
        fs.close()
    if back != blob:
        raise AssertionError(f"F-S2 {kind}: the 64 MiB blob came back different")
    return {"write_mb_s": FILES_BLOB / write_s / 1e6, "read_mb_s": FILES_BLOB / read_s / 1e6,
            "write_s": write_s, "read_s": read_s}


def files_s2(torch, cfg, params, tmp: str, servers: dict, crypto: bool) -> dict:
    """F-S2: one App, Redis on the RESP2 server, each file system in turn."""
    from gofr_tpu_torch.datasource.file.ssh_transport import SSHError
    from gofr_tpu_torch.datasource.redis import RedisClient
    from gofr_tpu_torch.migration import Migrate
    from gofr_tpu_torch.testutil import start_app, stop_app

    out: dict = {}
    backends = FILES_JOB_BACKENDS if crypto else FILES_JOB_BACKENDS[:-1]
    fingerprint = sftp_fingerprint(servers["sftp"]) if crypto else ""
    mem: dict = {}
    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                max_new_tokens_default=FILES_NEW, prefill_chunk_tokens=2048)
    engine = build_engine(torch, cfg, params, conf, mem, "files")
    out["memory"] = mem
    admissions = hook_admissions(engine)
    rng = torch.Generator().manual_seed(SEED + 37)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist() for n in MAIN_LENS]
    extra = {kind: torch.randint(3, cfg.vocab_size, (64 + 16 * i,), generator=rng).tolist()
             for i, kind in enumerate(backends[1:])}
    engine.start()
    redis_server = servers["redis"]
    app = models_app("files", LOG_LEVEL="FATAL", SHUTDOWN_GRACE_PERIOD="30")
    client = RedisClient(host="127.0.0.1", port=redis_server.port)
    app.add_datasource("redis", client)
    # the migrations' bookkeeping goes to the gofr_migrations hash
    app.migrate({1: Migrate(up=lambda ds: ds.redis.set("files:schema", "1")),
                 2: Migrate(up=lambda ds: ds.redis.hset("files:meta", "backends",
                                                        ",".join(backends)))})
    tracked = client.hgetall("gofr_migrations")
    out["migrations"] = {v: json.loads(r)["method"] for v, r in sorted(tracked.items())}
    if out["migrations"] != {"1": "UP", "2": "UP"}:
        raise AssertionError(f"F-S2 migrations: {tracked}")
    app.post("/batch/{name}", files_handler(engine))
    thread = start_app(app, timeout=120)
    base = f"http://127.0.0.1:{app.http_port}"
    try:
        gold, ttft_submit = {}, {}
        for p in prompts + list(extra.values()):  # each prompt alone through submit
            stamp = [time.perf_counter()]
            r = engine.submit(p, max_new_tokens=FILES_NEW, temperature=0.0,
                              stream_cb=first_token_timer(stamp)).result(600)
            gold[files_key(p)] = r.token_ids
            ttft_submit[files_key(p)] = (stamp[1] - stamp[0]) * 1e3
        previous = None
        for i, kind in enumerate(backends):
            fs = files_fs(kind, servers, tmp, fingerprint)
            app.add_datasource("file", fs)  # connects it; ctx.file from here on
            if previous is not None:
                previous.close()
            previous = fs
            jobs = prompts + ([extra[kind]] if i else [])
            t = time.perf_counter()
            fs.mkdir(kind)
            with fs.create(f"{kind}/jobs.jsonl") as f:
                f.write("".join(json.dumps({"prompt": p}) + "\n" for p in jobs).encode())
            put_ms = (time.perf_counter() - t) * 1e3
            health = get_json(base + "/.well-known/health")[1]["data"]["details"]
            mark, n_adm = launch_counts(), len(admissions)
            t_post = time.perf_counter()
            status, _, body = post(base, f"/batch/{kind}")
            rt_ms = (time.perf_counter() - t_post) * 1e3
            if status != 201:
                raise AssertionError(f"F-S2 {kind}: {status} {body}")
            reply = body["data"]
            leg = {"jobs_put_ms": put_ms, "miss_round_trip_ms": rt_ms,
                   "misses": reply["misses"], "jobs": reply["jobs"],
                   "jobs_read_ms": reply["read_ms"], "redis_lookup_ms": reply["lookup_ms"],
                   "results_write_ms": reply["write_ms"], "admissions": len(admissions) - n_adm,
                   "launches": since(mark), "health": {k: health[k]["status"]
                                                       for k in ("redis", "file")}}
            if i:
                key = files_key(extra[kind])
                leg["ttft_ms_handler"] = (reply["first_token_at"][0] - t_post) * 1e3
                leg["ttft_ms_submit"] = ttft_submit[key]
            results = files_read(fs, f"{kind}/results.jsonl")
            leg["results"] = len(results)
            parted = []
            for row in results:
                verdict = same_or_close(torch, engine, row["prompt"], row["tokens"],
                                        gold[files_key(row["prompt"])], f"F-S2 {kind}")
                if not verdict["equal"]:
                    parted.append(verdict)
            leg["parted"] = parted
            # all-hit batches: no admission, no flash launch
            mark, n_adm, rts = launch_counts(), len(admissions), []
            for _ in range(FILES_HIT_REPEATS):
                t = time.perf_counter()
                status, _, body = post(base, f"/batch/{kind}")
                rts.append((time.perf_counter() - t) * 1e3)
                if status != 201 or body["data"]["misses"]:
                    raise AssertionError(f"F-S2 {kind} all-hit batch: {status} {body}")
            leg["hit_round_trip_ms"] = ms_stats(rts)
            leg["hit_admissions"] = len(admissions) - n_adm
            leg["hit_launches"] = since(mark)
            out[kind] = leg
            want_misses = len(prompts) if i == 0 else 1
            print(f"  F-S2 {kind}: {leg['jobs']} jobs, {leg['misses']} misses "
                  f"({leg['admissions']} admissions, launches {leg['launches']}); jobs read "
                  f"{leg['jobs_read_ms']:.2f} ms, results write {leg['results_write_ms']:.2f} ms, "
                  f"Redis lookups {leg['redis_lookup_ms']:.2f} ms; all-hit round trip p50 "
                  f"{leg['hit_round_trip_ms']['p50']:.2f} ms ({leg['hit_admissions']} admissions, "
                  f"launches {leg['hit_launches']})"
                  + (f"; miss TTFT through the handler {leg['ttft_ms_handler']:.2f} ms, submit "
                     f"{leg['ttft_ms_submit']:.2f} ms" if i else "")
                  + f"; health {leg['health']}; {len(parted)} results parted within GAP_TOL")
            if not (leg["misses"] == leg["admissions"] == want_misses
                    and leg["jobs"] == leg["results"] == len(jobs)
                    and leg["hit_admissions"] == 0 and not leg["hit_launches"]["flash_attention"]
                    and leg["health"] == {"redis": "UP", "file": "UP"}):
                raise AssertionError(f"F-S2 {kind}: {leg}")
        # the Redis series against the commands the server saw
        counts = series_counts(app.container.metrics_manager, "app_redis_stats")
        by_type: dict = {}
        for labels, n in counts.items():
            kind_of = dict(x.split("=", 1) for x in labels.split(","))["type"].upper()
            by_type[kind_of] = by_type.get(kind_of, 0) + n
        seen = dict(redis_server.commands)
        out["app_redis_stats"], out["redis_commands"] = by_type, seen
        if by_type != seen:
            raise AssertionError(f"F-S2: app_redis_stats {by_type}, server commands {seen}")
        pttl = [client.command("PTTL", files_key(p)) for p in prompts + list(extra.values())]
        out["pttl_ms"] = {"min": min(pttl), "max": max(pttl), "n": len(pttl)}
        if not all(0 < x <= int(FILES_TTL_S * 1000) for x in pttl):
            raise AssertionError(f"F-S2 PTTL: {pttl}")
        for kind in ("ftp",) + (("sftp",) if crypto else ()):
            out[f"{kind}_blob"] = files_blob(kind, servers, tmp, fingerprint)
            print(f"  F-S2 {kind} 64 MiB blob: write {out[f'{kind}_blob']['write_mb_s']:.1f} MB/s, "
                  f"read {out[f'{kind}_blob']['read_mb_s']:.1f} MB/s")
        if crypto:  # a wrong pinned host key is refused at connect
            wrong = files_fs("sftp", servers, tmp, FILES_WRONG_FINGERPRINT)
            try:
                wrong.connect()
                out["wrong_fingerprint_refused"] = False
            except SSHError as exc:
                out["wrong_fingerprint_refused"] = "fingerprint mismatch" in str(exc)
            if not out["wrong_fingerprint_refused"]:
                raise AssertionError("F-S2: a wrong pinned SFTP host key was accepted")
        # Redis down: health DOWN, the handler a 5xx, nothing admitted
        redis_server.close()
        n_adm = len(admissions)
        health = get_json(base + "/.well-known/health")[1]["data"]["details"]
        status, _, body = post(base, f"/batch/{backends[0]}")
        out["redis_down"] = {"health": health["redis"]["status"], "status": status,
                             "admissions": len(admissions) - n_adm}
        print(f"  F-S2 Redis stopped: health {out['redis_down']['health']}, the handler "
              f"{status}, {out['redis_down']['admissions']} admissions; migrations "
              f"{out['migrations']}; app_redis_stats {by_type}; PTTL {out['pttl_ms']} ms")
        if not (out["redis_down"]["health"] == "DOWN" and status >= 500
                and out["redis_down"]["admissions"] == 0):
            raise AssertionError(f"F-S2 Redis down: {out['redis_down']}")
    finally:
        stop_app(app, thread)
        engine.stop()
    del engine
    torch.cuda.empty_cache()
    return out


def run_files(torch, cfg, params, weights_cfg, dev=None) -> dict:
    """The files phase: F-S1 at ``weights_cfg`` (Llama-3-8B widths, 1 layer,
    on ``dev``, the card by default), then F-S2 over ``cfg``/``params``. The
    counters are reset before it; ``launches`` are the whole phase's."""
    import tempfile

    dev = dev if dev is not None else torch.device("cuda")

    t0 = time.perf_counter()
    zero_launches()
    crypto = has_cryptography()
    out: dict = {"card": card_line(), "cryptography": crypto}
    if crypto is None:
        print("  files: the cryptography package is not installed here: the SFTP legs "
              "(F-S2's SFTP backend and its 64 MiB blob) are not built")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_files_", dir=ROOT) as tmp:
        servers = files_servers(tmp, crypto is not None)
        try:
            t = time.perf_counter()
            out["F-S1"] = files_s1(torch, weights_cfg, dev, tmp, servers)
            out["F-S1"]["seconds"] = time.perf_counter() - t
            t = time.perf_counter()
            out["F-S2"] = files_s2(torch, cfg, params, tmp, servers, crypto is not None)
            out["F-S2"]["seconds"] = time.perf_counter() - t
        finally:
            for server in servers.values():
                server.close()
    out["launches"] = launch_counts()
    out["seconds"] = time.perf_counter() - t0
    print_launches("files", out["launches"])
    print(f"  files: {out['seconds']:.1f}s (F-S1 {out['F-S1']['seconds']:.1f}s, F-S2 "
          f"{out['F-S2']['seconds']:.1f}s; {out['card']})")
    if not (out["launches"].get("flash_attention") and out["launches"].get("paged_decode_attention")) \
            or out["launches"].get("paged_decode_attention_q"):
        raise AssertionError(f"files launches {out['launches']}")
    return out


# ------------------------------------------------------------- the stores phase
STORES_NEW = 32  # greedy tokens a generation job
STORES_SEARCHED = 3  # ST1: tokens of the replies searched through GET /search
STORES_TURNS = ("handler", "submit", "submit", "handler", "handler", "submit")  # ST1, 1000 tokens
STORES_SPANS = ("widecolumn.claim", "kv.set", "engine.generate", "document.insert",
                "widecolumn.batch", "search.add", "search.query")  # the handler's own spans
STORES_FAMILIES = ("kv_store", "document", "widecolumn", "search", "timeseries", "tpu")


def stores_example():
    """``examples_torch/using-datastores/main.py``: the handlers, the Solr
    adapter and the migrations the phase serves."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "using_datastores", ROOT / "examples_torch" / "using-datastores" / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stores_backends(example, kind: str, fakes: dict, tmp: str) -> dict:
    """The four stores of ``kind``: the wire clients on the port's fakes, or
    the embedded engines the factories pick with no host configured, a
    ``FileKVStore`` and ``EmbeddedSearch``."""
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.datasource.document import new_document_store
    from gofr_tpu_torch.datasource.document.mongo import MongoClient
    from gofr_tpu_torch.datasource.kv import DynamoDBKVStore, FileKVStore
    from gofr_tpu_torch.datasource.search import EmbeddedSearch
    from gofr_tpu_torch.datasource.search.solr import SolrClient
    from gofr_tpu_torch.datasource.widecolumn import new_widecolumn_store
    from gofr_tpu_torch.datasource.widecolumn.cassandra import CassandraClient

    if kind == "wire":
        dyn = fakes["dynamodb"]
        return {"kv_store": DynamoDBKVStore("kv", endpoint=dyn.endpoint, region=dyn.region,
                                            access_key=dyn.access_key, secret_key=dyn.secret_key),
                "document": MongoClient(host="127.0.0.1", port=fakes["mongo"].port),
                "widecolumn": CassandraClient(host="127.0.0.1", port=fakes["cassandra"].port),
                "search": example.SolrIndex(SolrClient(fakes["solr"].url))}
    empty = MapConfig({}, use_env=False)
    return {"kv_store": FileKVStore(os.path.join(tmp, "kv.json")),
            "document": new_document_store(empty), "widecolumn": new_widecolumn_store(empty),
            "search": EmbeddedSearch()}


def stores_app(example, engine, backends: dict, dev, label: str):
    """An ``App`` on 127.0.0.1 over ``backends``, the port's ``TPUClient`` on
    ``dev`` and an ``EmbeddedTimeSeries`` that a ``* * * * * *`` cron job fills
    through ``TPUTelemetryRecorder``; the example's migrations, then its
    routes over ``engine``. Spans go to an in-memory exporter."""
    from gofr_tpu_torch.datasource.timeseries import EmbeddedTimeSeries, TPUTelemetryRecorder
    from gofr_tpu_torch.datasource.tpu import new_tpu
    from gofr_tpu_torch.migration import Migrate
    from gofr_tpu_torch.testutil import start_app
    from gofr_tpu_torch.tracing import InMemoryExporter, SimpleSpanProcessor

    app = models_app(f"stores-{label}", LOG_LEVEL="FATAL", SHUTDOWN_GRACE_PERIOD="30")
    exporter = InMemoryExporter()
    app.container.tracer.processor = SimpleSpanProcessor(exporter)
    app.add_tpu(new_tpu(app.config, device=dev))
    for name, store in backends.items():
        app.add_datasource(name, store)
    timeseries = EmbeddedTimeSeries()
    app.add_datasource("timeseries", timeseries)
    app.add_cron_job("* * * * * *", "device-memory",
                     TPUTelemetryRecorder(app.container.tpu, timeseries).sample)
    t = time.perf_counter()
    app.migrate(example.migrations(Migrate))
    migrate_ms = (time.perf_counter() - t) * 1e3
    app.post("/jobs/{id}", example.job_handler(engine, max_new_tokens=STORES_NEW))
    app.get("/search", example.search_handler())
    thread = start_app(app, timeout=120)
    return app, thread, exporter, timeseries, migrate_ms


def stores_post(base: str, job_id: str, prompt: list[int], **fields):
    """One ``POST /jobs/{id}`` of ``{"prompt": prompt, **fields}``: (status,
    body, ms by the client's clock)."""
    t = time.perf_counter()
    status, _, body = post(base, f"/jobs/{job_id}", {"prompt": prompt, **fields})
    return status, body, (time.perf_counter() - t) * 1e3


def gated_jobs(engine, gate, ids: list[str], send) -> dict:
    """The jobs ``send(k)`` posts, at once behind the gate, each one
    reaching the engine's queue before the next is sent, so every set
    starts in one step with the same submission order and runs the same
    dispatches."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(ids)) as pool:
        with gate.closed():
            futs = {}
            for k, i in enumerate(ids):
                futs[i] = pool.submit(send, k)
                wait_until(lambda: engine._sched.pending() >= k + 1 or futs[i].done(), 120,
                           f"job {i} queued")
        return {i: f.result(600) for i, f in futs.items()}


def stores_jobs(engine, gate, base: str, ids: list[str], prompts: list) -> dict:
    return gated_jobs(engine, gate, ids, lambda k: stores_post(base, ids[k], prompts[k]))


def stores_records(app, ids: list[str], tokens: list) -> dict:
    """What the stores hold for ``ids``: the documents (``ttft_ms`` aside),
    the usage and claim rows, the KV values, and the ranked ids of a search
    for each of ``tokens``."""
    c = app.container
    docs, wide = c.extra_datasources["document"], c.extra_datasources["widecolumn"]
    search = c.extra_datasources["search"]
    found = [docs.find_one("jobs", {"_id": i}) for i in ids]

    def kv(key: str):
        try:
            return c.kv_store.get(key)
        except KeyError:
            return None

    return {
        "documents": [{k: v for k, v in (d or {}).items() if k != "ttft_ms"} for d in found],
        "ttft_ms": [(d or {}).get("ttft_ms") for d in found],
        "usage": sorted(tuple(r.values()) for r in wide.query(
            [], "SELECT id, prompt_tokens, new_tokens FROM usage")),
        "claims": sorted(tuple(r.values()) for r in wide.query([], "SELECT id, state FROM jobs")),
        "kv": [kv(f"job:{i}") for i in ids],
        "rankings": {t: [h["_id"] for h in search.search(
            "jobs", {"query": {"match": {"_all": f"t{t}"}}}, size=10)["hits"]["hits"]]
            for t in tokens},
        "migrations": sorted(int(d["version"]) for d in docs.find("gofr_migration", {})),
    }


def stores_span_ms(exporter, names=STORES_SPANS) -> dict:
    """p50/p95 ms of each of the handler's spans, by name."""
    by: dict = {}
    for span in exporter.spans:
        if span.name in names and span.end_ns is not None:
            by.setdefault(span.name, []).append((span.end_ns - span.start_ns) / 1e6)
    return {name: ms_stats(v) for name, v in sorted(by.items())}


def stores_stats(manager, fakes: dict) -> dict:
    """Each family's ``app_*_stats`` count beside the operations its fake
    served: every DynamoDB command; Mongo's store commands (not ``hello``,
    ``ping`` or a transaction's end); Cassandra's queries and batches less
    its health probes. Solr's driver records no series."""
    def total(name: str) -> int:
        return sum(series_counts(manager, name).values())

    mongo = fakes["mongo"].commands
    cass = fakes["cassandra"].commands
    return {
        "dynamodb": {"observed": total("app_dynamodb_stats"),
                     "served": sum(fakes["dynamodb"].commands.values())},
        "mongo": {"observed": total("app_mongo_stats"),
                  "served": sum(n for k, n in mongo.items() if k not in (
                      "hello", "ping", "commitTransaction", "abortTransaction", "endSessions"))},
        "cassandra": {"observed": total("app_cassandra_stats"),
                      "served": cass.get("QUERY", 0) - cass.get("PROBE", 0)
                      + cass.get("BATCH", 0)},
        "solr_served": dict(fakes["solr"].commands),
    }


def stores_st1(torch, example, engine, gate, admissions, fakes: dict, prompts: list,
               gold: dict, dev) -> tuple[dict, dict]:
    """ST1 and ST2 on the wire backends; returns (ST1 and ST2, the records
    ST3 is held to)."""
    from gofr_tpu_torch.datasource.search import EmbeddedSearch
    from gofr_tpu_torch.testutil import stop_app

    backends = stores_backends(example, "wire", fakes, "")
    app, thread, exporter, timeseries, migrate_ms = stores_app(example, engine, backends, dev,
                                                               "wire")
    base = f"http://127.0.0.1:{app.http_port}"
    ids = [f"job-{k}" for k in range(len(prompts))]
    out: dict = {"migrate_ms": migrate_ms}
    try:
        t_jobs = time.time()
        replies = stores_jobs(engine, gate, base, ids, prompts)
        t_done = time.time()
        bad = {i: r[:2] for i, r in replies.items() if r[0] != 201}
        if bad:
            raise AssertionError(f"ST1 jobs: {bad}")
        tokens = {i: replies[i][1]["data"]["tokens"] for i in ids}
        parted = {}
        for i, p in zip(ids, prompts):
            verdict = same_or_close(torch, engine, p, tokens[i], gold[i]["tokens"],
                                    f"ST1 {i} ({len(p)} tokens) against submit alone")
            if not verdict["equal"]:
                parted[i] = verdict
        searched = [tokens[ids[k]][0] for k in (0, 4, 7)][:STORES_SEARCHED]
        records = stores_records(app, ids, searched)
        docs_equal = sum(d == {"_id": i, "prompt": p, "tokens": tokens[i]}
                         for d, i, p in zip(records["documents"], ids, prompts))
        # GET /search against an EmbeddedSearch fed the same ten documents on
        # the host, and the fake's BM25 scores against the host's, bit for bit
        host = EmbeddedSearch()
        for i in ids:
            host.index_document("jobs", i, {"id": i, "text": example.job_text(tokens[i])})
        served_rank, scores_equal = {}, 0
        for tok in searched:
            status, body = get_json(f"{base}/search?q=t{tok}")
            served_rank[tok] = body["data"]["ids"] if status == 200 else status
            want = [h["_id"] for h in host.search(
                "jobs", {"query": {"match": {"_all": f"t{tok}"}}})["hits"]["hits"]]
            fake_scores = fakes["solr"]._engine._indices["jobs"].bm25([f"t{tok}"])
            scores_equal += fake_scores == host._indices["jobs"].bm25([f"t{tok}"])
            if served_rank[tok] != want or records["rankings"][tok] != want:
                raise AssertionError(f"ST1 search t{tok}: {served_rank[tok]} against {want}")
        # a duplicate claim admits nothing
        n_adm = len(admissions)
        dup = stores_post(base, ids[0], prompts[0])
        health = get_json(base + "/.well-known/health")[1]["data"]["details"]
        stats = stores_stats(app.container.metrics_manager, fakes)
        out["ST1"] = {
            "equal": len(ids) - len(parted), "of": len(ids), "parted": parted,
            "documents_equal": docs_equal, "usage_new_tokens": sum(r[2] for r in records["usage"]),
            "tokens_generated": sum(len(t) for t in tokens.values()),
            "kv_done": records["kv"].count("done"), "duplicate": [dup[0], len(admissions) - n_adm],
            "search": {str(t): r for t, r in served_rank.items()}, "bm25_equal": scores_equal,
            "stats": stats, "health": {f: health[f]["status"] for f in STORES_FAMILIES},
            "migrations": records["migrations"],
            "job_ms_client": ms_stats([r[2] for r in replies.values()]),
            "ttft_ms_gated_handler": ms_stats(records["ttft_ms"]),
        }
        st1 = out["ST1"]
        if not (st1["documents_equal"] == len(ids) and st1["usage_new_tokens"] == st1[
                "tokens_generated"] and st1["kv_done"] == len(ids) and st1["duplicate"] == [409, 0]
                and st1["bm25_equal"] == len(searched) and st1["migrations"] == [1, 2, 3]
                and all(s["observed"] == s["served"] > 0 for k, s in stats.items()
                        if k != "solr_served")
                and set(st1["health"].values()) == {"UP"}):
            raise AssertionError(f"ST1: {st1}")
        # the 1000-token prompt alone, in turns through the handler and submit
        long_p = prompts[MAIN_LENS.index(1000)]
        turns: dict = {"handler": [], "submit": [], "job_ms_client": []}
        for k, who in enumerate(STORES_TURNS):
            if who == "handler":
                status, body, ms = stores_post(base, f"turn-{k}", long_p)
                if status != 201:
                    raise AssertionError(f"ST1 turn: {status} {body}")
                doc = app.container.extra_datasources["document"].find_one(
                    "jobs", {"_id": f"turn-{k}"})
                turns["handler"].append(doc["ttft_ms"])
                turns["job_ms_client"].append(ms)
            else:
                r = engine.submit(long_p, max_new_tokens=STORES_NEW, temperature=0.0).result(600)
                turns["submit"].append(r.ttft_s * 1e3)
        out["ST1"]["ttft_ms_turns_1000"] = turns
        out["ST1"]["span_ms"] = stores_span_ms(exporter)
        # ST2: the recorder's points over the jobs' window
        out["ST2"] = stores_st2(torch, engine, timeseries, t_jobs, t_done)
        # the document store down: a 5xx after the tokens, the claim and
        # "running" left behind
        fakes["mongo"].close()
        health = get_json(base + "/.well-known/health")[1]["data"]["details"]
        n_adm = len(admissions)
        status, _, _ = stores_post(base, "job-down", prompts[0])
        claim = app.container.extra_datasources["widecolumn"].query(
            [], "SELECT state FROM jobs WHERE id = ?", "job-down")
        try:
            kv_down = app.container.kv_store.get("job:job-down")
        except KeyError:
            kv_down = None
        out["ST1"]["document_down"] = {"health": health["document"]["status"], "status": status,
                                       "admissions": len(admissions) - n_adm, "claim": claim,
                                       "kv": kv_down}
        down = out["ST1"]["document_down"]
        if not (down["health"] == "DOWN" and status >= 500 and down["admissions"] == 1
                and claim == [{"state": "claimed"}] and kv_down == "running"):
            raise AssertionError(f"ST1 document down: {down}")
    finally:
        stop_app(app, thread)
        for store in backends.values():
            store.close()
    return out, {"records": records, "tokens": tokens, "searched": searched}


def stores_st2(torch, engine, timeseries, t0: float, t1: float) -> dict:
    """ST2: one point a second per device over the jobs' window, tagged with
    the card's name; the largest bytes in use at least the weights and the
    KV pool and at most the allocator's peak; the limit the card's memory;
    the max by 1 s buckets as many as the seconds elapsed, within one."""
    from gofr_tpu_torch.models.llama import param_bytes

    rows = timeseries.query("tpu", "hbm_bytes_in_use", start=t0, end=t1)
    limits = timeseries.query("tpu", "hbm_bytes_limit", start=t0, end=t1)
    buckets = timeseries.query("tpu", "hbm_bytes_in_use", start=t0, end=t1, aggregation="max",
                               every=1.0)
    floor = param_bytes(engine.params) + kv_bytes(engine)
    peak = torch.cuda.max_memory_allocated()
    used = max((r["value"] for r in rows), default=0.0)
    out = {"seconds": t1 - t0, "points": len(rows), "buckets": len(buckets),
           "kinds": sorted({r["tags"]["kind"] for r in rows}),
           "devices": sorted({r["tags"]["device"] for r in rows}),
           "max_in_use_bytes": used, "weights_and_kv_bytes": floor, "peak_bytes": peak,
           "limit_bytes": sorted({r["value"] for r in limits}),
           "card_bytes": torch.cuda.mem_get_info()[1]}
    print(f"  ST2 telemetry: {out}")
    if not (out["kinds"] == [torch.cuda.get_device_name(0)] and out["devices"] == ["0"]
            and floor <= used <= peak and out["limit_bytes"] == [float(out["card_bytes"])]
            and abs(out["buckets"] - out["seconds"]) <= 1
            and abs(out["points"] - out["seconds"]) <= 1):
        raise AssertionError(f"ST2: {out}")
    return out


def stores_st3(example, engine, gate, tmp: str, prompts: list, st1: dict, dev) -> dict:
    """ST3: the same App code and jobs over the embedded backends; every
    record equal to ST1's."""
    from gofr_tpu_torch.testutil import stop_app

    backends = stores_backends(example, "embedded", {}, tmp)
    app, thread, exporter, _, migrate_ms = stores_app(example, engine, backends, dev, "embedded")
    base = f"http://127.0.0.1:{app.http_port}"
    ids = [f"job-{k}" for k in range(len(prompts))]
    try:
        replies = stores_jobs(engine, gate, base, ids, prompts)
        bad = {i: r[:2] for i, r in replies.items() if r[0] != 201}
        if bad:
            raise AssertionError(f"ST3 jobs: {bad}")
        records = stores_records(app, ids, st1["searched"])
        span_ms = stores_span_ms(exporter)
    finally:
        stop_app(app, thread)
        for store in backends.values():
            store.close()
    want = st1["records"]
    equal = {k: records[k] == want[k] for k in ("documents", "usage", "claims", "kv", "rankings",
                                                 "migrations")}
    tokens_equal = sum(replies[i][1]["data"]["tokens"] == st1["tokens"][i] for i in ids)
    out = {"equal": equal, "tokens_equal": tokens_equal, "of": len(ids), "migrate_ms": migrate_ms,
           "job_ms_client": ms_stats([r[2] for r in replies.values()]), "span_ms": span_ms}
    print(f"  ST3 embedded backends: {out}")
    if not all(equal.values()) or tokens_equal != len(ids):
        raise AssertionError(f"ST3: {out}")
    return out


def run_stores(torch, cfg, params, dev=None) -> dict:
    """The stores phase: one paged int8 engine at ``cfg`` (the int8 path's
    config) behind an ``App`` whose KV, document, wide-column and search
    datasources are the port's wire clients on its fakes (ST1, with ST2's
    telemetry), then the embedded backends (ST3). The counters are reset
    before it; ``launches`` are the whole phase's."""
    import tempfile

    from gofr_tpu_torch.testutil import (MiniCassandraServer, MiniDynamoDBServer,
                                         MiniMongoServer, MiniSolrServer)

    dev = dev if dev is not None else torch.device("cuda")
    t0 = time.perf_counter()
    zero_launches()
    out: dict = {"card": card_line()}
    example = stores_example()
    rng = torch.Generator().manual_seed(SEED + 41)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist() for n in MAIN_LENS]
    mem: dict = {}
    conf = dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32, multi_step=4,
                max_new_tokens_default=STORES_NEW, prefill_chunk_tokens=256, kv_dtype="int8")
    engine = build_engine(torch, cfg, params, conf, mem, "stores")
    out["memory"] = mem
    admissions = hook_admissions(engine)
    gate = Gate(engine)
    engine.start()
    fakes = {"dynamodb": MiniDynamoDBServer().start(), "mongo": MiniMongoServer().start(),
             "cassandra": MiniCassandraServer().start(), "solr": MiniSolrServer()}
    try:
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_stores_", dir=ROOT) as tmp:
            t = time.perf_counter()
            gold = {}
            for k, p in enumerate(prompts):  # each prompt alone through submit
                r = engine.submit(p, max_new_tokens=STORES_NEW, temperature=0.0).result(600)
                gold[f"job-{k}"] = {"tokens": r.token_ids, "ttft_ms": r.ttft_s * 1e3}
            out["gold_seconds"] = time.perf_counter() - t
            t = time.perf_counter()
            got, st1 = stores_st1(torch, example, engine, gate, admissions, fakes, prompts, gold,
                                  dev)
            out.update(got)
            out["ST1"]["seconds"] = time.perf_counter() - t
            out["ST1"]["ttft_ms_submit_alone"] = ms_stats([g["ttft_ms"] for g in gold.values()])
            t = time.perf_counter()
            out["ST3"] = stores_st3(example, engine, gate, tmp, prompts, st1, dev)
            out["ST3"]["seconds"] = time.perf_counter() - t
    finally:
        engine.stop()
        for fake in fakes.values():
            fake.close()
    out["launches"] = launch_counts()
    out["seconds"] = time.perf_counter() - t0
    st1 = out["ST1"]
    print(f"  ST1 wire backends: {st1['equal']}/{st1['of']} jobs token-equal to submit alone; "
          f"documents {st1['documents_equal']}, usage {st1['usage_new_tokens']} of "
          f"{st1['tokens_generated']} tokens, KV done {st1['kv_done']}, duplicate "
          f"{st1['duplicate']}, BM25 equal {st1['bm25_equal']}, stats {st1['stats']}, health "
          f"{st1['health']}; job round trip p50 {st1['job_ms_client']['p50']:.1f} p95 "
          f"{st1['job_ms_client']['p95']:.1f} ms (ten gated); TTFT of 1000 tokens alone through "
          f"the handler {[round(x, 2) for x in st1['ttft_ms_turns_1000']['handler']]} ms, submit "
          f"{[round(x, 2) for x in st1['ttft_ms_turns_1000']['submit']]} ms; document down "
          f"{st1['document_down']}")
    for name, s in st1["span_ms"].items():
        print(f"  ST1 {name}: p50 {s['p50']:.2f} p95 {s['p95']:.2f} ms (n {s['n']})")
    print_launches("stores", out["launches"])
    print(f"  stores: {out['seconds']:.1f}s (gold {out['gold_seconds']:.1f}s, ST1 "
          f"{st1['seconds']:.1f}s, ST3 {out['ST3']['seconds']:.1f}s; {out['card']})")
    if not (out["launches"].get("flash_attention") and out["launches"].get(
            "paged_decode_attention_q")) or out["launches"].get("paged_decode_attention"):
        raise AssertionError(f"stores launches {out['launches']}")
    del engine
    torch.cuda.empty_cache()
    return out


ANALYTICS_NEW = 32  # greedy tokens a generation job
ANALYTICS_TENANTS = ("acme", "globex", "initech")  # job k's tenant is k mod 3
ANALYTICS_TURNS = ("handler", "submit", "submit", "handler")  # AN1, the 1000-token prompt
ANALYTICS_SPANS = ("engine.generate", "columnar.insert", "columnar.async_insert", "graph.txn")
ANALYTICS_LINT = ("gofr_tpu_torch", "chip_smoke.py", "tools_torch", "examples_torch")


def analytics_example():
    """``examples_torch/using-analytics/main.py``: the handlers the phase
    serves."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "using_analytics", ROOT / "examples_torch" / "using-analytics" / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def analytics_ffi() -> dict:
    """AN3's FFI check, before the phase launches anything: every
    ``extern "C"`` entry of ``csrc/*.cu`` against ``_build.SIGNATURES``."""
    from gofr_tpu_torch.analysis.ffi import check_ffi, parse_c_exports

    t = time.perf_counter()
    findings = check_ffi(str(ROOT))
    entries = sum(len(parse_c_exports(str(p))) for p in sorted(
        (ROOT / "gofr_tpu_torch" / "csrc").glob("*.cu")))
    out = {"entries": entries, "findings": [f.render() for f in findings],
           "ms": (time.perf_counter() - t) * 1e3}
    print(f"  AN3 ffi: {entries} extern \"C\" entries against _build.SIGNATURES, "
          f"{len(findings)} finding(s) in {out['ms']:.1f} ms")
    if findings or not entries:
        raise AssertionError(f"AN3 ffi: {out}")
    return out


def analytics_an1(torch, example, engine, gate, prompts: list, gold: dict) -> dict:
    """AN1: the jobs through an ``App`` whose columnar datasource is the
    port's ClickHouse client on ``MiniClickHouseServer`` and whose graph is
    an ``EmbeddedGraph``; the aggregate, the lineage and the tokens held to
    the engine's own results."""
    from gofr_tpu_torch.datasource.columnar import ClickHouseClient
    from gofr_tpu_torch.datasource.graph import EmbeddedGraph
    from gofr_tpu_torch.testutil import MiniClickHouseServer, start_app, stop_app
    from gofr_tpu_torch.tracing import InMemoryExporter, SimpleSpanProcessor

    fake = MiniClickHouseServer()
    app = models_app("analytics", LOG_LEVEL="FATAL", SHUTDOWN_GRACE_PERIOD="30")
    exporter = InMemoryExporter()
    app.container.tracer.processor = SimpleSpanProcessor(exporter)
    columnar, graph = ClickHouseClient(fake.url), EmbeddedGraph()
    app.add_datasource("columnar", columnar)
    app.add_datasource("graph", graph)
    example.register(app, engine, max_new_tokens=ANALYTICS_NEW)
    thread = start_app(app, timeout=120)
    base = f"http://127.0.0.1:{app.http_port}"
    ids = [f"job-{k}" for k in range(len(prompts))]
    tenants = [ANALYTICS_TENANTS[k % len(ANALYTICS_TENANTS)] for k in range(len(prompts))]
    try:
        replies = gated_jobs(engine, gate, ids,
                             lambda k: stores_post(base, ids[k], prompts[k], tenant=tenants[k]))
        bad = {i: r[:2] for i, r in replies.items() if r[0] != 201}
        if bad:
            raise AssertionError(f"AN1 jobs: {bad}")
        data = {i: replies[i][1]["data"] for i in ids}
        parted = {}
        for i, p in zip(ids, prompts):
            verdict = same_or_close(torch, engine, p, data[i]["tokens"], gold[i]["tokens"],
                                    f"AN1 {i} ({len(p)} tokens) against submit alone")
            if not verdict["equal"]:
                parted[i] = verdict
        # the 1000-token prompt alone, in turns through the handler and submit
        long_p = prompts[MAIN_LENS.index(1000)]
        turns: dict = {"handler": [], "submit": [], "job_ms_client": [], "new_tokens": 0}
        for k, who in enumerate(ANALYTICS_TURNS):
            if who == "handler":
                status, body, ms = stores_post(base, f"turn-{k}", long_p, tenant="turns")
                if status != 201:
                    raise AssertionError(f"AN1 turn: {status} {body}")
                row = columnar.select(dict, "SELECT ttft_ms FROM usage WHERE job = {j:String}",
                                      {"j": f"turn-{k}"})
                turns["handler"].append(row[0]["ttft_ms"])
                turns["job_ms_client"].append(ms)
                turns["new_tokens"] += body["data"]["completion_tokens"]
            else:
                r = engine.submit(long_p, max_new_tokens=ANALYTICS_NEW, temperature=0.0).result(600)
                turns["submit"].append(r.ttft_s * 1e3)
        engine_count: dict = {}
        for i, t in zip(ids, tenants):
            engine_count[t] = engine_count.get(t, 0) + data[i]["completion_tokens"]
        status, usage = get_json(base + "/usage")
        usage = usage["data"] if status == 200 else status
        aggregate = {t: u["new_tokens"] for t, u in usage.items()}
        events = fake.rows("SELECT tenant, count(*) FROM job_events GROUP BY tenant "
                           "ORDER BY tenant")
        lineage = {}
        for t in ANALYTICS_TENANTS:
            status, body = get_json(f"{base}/lineage/{t}")
            lineage[t] = [j["job"] for j in body["data"]["jobs"]] if status == 200 else status
        # the path tenant -> job -> result, per job, in the graph itself
        paths = 0
        for i, t in zip(ids, tenants):
            tenant_uid = graph.query(func={"eq": ["tenant", t]})[0]["uid"]
            result_uid = graph.query(func={"eq": ["result", i]})[0]["uid"]
            path = graph.shortest_path(tenant_uid, result_uid)
            paths += len(path) == 3 and graph.query(func={"uid": path[1]})[0]["job"] == i
        health = get_json(base + "/.well-known/health")[1]["data"]["details"]
        span_ms = stores_span_ms(exporter, ANALYTICS_SPANS)
        stats = sum(series_counts(app.container.metrics_manager, "app_sql_stats").values())
        served = len(fake.rows("SELECT job FROM usage")) + len(fake.rows("SELECT job FROM job_events"))
    finally:
        stop_app(app, thread)
        fake.close()
    out = {"equal": len(ids) - len(parted), "of": len(ids), "parted": parted,
           "aggregate": aggregate, "engine_count": engine_count,
           "jobs_by_tenant": {t: usage[t]["jobs"] for t in usage} if isinstance(usage, dict)
           else usage, "events": [list(e) for e in events],
           "lineage": lineage, "paths": paths, "health": {k: health[k]["status"] for k in (
               "columnar", "graph")}, "app_sql_stats": stats, "rows_written": served,
           "job_ms_client": ms_stats([r[2] for r in replies.values()]),
           "ttft_ms_turns_1000": turns, "span_ms": span_ms,
           "records": {i: {"tenant": t, "tokens": data[i]["tokens"]}
                       for i, t in zip(ids, tenants)}}
    want_lineage = {t: sorted(i for i, u in zip(ids, tenants) if u == t) for t in ANALYTICS_TENANTS}
    if not (aggregate.get("turns") == turns["new_tokens"]
            and {t: n for t, n in aggregate.items() if t != "turns"} == engine_count
            and lineage == want_lineage and paths == len(ids)
            and [e[1] for e in events] == [len(want_lineage[t]) for t in sorted(want_lineage)]
            + [ANALYTICS_TURNS.count("handler")]
            and set(out["health"].values()) == {"UP"}):
        raise AssertionError(f"AN1: { {k: v for k, v in out.items() if k != 'records'} }")
    return out


def analytics_an2(records: dict) -> dict:
    """AN2: the same job records through the vendor facades: Oracle over
    the port's sqlite, Surreal and Couchbase over the embedded document
    store, Arango over a document store and a graph. Each reads back what
    it wrote, and each health check is its backend's."""
    from gofr_tpu_torch.datasource.compat import (ArangoFacade, CouchbaseFacade, OracleFacade,
                                                  SurrealFacade)
    from gofr_tpu_torch.datasource.document import EmbeddedDocumentStore
    from gofr_tpu_torch.datasource.graph import EmbeddedGraph
    from gofr_tpu_torch.datasource.sql.sqlite import SQLite

    want = {i: {"tenant": r["tenant"], "tokens": " ".join(map(str, r["tokens"]))}
            for i, r in records.items()}
    out: dict = {}
    ms: dict = {}

    def timed(name, fn):
        t = time.perf_counter()
        got = fn()
        ms[name] = (time.perf_counter() - t) * 1e3
        return got

    oracle = OracleFacade(SQLite(":memory:"))
    oracle.connect()

    def oracle_run():
        oracle.exec("CREATE TABLE jobs (id TEXT PRIMARY KEY, tenant TEXT, tokens TEXT)")
        tx = oracle.begin()
        for i, r in want.items():
            tx.exec_context("INSERT INTO jobs (id, tenant, tokens) VALUES (?, ?, ?)", i,
                            r["tenant"], r["tokens"])
        tx.commit()
        return {row["id"]: {"tenant": row["tenant"], "tokens": row["tokens"]}
                for row in oracle.select(dict, "SELECT id, tenant, tokens FROM jobs")}
    out["oracle"] = timed("oracle", oracle_run) == want

    surreal = SurrealFacade(EmbeddedDocumentStore())
    surreal.connect()

    def surreal_run():
        surreal.use("gofr", "analytics")
        for i, r in want.items():
            surreal.create("jobs", {"_id": i, **r})
        got = {}
        for t in ANALYTICS_TENANTS:
            for d in surreal.query("SELECT * FROM jobs WHERE tenant = $t", {"t": t}):
                got[d["_id"]] = {"tenant": d["tenant"], "tokens": d["tokens"]}
        return got
    out["surreal"] = timed("surreal", surreal_run) == want

    couch = CouchbaseFacade(EmbeddedDocumentStore(), bucket="jobs")
    couch.connect()

    def couch_run():
        for i, r in want.items():
            couch.insert(i, r)
        by_key = {i: couch.get(i) for i in want}
        by_query = {d["_id"]: {"tenant": d["tenant"], "tokens": d["tokens"]}
                    for d in couch.query("SELECT * FROM `jobs`")}
        return by_key == want and by_query == want
    out["couchbase"] = timed("couchbase", couch_run)

    arango = ArangoFacade(EmbeddedDocumentStore(), EmbeddedGraph())
    arango.connect()

    def arango_run():
        arango.create_db("analytics")
        arango.create_collection("analytics", "jobs", False)
        arango.create_collection("analytics", "lineage", True)
        arango.create_graph("analytics", "lineage", [{"collection": "lineage"}])
        for i, r in want.items():
            arango.create_document("analytics", "jobs", {"_id": f"jobs/{i}", **r})
            arango.create_document("analytics", "lineage", {
                "_from": f"tenants/{r['tenant']}", "_to": f"jobs/{i}"})
        docs = {i: arango.get_document("analytics", "jobs", f"jobs/{i}") for i in want}
        got = {i: {"tenant": d["tenant"], "tokens": d["tokens"]} for i, d in docs.items() if d}
        edges = {t: len(arango.get_edges("analytics", "lineage", "lineage", f"tenants/{t}"))
                 for t in ANALYTICS_TENANTS}
        counts = {t: sum(r["tenant"] == t for r in want.values()) for t in ANALYTICS_TENANTS}
        return got == want and edges == counts and arango.graph.health_check()["details"][
            "nodes"] == len(want)
    out["arango"] = timed("arango", arango_run)

    health = {kind: f.health_check() for kind, f in (
        ("oracle", oracle), ("surrealdb", surreal), ("couchbase", couch), ("arangodb", arango))}
    out["health"] = {k: [h["status"], h["details"].get("facade")] for k, h in health.items()}
    out["ms"] = ms
    print(f"  AN2 facades: read back {out['oracle']=} {out['surreal']=} {out['couchbase']=} "
          f"{out['arango']=}; health {out['health']}; ms {ms}")
    if not (all(out[k] for k in ("oracle", "surreal", "couchbase", "arango"))
            and all(h == ["UP", k] for k, h in out["health"].items())):
        raise AssertionError(f"AN2: {out}")
    return out


def analytics_step_ms(engine, prompt) -> dict:
    """The ms a decode step of a batch of 8 greedy rows, under the shim."""
    res = [f.result(900) for f in [engine.submit(prompt(20), max_new_tokens=65,
                                                 temperature=0.0) for _ in range(8)]]
    return {"decode_ms_per_step_batch8": per_step_ms(res)}


def analytics_an3(mon, t_lint: float) -> dict:
    """AN3's lock-order half: the monitor's cycles (none allowed) and its
    edges, and the runtime graph checked as a subgraph of lockcheck's
    static graph of the port's tree."""
    from gofr_tpu_torch.analysis.lockcheck import build_static_graph, check_subgraph
    from gofr_tpu_torch.analysis.lockorder import format_cycles

    cycles = mon.cycles()
    runtime = mon.export_graph()
    t = time.perf_counter()
    static = build_static_graph([str(ROOT / p) for p in ANALYTICS_LINT])
    static_s = time.perf_counter() - t
    missing = check_subgraph(runtime, static)
    out = {"locks_created": mon.locks_created, "runtime_edges": len(runtime["edges"]),
           "runtime_nodes": len(runtime["nodes"]), "cycles": len(cycles),
           "static_nodes": len(static["nodes"]), "static_edges": len(static["edges"]),
           "missing_from_static": missing, "static_graph_s": static_s,
           "lint_s": t_lint}
    print(f"  AN3 lock order: {out['locks_created']} locks instrumented, "
          f"{out['runtime_edges']} runtime edges over {out['runtime_nodes']} sites, "
          f"{out['cycles']} cycle(s); static graph {out['static_nodes']} locks "
          f"{out['static_edges']} edges; {len(missing)} runtime edge(s) missing from it")
    for m in missing:
        print(f"  AN3 missing: {m}")
    if cycles:
        raise AssertionError(f"AN3: {format_cycles(cycles)}")
    return out


def run_analytics(torch, cfg, params, dev=None) -> dict:
    """The analytics phase: FFI first (AN3), then under the lock-order shim
    one paged bf16 engine at ``cfg`` behind an ``App`` whose columnar and
    graph datasources are ClickHouse on its fake and the embedded graph
    (AN1), the vendor facades over the same records (AN2), and the
    monitor's graph against lockcheck's (AN3). The counters are reset
    before it; ``launches`` are the whole phase's."""
    from gofr_tpu_torch.analysis import lockorder

    dev = dev if dev is not None else torch.device("cuda")
    t0 = time.perf_counter()
    zero_launches()
    out: dict = {"card": card_line()}
    out["ffi"] = analytics_ffi()
    example = analytics_example()
    rng = torch.Generator().manual_seed(SEED + 53)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist() for n in MAIN_LENS]

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    mem: dict = {}
    conf = dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32, multi_step=4,
                max_new_tokens_default=ANALYTICS_NEW, prefill_chunk_tokens=256)
    mon = lockorder.install()
    try:
        engine = build_engine(torch, cfg, params, conf, mem, "analytics")
        out["memory"] = mem
        gate = Gate(engine)
        engine.start()
        try:
            t = time.perf_counter()
            gold = {}
            for k, p in enumerate(prompts):  # each prompt alone through submit
                r = engine.submit(p, max_new_tokens=ANALYTICS_NEW, temperature=0.0).result(600)
                gold[f"job-{k}"] = {"tokens": r.token_ids, "ttft_ms": r.ttft_s * 1e3}
            out["gold_seconds"] = time.perf_counter() - t
            t = time.perf_counter()
            out["AN1"] = analytics_an1(torch, example, engine, gate, prompts, gold)
            out["AN1"]["seconds"] = time.perf_counter() - t
            out["AN1"]["ttft_ms_submit_alone"] = ms_stats([g["ttft_ms"] for g in gold.values()])
            records = out["AN1"].pop("records")
            t = time.perf_counter()
            out["AN2"] = analytics_an2(records)
            out["AN2"]["seconds"] = time.perf_counter() - t
            out["shim"] = analytics_step_ms(engine, prompt)
        finally:
            engine.stop()
    finally:
        lockorder.uninstall()
    out["launches"] = launch_counts()
    t = time.perf_counter()
    from gofr_tpu_torch.analysis.__main__ import main as lint_main

    lint_rc = lint_main(["--all", "--repo-root", str(ROOT)])
    out["lint_rc"], out["lint_seconds"] = lint_rc, time.perf_counter() - t
    print(f"  AN3 python -m gofr_tpu_torch.analysis --all (shardcheck and spec-rank-mismatch "
          f"among its families): rc {lint_rc} in {out['lint_seconds']:.1f}s")
    out["AN3"] = analytics_an3(mon, time.perf_counter() - t)
    from gofr_tpu_torch.analysis.chaoscov import check_chaos_coverage

    chaos_cov = check_chaos_coverage(str(ROOT))
    out["AN3"]["chaos_missing"] = chaos_cov["missing"]
    out["AN3"]["chaos_test_files"] = len(chaos_cov["test_files"])
    print(f"  AN3 chaos coverage: {len(chaos_cov['points'])} points over "
          f"{len(chaos_cov['test_files'])} chaos-tier test files, missing {chaos_cov['missing']}")
    out["seconds"] = time.perf_counter() - t0
    an1 = out["AN1"]
    print(f"  AN1 ClickHouse and graph: {an1['equal']}/{an1['of']} jobs token-equal to submit "
          f"alone; new tokens by tenant {an1['aggregate']} against the engine's "
          f"{an1['engine_count']}; events {an1['events']}; lineage paths {an1['paths']}; "
          f"app_sql_stats {an1['app_sql_stats']}; health {an1['health']}; job round trip p50 "
          f"{an1['job_ms_client']['p50']:.1f} p95 {an1['job_ms_client']['p95']:.1f} ms (ten "
          f"gated); TTFT of 1000 tokens alone through the handler "
          f"{[round(x, 2) for x in an1['ttft_ms_turns_1000']['handler']]} ms, submit "
          f"{[round(x, 2) for x in an1['ttft_ms_turns_1000']['submit']]} ms")
    for name, s in an1["span_ms"].items():
        print(f"  AN1 {name}: p50 {s['p50']:.2f} p95 {s['p95']:.2f} ms (n {s['n']})")
    print(f"  analytics decode under the lock-order shim: "
          f"{out['shim']['decode_ms_per_step_batch8']:.2f} ms a step (batch of 8)")
    print_launches("analytics", out["launches"])
    print(f"  analytics: {out['seconds']:.1f}s (gold {out['gold_seconds']:.1f}s, AN1 "
          f"{an1['seconds']:.1f}s, AN2 {out['AN2']['seconds']:.1f}s, lint rc {lint_rc}; "
          f"{out['card']})")
    if lint_rc != 0:
        raise AssertionError(f"python -m gofr_tpu_torch.analysis --all exited {lint_rc}")
    if chaos_cov["missing"]:
        raise AssertionError(f"--chaos-coverage: points scheduled by no test {chaos_cov['missing']}")
    if not (out["launches"].get("flash_attention") and out["launches"].get(
            "paged_decode_attention")) or out["launches"].get("paged_decode_attention_q"):
        raise AssertionError(f"analytics launches {out['launches']}")
    del engine
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- grpc phase
GRPC_NEW = 32  # G1: new tokens of each of the main path's prompts
GRPC_SAMPLED = 3  # G1: the stream that samples (T 0.8, top-k 50, top-p 0.95), as on the paths
GRPC_BURST = 16  # G2: streams queued behind the gate for the shed check
GRPC_ACK_DEADLINE_S = 2  # G3: the app's subscription's ack deadline
GRPC_BEAT_S = 0.3  # G4: the leader's heartbeat interval
GRPC_BEAT_DEADLINE_S = 1.2  # G4: SUSPECT past one deadline, DEAD past two
GRPC_WORKER_BOOT_S = 300.0  # G4: both workers registered within this
GRPC_WORKER_DEVICE = "cuda"  # G4: the workers' --device


def grpc_client_run(coro_fn, target: str):
    """Run ``coro_fn(client)`` with a fresh port ``InferenceClient`` on a new
    event loop (a channel belongs to the loop that opened it)."""
    from gofr_tpu_torch.grpcx import InferenceClient

    async def run():
        client = InferenceClient(target)
        try:
            return await coro_fn(client)
        finally:
            await client.close()

    return asyncio.run(run())


async def grpc_stream(client, prompt: list[int], **kw) -> dict:
    """One GenerateStream through the port's client: the frames, the
    client's seconds to the first token frame and each token's arrival."""
    t0 = time.perf_counter()
    frames, arrivals = [], []
    async for frame in client.generate_stream(prompt, **kw):
        frames.append(frame)
        if "token" in frame:
            arrivals.append(time.perf_counter() - t0)
    return {"frames": frames, "arrivals": arrivals,
            "tokens": [f["token"] for f in frames if "token" in f],
            "terminal": frames[-1] if frames and frames[-1].get("done") else None}


def grpc_app(torch, cfg, params, conf: dict, mem: dict, label: str, exporter, logbuf):
    """An ``App`` on free 127.0.0.1 ports with ``GRPC_PORT`` and reflection
    on, its tracer exporting to ``exporter``, its INFO log to ``logbuf``,
    over a port engine on the card (the shared weights) on the app's
    metrics, tracer and logger; ``InferenceService`` over the engine
    registered."""
    from gofr_tpu_torch.grpcx import InferenceService
    from gofr_tpu_torch.logging import Level, Logger
    from gofr_tpu_torch.tracing import SimpleSpanProcessor, Tracer
    from gofr_tpu_torch.testutil import get_free_port

    app = models_app(label, GRPC_PORT=str(get_free_port()), GRPC_ENABLE_REFLECTION="true",
                     SHUTDOWN_GRACE_PERIOD="30")
    app.logger = app.container.logger = Logger(Level.INFO, logbuf, logbuf, exit_on_fatal=False)
    app.container.tracer = Tracer(label, SimpleSpanProcessor(exporter))
    engine = build_engine(torch, cfg, params, conf, mem, label,
                          metrics=app.container.metrics_manager, tracer=app.container.tracer,
                          logger=app.logger)
    app.register_grpc_service(InferenceService(engine))
    return app, engine


def grpc_g1(torch, engine, app, target: str, prompt, gate, probe, pool) -> dict:
    """G1: the main path's ten prompts as concurrent GenerateStream calls
    through the port's client, held to ``engine.submit``'s tokens under a
    sync count beside the same set submitted directly; TTFT and the gap a
    token against the engine's clock; one Generate, one Echo, health."""
    out: dict = {}
    ids = [prompt(n) for n in MAIN_LENS]
    kws = [dict(temperature=0.8, top_k=50, top_p=0.95) if i == GRPC_SAMPLED else {}
           for i in range(len(ids))]
    grpc_client_run(lambda c: c.generate(prompt(40), max_tokens=4), target)  # warm-up

    def queued(n):
        wait_until(lambda: engine._sched.pending() >= n, 120, f"{n} requests queued")

    def grpc_set():
        async def streams(c):
            return await asyncio.gather(*[grpc_stream(c, p, max_tokens=GRPC_NEW, **kw)
                                          for p, kw in zip(ids, kws)])

        with gate.closed():
            fut = pool.submit(grpc_client_run, streams, target)
            queued(len(ids))
        return fut.result(600)

    def direct_set():
        with gate.closed():
            futs = [engine.submit(p, max_new_tokens=GRPC_NEW, **({"temperature": 0.0} | kw))
                    for p, kw in zip(ids, kws)]
        return [f.result(600) for f in futs]

    runs = {}
    for name, fn in (("grpc", grpc_set), ("direct", direct_set)):
        d0 = probe.n["dispatches"]
        res, sites = sync_warnings(torch, engine, probe, fn)
        runs[name] = {"results": res, "sites": sites, "dispatches": probe.n["dispatches"] - d0}
    parted = {}
    for i, (n, p, s, r) in enumerate(zip(MAIN_LENS, ids, runs["grpc"]["results"],
                                         runs["direct"]["results"])):
        if s["terminal"] is None or s["terminal"].get("finish_reason") != "length" \
                or len(s["tokens"]) != GRPC_NEW:
            raise AssertionError(f"G1 stream of {n} tokens: {s['frames'][-3:]}")
        if any(not (0 <= t < engine.model_cfg.vocab_size) for t in s["tokens"]):
            raise AssertionError(f"G1 stream of {n} tokens: a token outside the vocabulary")
        if i == GRPC_SAMPLED:
            continue  # a sampled row is held to its length and vocabulary only
        parted[n] = same_or_close(torch, engine, p, s["tokens"], r.token_ids,
                                  f"G1 {n}-token prompt, gRPC stream against submit")
    per = {k: sum(v["sites"].values()) / max(v["dispatches"], 1) for k, v in runs.items()}
    out["streams"] = {"equal": sum(v["equal"] for v in parted.values()), "of": len(parted),
                      "sampled": MAIN_LENS[GRPC_SAMPLED],
                      "parted": {n: v for n, v in parted.items() if not v["equal"]},
                      "ttft_ms_client": [s["arrivals"][0] * 1e3 for s in runs["grpc"]["results"]]}
    out["syncs"] = {k: {"dispatches": v["dispatches"], "warnings": sum(v["sites"].values()),
                        "sites": v["sites"]} for k, v in runs.items()}
    print(f"  G1 10 gRPC streams (one sampled): {out['streams']['equal']}/{len(parted)} greedy "
          f"token-equal to engine.submit; sync warnings a dispatch through gRPC {per['grpc']:.3f}, "
          f"direct {per['direct']:.3f} ({out['syncs']})")
    if per["grpc"] != per["direct"]:
        raise AssertionError(f"G1: serving through gRPC changed the syncs a dispatch: {out['syncs']}")
    # the transport's cost, one 1000-token request at a time, in turns
    ttft, gaps, steps = {"grpc": [], "submit": []}, [], []
    long_p = ids[MAIN_LENS.index(1000)]
    for _ in range(3):
        before = {t.request_id for t in engine.timeline.completed()}
        s = grpc_client_run(lambda c: grpc_stream(c, long_p, max_tokens=16), target)
        wait_until(lambda: {t.request_id for t in engine.timeline.completed()} - before, 30,
                   "G1 the stream's timeline")
        rid = max({t.request_id for t in engine.timeline.completed()} - before)
        tl = engine.timeline.get(rid).to_dict()
        ttft["grpc"].append((s["arrivals"][0] * 1e3, tl["ttft_ms"]))
        gaps.append(gap_ms(s["arrivals"]))
        r = engine.submit(long_p, max_new_tokens=16, temperature=0.0).result(600)
        ttft["submit"].append(r.ttft_s * 1e3)
        steps.append(per_step_ms([r]))
    out["transport_cost"] = {"ttft_ms_grpc_client_engine": ttft["grpc"],
                             "ttft_ms_submit": ttft["submit"], "grpc_gap_ms_a_token": gaps,
                             "submit_ms_a_step": steps}
    print(f"  G1 1000-token prompt, 16 tokens, in turns: TTFT through gRPC (client, engine) "
          f"{[(round(a, 2), round(b, 2)) for a, b in ttft['grpc']]} ms, through submit "
          f"{[round(x, 2) for x in ttft['submit']]} ms; gRPC gap "
          f"{[round(g, 2) for g in gaps]} ms a token against {[round(x, 2) for x in steps]} "
          f"ms a step")

    async def unary(c):
        return (await c.generate(ids[0], max_tokens=8), await c.echo({"ping": 1}),
                await c.health())

    gen, echo, healthy = grpc_client_run(unary, target)
    out["generate"], out["echo"], out["health"] = gen["usage"], echo, healthy
    print(f"  G1 Generate {gen['finish_reason']} {gen['usage']}, Echo {echo}, health SERVING "
          f"{healthy}")
    if gen["usage"]["completion_tokens"] != 8 or echo != {"ping": 1} or healthy is not True:
        raise AssertionError(f"G1 unary calls: {gen}, {echo}, {healthy}")
    return out


def grpc_g2(torch, engine, app, target: str, prompt, gate, pool, exporter) -> dict:
    """G2: the request lifecycle over the wire on G1's engine: a lapsed
    deadline, a cancel mid-stream, a shed, the drain, reflection, the
    tenant and the trace."""
    from gofr_tpu_torch.grpcx import RpcError, StatusCode
    from gofr_tpu_torch.grpcx import h2

    out: dict = {}
    body = lambda p, n: json.dumps({"prompt": p, "max_tokens": n}).encode()  # noqa: E731

    async def unary_call(c, payload: bytes, **kw):
        ch = h2.Channel(target)
        try:
            return json.loads(await ch.unary_unary("/gofr.v1.Inference/Generate")(payload, **kw))
        except RpcError as exc:
            return {"code": exc.code().name, "trailing": dict(exc.trailing_metadata())}
        finally:
            await ch.close()

    # a queued request whose grpc-timeout lapses: no prefill for it
    mark = launch_counts()
    with gate.closed():
        t = time.perf_counter()
        late = grpc_client_run(lambda c: unary_call(c, body(prompt(64), 4), timeout=0.5), target)
        late_ms = (time.perf_counter() - t) * 1e3
        time.sleep(0.2)
    wait_until(lambda: not engine._by_id, 60, "G2 the expired request to leave")
    out["deadline"] = {"code": late.get("code"), "ms": late_ms, "launches": since(mark)}
    print(f"  G2 deadline 0.5 s on a queued request: {late.get('code')} in {late_ms:.1f} ms; "
          f"launches meanwhile {out['deadline']['launches']}")
    if late.get("code") != "DEADLINE_EXCEEDED" or any(out["deadline"]["launches"].values()):
        raise AssertionError(f"G2 deadline: {out['deadline']}")

    # call.cancel() mid-stream releases the row's slot and pages
    async def cancel_after_two(c):
        ch = h2.Channel(target)
        try:
            call = ch.unary_stream("/gofr.v1.Inference/GenerateStream")(body(prompt(200), 512))
            got = 0
            async for _frame in call:
                got += 1
                if got == 2:
                    t = time.perf_counter()
                    call.cancel()
                    break
            code = await call.code()
            return got, code.name if code else None, t
        finally:
            await ch.close()

    got, code, t_cancel = grpc_client_run(cancel_after_two, target)
    pages = engine.paged_cache.stats()
    wait_until(lambda: not engine._by_id and engine._sched.stats()["busy_slots"] == 0
               and engine.paged_cache.stats()["free_blocks"] == engine.paged_cache.stats()[
                   "total_blocks"], 60, "G2 the cancelled stream's slot and pages")
    out["cancel"] = {"frames": got, "code": code,
                     "ms_to_release": (time.perf_counter() - t_cancel) * 1e3,
                     "pages_at_cancel": pages}
    print(f"  G2 cancel after {got} frames: {code}; slot and pages free "
          f"{out['cancel']['ms_to_release']:.1f} ms after the cancel")

    # a shed: streams queued behind the gate, then requests whose deadline the
    # estimated wait passes
    async def burst(c):
        return await asyncio.gather(*[grpc_stream(c, prompt(64), max_tokens=4)
                                      for _ in range(GRPC_BURST)])

    with gate.closed():
        fut = pool.submit(grpc_client_run, burst, target)
        wait_until(lambda: engine._sched.pending() >= GRPC_BURST, 120, "G2 the burst queued")
        shed = [grpc_client_run(lambda c: unary_call(c, body(prompt(64), 4), timeout=0.05), target)
                for _ in range(4)]
    finished = sum(s["terminal"] is not None and s["terminal"].get("finish_reason") == "length"
                   for s in fut.result(600))
    out["shed"] = {"codes": [s.get("code") for s in shed],
                   "retry_delay_s": [s.get("trailing", {}).get("retry-delay-s") for s in shed],
                   "burst_finished": finished}
    print(f"  G2 shed: {out['shed']}")
    if any(s.get("code") != "RESOURCE_EXHAUSTED" or not s["trailing"].get("retry-delay-s")
           for s in shed) or finished != GRPC_BURST:
        raise AssertionError(f"G2 shed: {out['shed']}")

    # the drain: Generate UNAVAILABLE while health answers NOT_SERVING
    app.container.draining = True
    try:
        drained = grpc_client_run(lambda c: unary_call(c, body(prompt(20), 2)), target)
        serving = grpc_client_run(lambda c: c.health(), target)
    finally:
        app.container.draining = False
    out["drain"] = {"generate": drained.get("code"), "health_serving": serving}
    if drained.get("code") != "UNAVAILABLE" or serving is not False:
        raise AssertionError(f"G2 drain: {out['drain']}")

    # reflection lists the services
    from gofr_tpu_torch.grpcx.reflection import _read_binpb
    from gofr_tpu_torch.grpcx.protowire import load_messages

    msgs = load_messages(_read_binpb("reflection.binpb"))
    req_cls = msgs["grpc.reflection.v1alpha.ServerReflectionRequest"]
    resp_cls = msgs["grpc.reflection.v1alpha.ServerReflectionResponse"]

    async def reflect(c):
        ch = h2.Channel(target)
        try:
            call = ch.stream_stream(
                "/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString)
            return [r async for r in call([req_cls(list_services="*")])]
        finally:
            await ch.close()

    names = [s.name for s in grpc_client_run(reflect, target)[0].list_services_response.service]
    out["reflection"] = names
    if "gofr.v1.Inference" not in names or "grpc.health.v1.Health" not in names:
        raise AssertionError(f"G2 reflection: {names}")

    # x-tenant-id reaches the engine's tenant; the server span continues the
    # client's traceparent
    trace, parent = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    n_before = len(exporter.spans)
    tenant = grpc_client_run(lambda c: unary_call(
        c, json.dumps({"prompt": prompt(20), "max_tokens": 2, "tenant": "body"}).encode(),
        metadata=(("x-tenant-id", "gold"), ("traceparent", f"00-{trace}-{parent}-01"))), target)
    tl = engine.timeline.get(tenant["id"]).to_dict()
    spans = [s for s in exporter.spans[n_before:] if s.name == "grpc /gofr.v1.Inference/Generate"]
    out["tenant"] = tl.get("tenant")
    out["trace"] = [(s.trace_id, s.parent_id) for s in spans]
    print(f"  G2 reflection {names}; x-tenant-id -> tenant {out['tenant']}; server span "
          f"{out['trace']}; drain {out['drain']}")
    if out["tenant"] != "gold" or out["trace"] != [(trace, parent)]:
        raise AssertionError(f"G2 tenant {out['tenant']}, trace {out['trace']}")
    return out


def grpc_g3(torch, cfg, params, prompt, mem: dict) -> dict:
    """G3: an ``App`` with ``PUBSUB_BACKEND=GOOGLE`` against the port's
    google.pubsub.v1 fake on 127.0.0.1, over a paged int8 engine: ten jobs
    (the pubsub phase's handler) held to ``submit``, a handler fault
    redelivered, and a job a consumer of the app's group pulled and never
    acknowledged, redelivered to a restarted app after the ack deadline."""
    from gofr_tpu_torch import chaos
    from gofr_tpu_torch.pubsub.google import GooglePubSubClient
    from gofr_tpu_torch.testutil import GooglePubSubServer, start_app, stop_app

    conf = dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32, multi_step=4,
                prefill_chunk_tokens=256, kv_dtype="int8")
    print(f"G3: App + Google Pub/Sub (the port's fake) + paged int8 engine (page=32), "
          f"{cfg.n_layers} layers")
    fake = GooglePubSubServer()
    engine = build_engine(torch, cfg, params, conf, mem, "G3")
    engine.start()
    user = GooglePubSubClient(endpoint=fake.address, project="gofr", consumer_group="user")
    record: dict = {"entries": {}, "publish_ms": []}
    configs = {"PUBSUB_BACKEND": "GOOGLE", "GOOGLE_PUBSUB_ENDPOINT": fake.address,
               "GOOGLE_PROJECT_ID": "gofr", "CONSUMER_ID": "app",
               "GOOGLE_PUBSUB_ACK_DEADLINE_SECONDS": str(GRPC_ACK_DEADLINE_S),
               "PUBSUB_RETRY_BACKOFF_SECONDS": "0.05", "SHUTDOWN_GRACE_PERIOD": "30",
               "PUBSUB_GENERATE_MAX_ATTEMPTS": "3"}
    sub_path = "projects/gofr/subscriptions/app-generate"
    out: dict = {}
    app = thread = None
    try:
        user.connect()
        user.subscribe("generate.results")  # a subscription sees only later messages
        prompts = [prompt(n) for n in MAIN_LENS]
        gold = [engine.submit(p, max_new_tokens=PUBSUB_NEW, temperature=0.0).result(600)
                for p in prompts]
        mark = launch_counts()

        def boot():
            a = models_app("grpc-google", LOG_LEVEL="FATAL", **configs)
            if a.container.health()["details"]["pubsub"]["status"] != "UP":
                raise AssertionError("G3: the app's Google broker is not UP at boot")
            a.subscription_manager._rng.seed(SEED)
            a.subscribe("generate", pubsub_handler(engine, record))
            th = start_app(a, timeout=120)
            wait_until(lambda: sub_path in fake._subs, 60, "G3 the app's subscription")
            return a, th

        app, thread = boot()
        consumer = app.subscription_manager._consumers["generate"]
        for k, p in enumerate(prompts):
            pubsub_publish(user, k, p)
        got = sorted(pubsub_results(user, len(prompts), "G3 jobs"), key=lambda r: r["job"])
        parted = {n: same_or_close(torch, engine, p, g["tokens"], w.token_ids,
                                   f"G3 {n}-token job against submit")
                  for n, p, g, w in zip(MAIN_LENS, prompts, got, gold)}
        out["jobs"] = {"equal": sum(v["equal"] for v in parted.values()), "of": len(parted),
                       "parted": {n: v for n, v in parted.items() if not v["equal"]},
                       "served_once": sum(len(record["entries"].get(str(k), ())) == 1
                                          for k in range(len(prompts))),
                       **pubsub_timing(got)}
        # a handler fault: nacked (ModifyAckDeadline 0), redelivered, served once
        faulted: list = []

        def fault(point: str, n: int):
            faulted.append(time.perf_counter())
            return chaos.ChaosFault(point, n)

        with chaos.active(chaos.ChaosInjector(SEED, {"pubsub.handler": 1.0}, max_faults=1,
                                              fault_factories={"pubsub.handler": fault})) as inj:
            pubsub_publish(user, "fault", prompts[0])
            redone = pubsub_results(user, 1, "G3 the faulted job")[0]
        served = record["entries"].get("fault", [])
        out["fault"] = {"faults": inj.stats()["pubsub.handler"]["faults"], "served": len(served),
                        "redeliveries": consumer.redeliveries, "dlq": consumer.dlq,
                        "equal": redone["tokens"] == gold[0].token_ids,
                        "redelivery_ms": (served[0] - faulted[0]) * 1e3 if served and faulted
                        else None}
        # the app stops; a consumer of its group pulls a job and dies unacked;
        # a new app on the same group gets it once the ack deadline lapses
        stop_app(app, thread)
        app = None
        rogue = GooglePubSubClient(endpoint=fake.address, project="gofr", consumer_group="app",
                                   ack_deadline_seconds=GRPC_ACK_DEADLINE_S)
        rogue.connect()
        pubsub_publish(user, "lapsed", prompts[1])
        taken, t_end = None, time.monotonic() + 30
        while taken is None and time.monotonic() < t_end:
            taken = rogue.subscribe("generate")
        t_taken = time.perf_counter()
        rogue.close()  # never acknowledged
        app, thread = boot()
        lapsed = pubsub_results(user, 1, "G3 the unacknowledged job")[0]
        entries = record["entries"].get("lapsed", [])
        out["ack_deadline"] = {"pulled_by_rogue": taken is not None, "served": len(entries),
                               "ms_to_redelivery": (entries[0] - t_taken) * 1e3 if entries
                               else None, "equal": lapsed["tokens"] == gold[1].token_ids,
                               "ack_deadline_s": GRPC_ACK_DEADLINE_S}
        out["health"] = app.container.health()["details"]["pubsub"]["status"]
        out["launches"] = since(mark)
        out["publish_ms"] = ms_stats(record["publish_ms"])
        j = out["jobs"]
        print(f"  G3 Google Pub/Sub: {j['equal']}/{j['of']} jobs token-equal to submit, "
              f"{j['served_once']} served once; publish-to-result p50 "
              f"{j['round_trip_ms']['p50']:.1f} ms, the broker's share p50 "
              f"{j['broker_share_ms']['p50']:.1f} ms; fault {out['fault']}; ack deadline "
              f"{out['ack_deadline']}; pubsub {out['health']}")
        if j["equal"] + len(j["parted"]) != j["of"] or j["served_once"] != j["of"] \
                or out["fault"]["faults"] != 1 or out["fault"]["served"] != 1 \
                or not out["fault"]["equal"] or not out["ack_deadline"]["pulled_by_rogue"] \
                or out["ack_deadline"]["served"] != 1 or not out["ack_deadline"]["equal"] \
                or out["ack_deadline"]["ms_to_redelivery"] < GRPC_ACK_DEADLINE_S * 1e3 * 0.9 \
                or out["health"] != "UP":
            raise AssertionError(f"G3: {out}")
    finally:
        if app is not None:
            stop_app(app, thread)
        user.close()
        engine.stop()
        fake.close()
    del engine
    torch.cuda.empty_cache()
    return out


def grpc_g4(torch) -> dict:
    """G4: a ``CoordinationService`` leader on this process's ``GRPCServer``
    and two ``gofr_tpu_torch.distributed.worker_main --device cuda``
    processes, each serving a bf16 tiny Llama (head dim 64) over gRPC on the
    card: both register, one is SIGKILLed, the leader marks it SUSPECT then
    DEAD, bumps the epoch with one shard left, and a request to the
    survivor is answered. Each worker's launches as it reported them."""
    import signal

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.distributed import ClusterState, CoordinationService
    from gofr_tpu_torch.grpcx import GRPCServer, InferenceClient
    from gofr_tpu_torch.testutil import get_free_port, new_mock_container

    container, _ = new_mock_container()
    state = ClusterState(heartbeat_interval_s=GRPC_BEAT_S, heartbeat_deadline_s=GRPC_BEAT_DEADLINE_S)
    leader_port, ports = get_free_port(), [get_free_port(), get_free_port()]
    leader = GRPCServer(container, leader_port, MapConfig({"HTTP_HOST": "127.0.0.1"},
                                                          use_env=False))
    leader.register(CoordinationService(state))
    loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=loop.run_forever, daemon=True, name="g4-leader")
    loop_thread.start()
    asyncio.run_coroutine_threadsafe(leader.start(), loop).result(60)
    out: dict = {"card": card_line()}
    procs, lines = [], [[], []]
    try:
        t0 = time.perf_counter()
        for i, port in enumerate(ports):
            p = subprocess.Popen(
                [sys.executable, "-m", "gofr_tpu_torch.distributed.worker_main",
                 "--leader", f"127.0.0.1:{leader_port}", "--port", str(port),
                 "--host-id", f"w{i}", "--device", GRPC_WORKER_DEVICE],
                cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append(p)
            threading.Thread(target=lambda p=p, i=i: lines[i].extend(p.stdout), daemon=True).start()

        def states() -> dict:
            return {m.host_id: m for m in state.members()}

        t_end = time.monotonic() + GRPC_WORKER_BOOT_S
        while not (len(states()) == 2 and all(m.state == "UP" and m.health
                                              for m in states().values())):
            if time.monotonic() > t_end or any(p.poll() is not None for p in procs):
                raise AssertionError(f"G4 workers: {states()} {[l[-5:] for l in lines]}")
            time.sleep(0.05)
        out["register_to_ready_s"] = time.perf_counter() - t0
        epoch = state.epoch
        out["shards"] = sorted((m.host_id, m.shard_index) for m in state.members())

        async def ask(address: str):
            c = InferenceClient(address)
            try:
                return await c.generate("hello cluster", max_tokens=8)
            finally:
                await c.close()

        served = {}
        for _ in range(4):
            m = state.pick()
            served[m.host_id] = asyncio.run(ask(m.address))["usage"]["completion_tokens"]
        t_kill = time.perf_counter()
        procs[0].send_signal(signal.SIGKILL)
        seen: dict = {}
        while "DEAD" not in seen and time.perf_counter() - t_kill < 30:
            state.sweep()
            w0 = states()["w0"].state
            if w0 != "UP" and w0 not in seen:
                seen[w0] = (time.perf_counter() - t_kill) * 1e3
            time.sleep(0.005)
        members = states()
        survivor = state.pick()
        answer = asyncio.run(ask(survivor.address))
        out["failover"] = {"suspect_ms": seen.get("SUSPECT"), "dead_ms": seen.get("DEAD"),
                           "epoch": [epoch, state.epoch], "status": state.status(),
                           "shards": sorted((m.host_id, m.state, m.shard_index)
                                            for m in members.values()),
                           "survivor": survivor.host_id,
                           "survivor_tokens": answer["usage"]["completion_tokens"]}
        out["served_before"] = served
        out["worker_launches"] = {"w0_last_heartbeat": (members["w0"].health or {}).get("launches")}
        procs[1].send_signal(signal.SIGTERM)
        procs[1].wait(60)
        time.sleep(0.2)
        printed = [l for l in lines[1] if l.startswith("WORKER_LAUNCHES ")]
        out["worker_launches"]["w1_printed"] = json.loads(printed[-1].split(" ", 1)[1]) \
            if printed else None
        f = out["failover"]
        print(f"  G4 coordination: both workers registered and serving "
              f"{out['register_to_ready_s']:.1f} s after spawn; served {served}; w0 SIGKILLed: "
              f"SUSPECT after {f['suspect_ms']} ms, DEAD after {f['dead_ms']} ms, epoch "
              f"{f['epoch']}, {f['status']}, shards {f['shards']}; the survivor {f['survivor']} "
              f"answered {f['survivor_tokens']} tokens; worker launches {out['worker_launches']}")
        if set(served) != {"w0", "w1"} or f["dead_ms"] is None or f["suspect_ms"] is None \
                or f["epoch"][1] <= f["epoch"][0] or f["status"] != "DEGRADED" \
                or ("w0", "DEAD", -1) not in f["shards"] or ("w1", "UP", 0) not in f["shards"] \
                or f["survivor"] != "w1" or f["survivor_tokens"] < 1 \
                or not (out["worker_launches"]["w1_printed"] or {}).get("flash_attention") \
                or not (out["worker_launches"]["w1_printed"] or {}).get("paged_decode_bf16"):
            raise AssertionError(f"G4: {out}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(30)
        asyncio.run_coroutine_threadsafe(leader.shutdown(grace=0.2), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(30)
    return out


def run_grpc(torch, cfg, params) -> dict:
    """The grpc phase: G1 and G2 on one ``App`` serving ``InferenceService``
    over a paged bf16 engine (the bf16 path's config), G3 Google Pub/Sub
    over a paged int8 engine, G4 the coordination plane with two worker
    processes. The counters are reset before it; ``launches`` are this
    process's (G1-G3) plus the workers' as they reported them."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    from gofr_tpu_torch.testutil import start_app, stop_app
    from gofr_tpu_torch.tracing import InMemoryExporter

    t0 = time.perf_counter()
    zero_launches()
    out: dict = {"card": card_line()}
    rng = torch.Generator().manual_seed(SEED + 59)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    mem: dict = {}
    conf = dict(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
                max_new_tokens_default=32, prefill_chunk_tokens=2048)
    print(f"G1-G2: App + InferenceService over gRPC + paged bf16 engine (page=16, whole "
          f"prefills), {cfg.n_layers} layers")
    exporter, logbuf = InMemoryExporter(), io.StringIO()
    app, engine = grpc_app(torch, cfg, params, conf, mem, "G1", exporter, logbuf)
    gate, probe = Gate(engine), SyncProbe(engine)
    pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="grpc-client")
    engine.start()
    thread = start_app(app, timeout=120)
    target = f"127.0.0.1:{app.grpc_port}"
    try:
        t = time.perf_counter()
        out["G1"] = grpc_g1(torch, engine, app, target, prompt, gate, probe, pool)
        out["G1"]["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        out["G2"] = grpc_g2(torch, engine, app, target, prompt, gate, pool, exporter)
        out["G2"]["seconds"] = time.perf_counter() - t
        lines = [json.loads(line) for line in logbuf.getvalue().splitlines() if line.strip()]
        out["G2"]["log_lines"] = sum("gRPC stream /gofr.v1.Inference/GenerateStream OK"
                                     in str(e.get("message")) for e in lines)
        text = app.container.metrics_manager.expose_prometheus()
        out["G2"]["metrics"] = [n for n in ("app_grpc_server_stats", "app_grpc_stream_stats",
                                            "grpc_server_status") if n in text]
        if len(out["G2"]["metrics"]) != 3 or not out["G2"]["log_lines"]:
            raise AssertionError(f"G2 metrics {out['G2']['metrics']}, log lines "
                                 f"{out['G2']['log_lines']}")
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        probe.close()
        stop_app(app, thread)
        engine.stop()
    out["memory"] = mem
    del engine, app
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["G3"] = grpc_g3(torch, cfg, params, prompt, mem)
    out["G3"]["seconds"] = time.perf_counter() - t
    launches = launch_counts()
    print("G4: the coordination plane (leader here, two worker_main --device cuda processes)")
    t = time.perf_counter()
    out["G4"] = grpc_g4(torch)
    out["G4"]["seconds"] = time.perf_counter() - t
    names = {"flash_attention": "flash_attention", "paged_decode_bf16": "paged_decode_attention",
             "paged_decode_int8": "paged_decode_attention_q"}
    workers = [out["G4"]["worker_launches"]["w0_last_heartbeat"] or {},
               out["G4"]["worker_launches"]["w1_printed"] or {}]
    out["launches_here"] = dict(launches)
    for counts in workers:
        add_launches(launches, {names[k]: v for k, v in counts.items()})
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print_launches("grpc", launches)
    print(f"  grpc: {out['seconds']:.1f}s (G1 {out['G1']['seconds']:.1f}s, G2 "
          f"{out['G2']['seconds']:.1f}s, G3 {out['G3']['seconds']:.1f}s, G4 "
          f"{out['G4']['seconds']:.1f}s; {out['card']})")
    if not all(out["launches_here"].get(k) for k in ("flash_attention", "paged_decode_attention",
                                                     "paged_decode_attention_q")):
        raise AssertionError(f"grpc launches {out['launches_here']}")
    return out


# ---------------------------------------------------------------- analysis twins
K_NEW = 4  # K: new tokens of each request of the bare and the observed pass (one block)
K_SPEC_PROMPTS = 4  # K: the spec engines' prompts in each pass
ANALYSIS_TREE = ("gofr_tpu_torch", "chip_smoke.py", "tools_torch", "examples_torch")
# K: the entries each observed engine's traffic must reach (the bf16 path
# prefills every prompt whole; the others chunk their long prompts)
K_EXPECT = {
    "bf16": {"prefill_compute", "_write_pages", "admit_decode_state", "decode_block_paged",
             "flash_attention", "paged_decode_attention"},
    "int8": {"prefill_compute", "_write_pages", "_write_pages_q", "admit_decode_state",
             "decode_block_paged_q", "ragged_step_paged_q", "flash_attention",
             "paged_decode_attention_q"},
    "dense": {"prefill_compute", "insert_slot", "admit_decode_state", "decode_block",
              "ragged_step", "flash_attention"},
    "dense-w8": {"prefill_compute", "insert_slot_quantized", "admit_decode_state",
                 "decode_block", "ragged_step", "flash_attention"},
    "S1": {"prefill_compute", "insert_slot", "verify_and_sample", "flash_attention"},
    "S2": {"prefill_compute", "_write_pages", "_write_pages_q", "verify_and_sample_paged_q",
           "flash_attention"},
}
# D: the boundaries the HA and fleet phases cross (submits to engines and
# through routers to their replicas, KV migration, the P/D handoff; their
# re-attaches go to the engine, which is no budget boundary)
D_EXPECT = {"ServingEngine.submit", "Router.submit", "LocalReplica.submit",
            "KVMigrator.fetch_chain", "KVMigrator.fetch_handoff"}
ANALYSIS: dict = {"K": {}}  # the {"analysis": ...} record: K by path, then L and D


def analysis_paths() -> list[str]:
    return [str(ROOT / p) for p in ANALYSIS_TREE]


def kernel_pass(torch, engine, name: str, prompts: list) -> dict:
    """K: ``prompts`` twice on ``engine``, greedy, each set admitted in one
    plan step behind a gate, first bare, then under ``KernelObserver``.
    The observed pass's export must match the contract table
    (``check_kernel_table`` empty), reach every entry of ``K_EXPECT[name]``
    and launch each kernel as often as the bare pass; it records each
    entry's distinct signatures and both passes' ms a decode step."""
    from gofr_tpu_torch.analysis.kernelcheck import check_kernel_table
    from gofr_tpu_torch.analysis.kerneltrace import KernelObserver

    t0 = time.perf_counter()
    gate = Gate(engine)
    passes = {}
    for mode in ("bare", "observed"):
        obs = KernelObserver() if mode == "observed" else None
        zero_launches()
        if obs is not None:
            obs.install()
        try:
            with gate.closed():
                futs = [engine.submit(p, max_new_tokens=K_NEW, temperature=0.0) for p in prompts]
            res = [f.result(timeout=900) for f in futs]
        finally:
            if obs is not None:
                obs.uninstall()
        passes[mode] = {"launches": launch_counts(), "ms_per_step": per_step_ms(res),
                        "tokens": [r.token_ids for r in res]}
    payload = obs.export()
    divergences = check_kernel_table(payload)
    signatures: dict = {}
    for case in payload["cases"]:
        signatures[case["kernel"]] = signatures.get(case["kernel"], 0) + 1
    missing = sorted(k for k in K_EXPECT[name] if not obs.counts.get(k))
    out = {"calls": dict(sorted(obs.counts.items())), "signatures": dict(sorted(signatures.items())),
           "divergences": divergences, "violations": payload["violations"], "missing": missing,
           "launches_bare": passes["bare"]["launches"],
           "launches_observed": passes["observed"]["launches"],
           "tokens_equal": passes["bare"]["tokens"] == passes["observed"]["tokens"],
           "ms_per_step_bare": passes["bare"]["ms_per_step"],
           "ms_per_step_observed": passes["observed"]["ms_per_step"],
           "added_s": time.perf_counter() - t0}
    ANALYSIS["K"][name] = out
    print(f"  K {name}: {len(payload['cases'])} distinct call signatures, per entry "
          f"{out['signatures']}; calls {out['calls']}; launches bare {out['launches_bare']}, "
          f"observed {out['launches_observed']}; ms a step bare {out['ms_per_step_bare']}, "
          f"observed {out['ms_per_step_observed']}; {out['added_s']:.1f}s added")
    if divergences or payload["violations"] or missing \
            or out["launches_bare"] != out["launches_observed"]:
        raise AssertionError(f"K {name}: divergences {divergences}, violations "
                             f"{payload['violations']}, entries never observed {missing}, "
                             f"launches {out['launches_bare']} against "
                             f"{out['launches_observed']} observed")
    return out


def leak_traced(torch, phase):
    """L: ``phase()`` with ``leaktrace`` installed before any of its engines
    is built; after it stopped them, nothing acquired may be live and every
    observed acquire/release must be in leakcheck's static table."""
    from gofr_tpu_torch.analysis import leaktrace
    from gofr_tpu_torch.analysis.leakcheck import build_resource_table, check_coverage

    mon = leaktrace.install()
    try:
        t0 = time.perf_counter()
        result = phase()
        phase_s = time.perf_counter() - t0
    finally:
        leaktrace.uninstall()
    t0 = time.perf_counter()
    export = mon.export()
    coverage = check_coverage(export, build_resource_table(analysis_paths()))
    out = {"counts": export["counts"], "unreclaimed": export["unreclaimed"],
           "coverage": coverage, "events": len(export["events"]), "phase_s": phase_s,
           "check_s": time.perf_counter() - t0, "card": card_line()}
    ANALYSIS["L"] = out
    by_kind = ", ".join(f"{k} {v['acquire']}/{v['release']}" for k, v in out["counts"].items())
    print(f"  L leaks: acquires/releases by kind {by_kind}; {len(out['unreclaimed'])} live after "
          f"stop; {len(coverage)} coverage divergence(s); {out['check_s']:.1f}s added "
          f"({out['card']})")
    if out["unreclaimed"] or coverage:
        raise AssertionError(f"L: unreclaimed {out['unreclaimed']}, coverage {coverage}")
    return result


def deadline_checks(mon, phase_s: float) -> dict:
    """D: no budget widened, no crossing with a negative budget, every
    crossing in deadlinecheck's static table, every boundary of
    ``D_EXPECT`` crossed."""
    from gofr_tpu_torch.analysis.deadlinecheck import build_boundary_table, check_deadline_coverage

    t0 = time.perf_counter()
    crossings: dict = {}
    for site in mon.crossings():
        crossings[site] = crossings.get(site, 0) + 1
    coverage = check_deadline_coverage(mon.export(), build_boundary_table(analysis_paths()))
    missing = sorted(D_EXPECT - set(crossings))
    out = {"crossings": dict(sorted(crossings.items())), "violations": mon.violations(),
           "coverage": coverage, "missing": missing, "phase_s": phase_s,
           "check_s": time.perf_counter() - t0, "card": card_line()}
    ANALYSIS["D"] = out
    print(f"  D deadlines: crossings by site {out['crossings']}; {len(out['violations'])} "
          f"violation(s); {len(coverage)} coverage divergence(s); boundaries never crossed "
          f"{missing}; {out['check_s']:.1f}s added ({out['card']})")
    if out["violations"] or coverage or missing:
        raise AssertionError(f"D: violations {out['violations']}, coverage {coverage}, "
                             f"never crossed {missing}")
    return out


# ------------------------------------------------------------ parallel phase
PARALLEL_RANKS = 4  # one world on the one card, every rank on cuda:0 over gloo
PARALLEL_DEADLINE_S = 600.0  # run_spmd kills every rank past this
PARALLEL_LOGITS_REL_TOL = LOGITS_REL_TOL  # relative L2 of bf16 logits, sharded against one rank
PARALLEL_GREEDY_MIN = 0.9  # share of positions whose argmax agrees with one rank's
PARALLEL_LOSS_REL_TOL = 1e-2  # a training step's loss against the one-card step's
MP1_SHAPE = (2, 1000)  # MP1: two prompts of 1000 tokens
MP2_SEQ, MP2_MODEL_SEQ, MP2_DEPTH = 8192, 2048, 2  # MP2: attention S; cp forward S, layers
MP2_HEADS = (32, 8, 128)  # MP2: H, Hkv, D of the attention check (Llama-3-8B's)
MP3_SHAPE, MP3_TRAIN_SHAPE = (2, 2048), (1, MOE_SEQ)  # MP3: 4096 tokens; the step's tokens
MP3_STEPS = 2  # MP3: train steps, EP against one card
MP3_UPDATE_REL_TOL = 0.25  # MP3: relative L2 of an update (after - before) against one card's
MP4_SHAPE, MP4_MICRO = (4, 512), 4  # MP4: batch x tokens, microbatches
MP5_SHAPE, MP5_DEPTH, MP5_STEPS = (4, 256), 2, 3  # MP5: batch x tokens, layers, steps
MP6_DEPTH = 2  # MP6: layers of the checkpoint restored by the tp=4 rules
MP7_SHAPE = (12, 512)  # MP7: batch (divides dp=4 and the shrunk dp=3) x sequence
MP7_COOLDOWN_S = 1.0  # MP7: the breaker's cooldown before the half-open restore
MP7_REL_TOL = 1e-3  # MP7: relative L2 of the client's result against flash on the whole batch


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def parallel_rank(dev, tmp: str, only: str | None = None) -> dict:
    """One rank of the parallel phase's world (``run_parallel``): MP1-MP7
    in order (``only="mp7"``: MP7 alone). Every rank makes the same weights and inputs from ``SEED`` on
    the card; rank 0 also computes each step unsharded and raises when the
    sharded result is out of tolerance (so does any rank's own check).
    Returns this rank's record: times, peak memory, checksums of what every
    rank must hold alike, and the flash launches of the paths alone."""
    import torch
    import torch.distributed as dist

    from gofr_tpu_torch.checkpoint import CheckpointManager
    from gofr_tpu_torch.models import llama, moe, train
    from gofr_tpu_torch.ops.attention import attention
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.parallel import (
        build_mesh, cp_context, llama_sharding_rules, ring_attention, shard_params,
        ulysses_attention,
    )
    from gofr_tpu_torch.parallel.pipeline import pp_forward
    from gofr_tpu_torch.parallel.sharding import local_index, map_with_path
    from gofr_tpu_torch.tree import leaves

    import gc

    rank = dist.get_rank()
    lead = rank == 0
    out: dict = {"rank": rank, "launches": 0, "stages": {}}
    t_rank = time.perf_counter()

    def stage(name: str) -> None:
        """Mark a step's start: seconds since the rank started and the
        memory this rank still holds from the steps before."""
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        out["stages"][name] = {"t_s": time.perf_counter() - t_rank,
                               "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9}
        say(f"{name} at {out['stages'][name]['t_s']:.1f} s, rank 0 holding "
            f"{out['stages'][name]['allocated_gb']:.2f} GB")

    def gen(k: int):
        return torch.Generator(device=dev).manual_seed(SEED + k)

    def timed(fn):
        """(result, ms) of one call, every rank starting together."""
        torch.cuda.synchronize(dev)
        dist.barrier()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, (time.perf_counter() - t) * 1e3

    def fresh_peak() -> None:
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def peak_gb() -> float:
        return torch.cuda.max_memory_allocated(dev) / 1e9

    def say(msg: str) -> None:
        if lead:
            print(f"  {msg}", flush=True)

    def held(ok: bool, what: str, value) -> None:
        if not ok:
            raise AssertionError(f"{what}: {value}")

    def path_launches(fn):
        before = flash_attention.launches
        res = fn()
        out["launches"] += flash_attention.launches - before
        return res

    if only == "mp7":
        stage("MP7")
        out["mp7"] = parallel_mp7(dev, say, held)
        out["launches"] += out["mp7"]["launches"]
        stage("end")
        return out

    # MP1 tensor parallel: Llama-3-8B widths at PLANE_DEPTH layers, tp=4 and dp=2,tp=2
    stage("MP1")
    cfg = llama.LlamaConfig.llama3_8b(n_layers=PLANE_DEPTH)
    full = llama.init_params(cfg, gen(30), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, MP1_SHAPE, device=dev, generator=gen(31))
    meshes = {spec: build_mesh(spec) for spec in ("tp=4", "dp=2,tp=2")}
    local = {spec: shard_params(full, m, llama_sharding_rules()) for spec, m in meshes.items()}
    with torch.no_grad():
        ref = llama.forward(cfg, full, tokens) if lead else None
        full_gb = llama.param_bytes(full) / 1e9
        del full
        out["mp1"] = {}
        for spec, mesh in meshes.items():
            fresh_peak()
            logits, ms = timed(lambda: llama.forward(cfg, local[spec], tokens, mesh=mesh))
            rec = {"ms": ms, "peak_gb": peak_gb(), "shard_gb": llama.param_bytes(local[spec]) / 1e9,
                   "full_gb": full_gb, "logits_sum": float(logits.double().sum())}
            if lead:
                rec["rel_err"] = rel_l2(logits, ref)
                rec["greedy"] = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
                held(rec["rel_err"] <= PARALLEL_LOGITS_REL_TOL and rec["greedy"] >= PARALLEL_GREEDY_MIN,
                     f"MP1 {spec}", rec)
                say(f"MP1 {spec}: logits rel err {rec['rel_err']:.3e}, greedy {rec['greedy']:.4f}, "
                    f"{ms:.1f} ms a forward, peak {rec['peak_gb']:.2f} GB, shard "
                    f"{rec['shard_gb']:.2f} GB of {full_gb:.2f}")
            out["mp1"][spec] = rec
            del logits
        del local, ref

    # MP2 context parallel: attention at S=8192 on sp=4, then the cp forward
    stage("MP2")
    H, Hkv, D = MP2_HEADS
    g = gen(40)
    q = torch.randn((1, MP2_SEQ, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn((1, MP2_SEQ, Hkv, D), generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn((1, MP2_SEQ, Hkv, D), generator=g, device=dev, dtype=torch.bfloat16)
    sp = build_mesh("sp=4")
    out["mp2"] = {}
    with torch.no_grad():
        fresh_peak()
        ring, ring_ms = timed(lambda: ring_attention(q, k, v, sp))
        uly, uly_ms = timed(lambda: path_launches(lambda: ulysses_attention(q, k, v, sp)))
        out["mp2"].update({"ring_ms": ring_ms, "ulysses_ms": uly_ms, "peak_gb": peak_gb(),
                           "sums": [float(ring.double().sum()), float(uly.double().sum())]})
        if lead:
            step = 1024  # the plain reference in query chunks: one chunk's logits are 1 GB
            plain = torch.cat([attention(q[:, i:i + step], k[:, :i + step], v[:, :i + step],
                                         causal=True, q_offset=i) for i in range(0, MP2_SEQ, step)], 1)
            flash = flash_attention(q, k, v)  # a comparison launch: not the path's
            errs = {f"{a}_vs_{b}": row_rel_err(x, y) for a, x in (("ring", ring), ("ulysses", uly))
                    for b, y in (("plain", plain), ("flash", flash))}
            out["mp2"]["row_errs"] = errs
            held(all(e <= FLASH_ROW_TOL for e in errs.values()), "MP2 attention", errs)
            say(f"MP2 S={MP2_SEQ} H={H} Hkv={Hkv} D={D} on sp=4: ring {ring_ms:.1f} ms, Ulysses "
                f"{uly_ms:.1f} ms, per-row errors {errs}")
            del plain, flash
        del q, k, v, ring, uly
        cfg2 = llama.LlamaConfig.llama3_8b(n_layers=MP2_DEPTH, attn_impl="cp")
        p2 = llama.init_params(cfg2, gen(41), device=dev)
        toks = torch.randint(0, cfg2.vocab_size, (1, MP2_MODEL_SEQ), device=dev, generator=gen(42))
        ref = llama.forward(dataclasses.replace(cfg2, attn_impl="auto"), p2, toks) if lead else None
        for impl in ("ring", "ulysses"):
            with cp_context(sp, axis="sp", impl=impl):
                logits, ms = timed(lambda: path_launches(lambda: llama.forward(cfg2, p2, toks)))
            rec = {"ms": ms, "logits_sum": float(logits.double().sum())}
            if lead:
                rec["rel_err"] = rel_l2(logits, ref)
                held(rec["rel_err"] <= PARALLEL_LOGITS_REL_TOL, f"MP2 cp {impl}", rec)
                say(f"MP2 cp forward ({impl}, {MP2_DEPTH} layers, S={MP2_MODEL_SEQ}): logits rel err "
                    f"{rec['rel_err']:.3e}, {ms:.1f} ms")
            out["mp2"][f"cp_{impl}"] = rec
            del logits
        del p2, ref

    # MP3 expert parallel: Mixtral widths at MOE_DEPTH layers on ep=4
    stage("MP3")
    mcfg = moe.MoeConfig.mixtral_8x7b(n_layers=MOE_DEPTH,
                                      capacity_factor=8 / 2)  # E / top_k: no token is dropped
    mfull = moe.init_params(mcfg, gen(50), device=dev)
    ep = build_mesh("ep=4")
    rules = moe.moe_sharding_rules()
    mlocal = shard_params(mfull, ep, rules)
    toks = torch.randint(0, mcfg.vocab_size, MP3_SHAPE, device=dev, generator=gen(51))
    ttoks = torch.randint(0, mcfg.vocab_size, MP3_TRAIN_SHAPE, device=dev, generator=gen(52))
    moved = ("w_router", "w_gate", "w_up", "w_down")  # the leaves an EP update splits or sums
    with torch.no_grad():
        if lead:
            ref, (rf, rp) = moe.forward(mcfg, mfull, toks, return_aux=True)
    if lead:  # the one-card steps, in place on the full tree; then rank 0's slices of it
        before = {k: mlocal["layers"][k].clone() for k in moved}
        init, step = train.make_moe_train_step(mcfg, None)
        opt = init(mfull)
        ref_losses = []
        for _ in range(MP3_STEPS):
            mfull, opt, loss = step(mfull, opt, ttoks)
            ref_losses.append(float(loss))
        ref_moved = {k: mfull["layers"][k][local_index(tuple(mfull["layers"][k].shape),
                                                       rules.spec_for(f"layers/{k}"), ep)].clone()
                     for k in moved}
        del opt, init, step
    del mfull
    with torch.no_grad():
        fresh_peak()
        (logits, (f, p)), ms = timed(lambda: moe.forward(mcfg, mlocal, toks, mesh=ep, return_aux=True))
        rec = {"ms": ms, "peak_gb": peak_gb(), "logits_sum": float(logits.double().sum())}
        if lead:
            rec.update({"rel_err": rel_l2(logits, ref), "f_err": float((f - rf).abs().max()),
                        "p_err": float((p - rp).abs().max())})
            held(rec["rel_err"] <= PARALLEL_LOGITS_REL_TOL and rec["f_err"] <= 1e-2
                 and rec["p_err"] <= 1e-3, "MP3 forward", rec)
            del ref
        del logits
    init, step = train.make_moe_train_step(mcfg, ep)
    opt = init(mlocal)
    fresh_peak()
    losses, step_ms = [], []
    for _ in range(MP3_STEPS):
        res, t_ms = timed(lambda: step(mlocal, opt, ttoks))
        losses.append(float(res[2]))
        step_ms.append(t_ms)
        del res  # the step's (params, opt_state, loss): the state is mlocal and opt
    rec.update({"train_losses": losses, "train_ms": step_ms, "train_peak_gb": peak_gb()})
    if lead:
        # each update (after minus before) of the router and of this rank's
        # experts against the one-card update's same slice
        rec["update_rel_err"] = {k: rel_l2(mlocal["layers"][k].float() - before[k].float(),
                                           ref_moved[k].float() - before[k].float())
                                 for k in moved}
        rec["train_ref_losses"] = ref_losses
        held(all(abs(a - b) <= PARALLEL_LOSS_REL_TOL * abs(b) for a, b in zip(losses, ref_losses))
             and max(rec["update_rel_err"].values()) <= MP3_UPDATE_REL_TOL, "MP3 train steps", rec)
        say(f"MP3 Mixtral widths, {MOE_DEPTH} layers, ep=4, {MP3_SHAPE[0] * MP3_SHAPE[1]} tokens: "
            f"logits rel err {rec['rel_err']:.3e}, f {rec['f_err']:.2e}, p {rec['p_err']:.2e}, "
            f"{ms:.1f} ms a forward, peak {rec['peak_gb']:.2f} GB; {MP3_STEPS} train steps on "
            f"{MP3_TRAIN_SHAPE[1]} tokens: losses {[round(x, 5) for x in losses]} against one "
            f"card's {[round(x, 5) for x in ref_losses]}, updates' rel err "
            f"{ {k: round(v, 4) for k, v in rec['update_rel_err'].items()} }, ms a step "
            f"{[round(x, 1) for x in step_ms]}")
        del before, ref_moved
    out["mp3"] = rec
    del mlocal, opt, init, step

    # MP4 pipeline: 8B widths at PLANE_DEPTH layers on pp=4, M microbatches
    stage("MP4")
    cfg = llama.LlamaConfig.llama3_8b(n_layers=PLANE_DEPTH)
    full = llama.init_params(cfg, gen(60), device=dev)
    toks = torch.randint(0, cfg.vocab_size, MP4_SHAPE, device=dev, generator=gen(61))
    pp = build_mesh("pp=4")
    plocal = shard_params(full, pp, llama_sharding_rules(pp=True))
    with torch.no_grad():
        ref = llama.forward(cfg, full, toks) if lead else None
        del full
        fresh_peak()
        logits, ms = timed(lambda: pp_forward(cfg, plocal, toks, pp, microbatches=MP4_MICRO))
        rec = {"ms": ms, "peak_gb": peak_gb(), "stage_gb": llama.param_bytes(plocal) / 1e9,
               "logits_sum": float(logits.double().sum())}
        if lead:
            rec["rel_err"] = rel_l2(logits, ref)
            rec["greedy"] = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
            held(rec["rel_err"] <= PARALLEL_LOGITS_REL_TOL and rec["greedy"] >= PARALLEL_GREEDY_MIN,
                 "MP4", rec)
            say(f"MP4 pp=4, {PLANE_DEPTH} layers, {MP4_SHAPE[0]}x{MP4_SHAPE[1]} tokens in "
                f"{MP4_MICRO} microbatches: logits rel err {rec['rel_err']:.3e}, greedy "
                f"{rec['greedy']:.4f}, {ms:.1f} ms, peak {rec['peak_gb']:.2f} GB")
            del ref
        out["mp4"] = rec
        del logits, plocal

    # MP5 training: 8B widths at MP5_DEPTH layers, MP5_STEPS steps from the same start
    stage("MP5")
    cfg = llama.LlamaConfig.llama3_8b(n_layers=MP5_DEPTH)
    full = llama.init_params(cfg, gen(70), device=dev)
    toks = torch.randint(0, cfg.vocab_size, MP5_SHAPE, device=dev, generator=gen(71))
    runs = {"dp=2,tp=2": (build_mesh("dp=2,tp=2"), llama_sharding_rules()),
            "pp=2,dp=2": (build_mesh("pp=2,dp=2"), llama_sharding_rules(pp=True))}
    out["mp5"] = {}
    if lead:  # the one-card step, in place on the full tree
        init, step = train.make_train_step(cfg)
        opt = init(full)
        ref_losses = []
        for _ in range(MP5_STEPS):
            full, opt, loss = step(full, opt, toks)
            ref_losses.append(float(loss))
        out["mp5"]["one_card_losses"] = ref_losses
        del opt
    del full
    for spec, (mesh, rules) in runs.items():
        # the same start for each run, made again from the seed: only this
        # run's slice is alive while it trains
        full = llama.init_params(cfg, gen(70), device=dev)
        params = shard_params(full, mesh, rules)
        del full
        if spec.startswith("pp"):
            init, step = train.make_pp_train_step(cfg, mesh, microbatches=MP5_SHAPE[0])
        else:
            init, compile_for = train.sharded_train_step(cfg, mesh, rules)
            step = compile_for(params, None, toks)
        opt = init(params)
        fresh_peak()
        losses, times = [], []
        for _ in range(MP5_STEPS):
            (params, opt, loss), ms = timed(lambda: step(params, opt, toks))
            losses.append(float(loss))
            times.append(ms)
        rec = {"losses": losses, "ms": times, "peak_gb": peak_gb()}
        if lead:
            rec["one_card_losses"] = ref_losses
            held(all(abs(a - b) <= PARALLEL_LOSS_REL_TOL * abs(b) for a, b in zip(losses, ref_losses)),
                 f"MP5 {spec}", rec)
            say(f"MP5 {spec}, {MP5_DEPTH} layers, {MP5_SHAPE[0]}x{MP5_SHAPE[1]} tokens: losses "
                f"{[round(x, 5) for x in losses]} against one card's "
                f"{[round(x, 5) for x in ref_losses]}, ms a step {[round(x, 1) for x in times]}, "
                f"peak {rec['peak_gb']:.2f} GB")
        out["mp5"][spec] = rec
        del params, opt

    # MP6 sharded restore: a MP6_DEPTH-layer 8B-wide checkpoint by the tp=4 rules
    stage("MP6")
    cfg = llama.LlamaConfig.llama3_8b(n_layers=MP6_DEPTH)
    full = llama.init_params(cfg, gen(80), device=dev)
    mgr = CheckpointManager(tmp)
    if lead:
        mgr.save(1, full)
    dist.barrier()
    ckpt_bytes = os.path.getsize(os.path.join(tmp, "step_000000001", "weights.npz"))
    tp4 = build_mesh("tp=4")
    shardings = llama_sharding_rules().tree_shardings(tp4, full)
    with PeakRss() as rss:
        (shards, ms) = timed(lambda: mgr.restore(full, sharding=shardings, device=dev))
    # rank 0 restores the whole tree and holds it to the saved one; every
    # rank holds its shards to slices of that tree (the same from the seed)
    whole = mgr.restore(full, device=dev) if lead else full
    same: list[bool] = []

    def hold_slice(path: str, shard):
        w = whole
        for key in path.split("/"):
            w = w[key]
        place = shardings
        for key in path.split("/"):
            place = place[key]
        same.append(torch.equal(shard, w[local_index(tuple(w.shape), place.spec, tp4)]))

    map_with_path(hold_slice, shards)
    rec = {"restore_ms": ms, "rss_rise_mib": rss.peak - rss.before, "ckpt_bytes": ckpt_bytes,
           "largest_leaf_bytes": max(t.numel() * t.element_size() for t in leaves(full)),
           "shards_gb": sum(t.numel() * t.element_size() for t in leaves(shards)) / 1e9,
           "bit_equal": all(same) and all(torch.equal(a, b) for a, b in zip(leaves(whole), leaves(full)))}
    del whole
    # a read of any leaf whole would raise the host's RSS by that leaf's bytes at least
    held(rec["bit_equal"] and rec["rss_rise_mib"] * 2 ** 20 < rec["largest_leaf_bytes"],
         f"MP6 rank {rank}", rec)
    say(f"MP6 restore of a {ckpt_bytes / 1e9:.2f} GB checkpoint by the tp=4 rules: {ms:.1f} ms, "
        f"rank 0's host RSS rise {rec['rss_rise_mib']:.1f} MiB (its largest leaf "
        f"{rec['largest_leaf_bytes'] / 2 ** 20:.1f} MiB), shards {rec['shards_gb']:.2f} GB, "
        f"bit-equal {rec['bit_equal']}")
    out["mp6"] = rec
    del full, shards, mgr, shardings
    # MP7 the device client over the mesh: the reference's sick-chip arc on dp=4
    stage("MP7")
    out["mp7"] = parallel_mp7(dev, say, held)
    out["launches"] += out["mp7"]["launches"]
    stage("end")
    return out


def parallel_mp7(dev, say, held) -> dict:
    """MP7, on every rank of the parallel phase's world: ``TPUClient`` with
    ``TPU_MESH="dp=4"`` over the world's ranks, its executable a dp-sharded
    ``flash_attention`` at Llama-3-8B attention widths (captured into a
    CUDA graph on each rank's shard), through the reference's sick-chip
    arc (``tests/test_sick_chip.py``): the fault injected into rank 0's
    executable (device 0, as the reference's ``_FlakyExecutable``; its
    probe fails), two typed 503s below the threshold, the third call trips
    the breaker, excludes device 0, rebuilds the mesh over dp=3 and comes
    back with the right result; health DEGRADED naming device 0; an
    executable whose shardings are bound to the first mesh refused after
    the shrink; after the cooldown the half-open restore brings back dp=4.
    Each result is held to flash on the whole batch; the checksums must be
    every rank's alike (``run_parallel``)."""
    import torch
    import torch.distributed as dist

    from gofr_tpu_torch.datasource.tpu import TPUClient
    from gofr_tpu_torch.datasource.tpu.client import TPUError
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.parallel.sharding import NamedSharding, P

    t0 = time.perf_counter()
    rank = dist.get_rank()
    (B, S), (H, Hkv, D) = MP7_SHAPE, MP2_HEADS
    g = torch.Generator(device=dev).manual_seed(SEED + 90)
    q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev, dtype=torch.bfloat16)
               for h in (H, Hkv, Hkv))
    want = flash_attention(q, k, v, causal=True)
    base = flash_attention.launches  # the client's launches from here on

    def attn(q, k, v):
        return flash_attention(q, k, v, causal=True)

    def dp(mesh):
        return NamedSharding(mesh, P("dp"))

    def error(fn):
        try:
            fn()
        except TPUError as exc:
            return exc.status_code, str(exc)
        return 0, ""

    def health() -> dict:
        d = client.health_check()
        return {"status": d["status"], "excluded": d["details"].get("excluded_devices"),
                "count": d["details"]["device_count"], "dp": d["details"]["mesh"]["dp"]}

    t = time.perf_counter()
    client = TPUClient(mesh_spec=f"dp={PARALLEL_RANKS}", breaker_threshold=3,
                       breaker_cooldown_s=MP7_COOLDOWN_S, device=dev)
    client.connect()
    connect_ms = (time.perf_counter() - t) * 1e3
    client._probe_device = lambda d: d.id != 0  # the fault lives on device 0
    client.compile("attn", attn, q, k, v, in_shardings=lambda m: (dp(m), dp(m), dp(m)),
                   out_shardings=dp)
    bound = dp(client.mesh())
    client.compile("bound", attn, q, k, v, in_shardings=(bound, bound, bound), out_shardings=bound)
    meta = dict(client._exec_meta["attn"])
    rec: dict = {"captured": meta["captured"], "captured_launches": meta["captured_launches"],
                 "connect_ms": connect_ms, "compile_ms": [
                     client._exec_meta[n]["compile_seconds"] * 1e3 for n in ("attn", "bound")]}
    t = time.perf_counter()
    healthy = client.execute("attn", q, k, v, block=True)
    rec["healthy_ms"] = (time.perf_counter() - t) * 1e3
    if rank == 0:  # the reference's _FlakyExecutable, on device 0
        exe = client._executables["attn"]
        real, left = exe.run, [10]

        def flaky(args):
            if left[0] > 0:
                left[0] -= 1
                raise RuntimeError("injected device failure (wedged chip)")
            return real(args)

        exe.run = flaky
    rec["errors"] = [error(lambda: client.execute("attn", q, k, v)) for _ in range(2)]
    t = time.perf_counter()
    failover = client.execute("attn", q, k, v, block=True)  # trips: dp=3, retried
    rec["failover_ms"] = (time.perf_counter() - t) * 1e3
    rec["degraded"] = health()
    rec["bound"] = error(lambda: client.execute("bound", q, k, v))
    time.sleep(MP7_COOLDOWN_S)
    t = time.perf_counter()
    restored = client.execute("attn", q, k, v, block=True)  # the half-open restore: dp=4
    rec["restore_ms"] = (time.perf_counter() - t) * 1e3
    rec["restored"] = health()
    client.close()
    rec["launches"] = flash_attention.launches - base
    rec["rel_err"] = [rel_l2(x, want) for x in (healthy, failover, restored)]
    rec["checksums"] = [float(x.double().sum()) for x in (healthy, failover, restored)]
    rec["seconds"] = time.perf_counter() - t0
    held(rec["errors"] == [(503, "execution of attn failed: injected device failure "
                                 "(wedged chip)")] * 2, f"MP7 rank {rank} typed 503s", rec)
    held(rec["degraded"] == {"status": "DEGRADED", "excluded": [0], "count": 3, "dp": 3},
         f"MP7 rank {rank} after the trip", rec)
    held(rec["bound"][0] == 503 and "recompile" in rec["bound"][1],
         f"MP7 rank {rank} mesh-bound executable after the shrink", rec)
    held(rec["restored"] == {"status": "UP", "excluded": None, "count": 4, "dp": 4},
         f"MP7 rank {rank} after the restore", rec)
    held(all(e <= MP7_REL_TOL for e in rec["rel_err"]), f"MP7 rank {rank} results", rec)
    held(rec["captured"] and rec["captured_launches"] == {"flash_attention": 1}
         and rec["launches"] > 0, f"MP7 rank {rank} capture", rec)
    say(f"MP7 TPUClient over dp={PARALLEL_RANKS}, flash B={B} S={S} H={H} Hkv={Hkv} D={D} bf16 "
        f"a rank's shard captured: 503s {[e[0] for e in rec['errors']]}, failover to dp="
        f"{rec['degraded']['dp']} naming {rec['degraded']['excluded']} in "
        f"{rec['failover_ms']:.1f} ms, bound refused, restore to dp={rec['restored']['dp']} in "
        f"{rec['restore_ms']:.1f} ms, healthy call {rec['healthy_ms']:.1f} ms, connect "
        f"{rec['connect_ms']:.1f} ms, compiles {[round(x, 1) for x in rec['compile_ms']]} ms, errors "
        f"{[f'{e:.2e}' for e in rec['rel_err']]}, flash launches {rec['launches']} (captures), "
        f"{rec['seconds']:.1f} s")
    return rec


def _describe(obj) -> str:
    """A short name for an object on a reference path: its type, and the
    qualified name of a function, method or class it stands for."""
    kind = type(obj)
    name = f"{kind.__module__}.{kind.__qualname__}"
    if issubclass(kind, (types.FunctionType, types.MethodType, type)):
        target = getattr(obj, "__func__", obj)
        name += f" {target.__module__}.{target.__qualname__}"
    return name


def cyclic_garbage(torch, device_type: str = "cuda") -> dict:
    """Collect this process's cyclic garbage and name what held the device
    memory it frees: the device tensors in it (count, bytes), the commonest
    types among the unreachable objects, and for the largest tensor the
    path from it to the nearest object of this repository's classes and
    the shortest cycle through that object. A diagnostic: it reads the
    garbage and frees it as ``gc.collect()`` would."""
    import gc

    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        out = _name_garbage(torch, gc.garbage, device_type)
    finally:
        gc.garbage.clear()
        gc.set_debug(0)
    gc.collect()  # what the saved list kept is garbage again
    return out


def _name_garbage(torch, garbage: list, device_type: str) -> dict:
    import collections
    import gc

    ids = {id(o): o for o in garbage}
    parents: dict[int, list[int]] = collections.defaultdict(list)
    for o in garbage:
        for ref in gc.get_referents(o):
            if id(ref) in ids:
                parents[id(ref)].append(id(o))
    # type(), not isinstance(): a dead weak proxy in the garbage raises
    # on any attribute, __class__ included
    tensors = [o for o in garbage if issubclass(type(o), torch.Tensor)
               and o.device.type == device_type and o.layout == torch.strided]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    out = {"objects": len(garbage), "device_tensors": len(tensors),
           "device_bytes": sum(storages.values()),
           "types": collections.Counter(_describe(o).split(" ")[0] for o in garbage
                                        if not issubclass(type(o), (dict, list, tuple))
                                        ).most_common(12)}

    def ours(o) -> bool:
        module = type(o).__module__ or ""
        return module.startswith(("gofr_tpu_torch", "chip_smoke", "__main__")) and not issubclass(
            type(o), torch.Tensor)

    def bfs(start: int, step, goal) -> list[int]:
        seen, queue = {start: None}, collections.deque([start])
        while queue:
            cur = queue.popleft()
            for nxt in step(cur):
                if goal(nxt):
                    path = [nxt, cur]
                    while seen[path[-1]] is not None:
                        path.append(seen[path[-1]])
                    return path[::-1]
                if nxt not in seen:
                    seen[nxt] = cur
                    queue.append(nxt)
        return []

    if tensors:
        big = max(tensors, key=lambda t: t.untyped_storage().nbytes())
        up = bfs(id(big), lambda i: parents.get(i, ()), lambda i: ours(ids[i]))
        out["path"] = [_describe(ids[i]) for i in reversed(up)]
        if up:
            root = up[-1]
            down = bfs(root, lambda i: [id(r) for r in gc.get_referents(ids[i]) if id(r) in ids],
                       lambda i: i == root)
            out["cycle"] = [_describe(ids[i]) for i in down]
    return out


HELD_MAX_GB = 0.5  # the parent's memory_allocated before any collection, at a spawning phase


def parent_memory(torch, phase: str) -> tuple[float, float, dict]:
    """The parent's ``memory_allocated`` before any collection, then
    :func:`cyclic_garbage`'s report (expected: no CUDA tensor) and the
    allocation after it. The earlier phases' engines are freed by their
    last reference once their patches are undone (ROADMAP Queue C 61), so
    more than ``HELD_MAX_GB`` before the collection fails the phase."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    cyclic = cyclic_garbage(torch)
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    print(f"  parent at the {phase} phase: {held / 1e9:.2f} GB allocated before any collection, "
          f"{after / 1e9:.2f} GB after one; the cyclic garbage {cyclic}", flush=True)
    if held > HELD_MAX_GB * 1e9:
        raise AssertionError(f"{phase}: the parent holds {held / 1e9:.2f} GB before a collection "
                             f"(at most {HELD_MAX_GB} GB), cyclic garbage {cyclic}")
    return held, after, cyclic


def run_parallel(torch, only: str | None = None) -> dict:
    """The parallel phase: one world of ``PARALLEL_RANKS`` spawned ranks on
    the one card over gloo (``parallel.world.run_spmd``, rank function
    ``parallel_rank``; ``only="mp7"`` runs MP7 alone), after the parent
    released its engines. Every rank must report the same checksums; the
    ranks' flash launches on the paths add up to the phase's count."""
    import tempfile

    import chip_smoke as me  # by its module name: a spawned rank imports it
    from gofr_tpu_torch.parallel import world

    held, after, cyclic = parent_memory(torch, "parallel")
    free, total = torch.cuda.mem_get_info()
    print(f"  parent: mem_get_info {free / 1e9:.2f} GB free of {total / 1e9:.2f} GB, "
          f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB; {PARALLEL_RANKS} ranks, "
          "backend gloo (NCCL refuses two ranks on one card): collectives other than all_reduce "
          "stage CUDA tensors through host copies", flush=True)
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_parallel_", dir=ROOT)
    t0 = time.perf_counter()
    try:
        ranks = world.run_spmd(me.parallel_rank, PARALLEL_RANKS, args=(tmp, only),
                               backend="gloo", timeout_s=PARALLEL_DEADLINE_S)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_s = time.perf_counter() - t0
    for key, sub in (("mp1", "tp=4"), ("mp1", "dp=2,tp=2"), ("mp2", "cp_ring"),
                     ("mp2", "cp_ulysses"), ("mp3", None), ("mp4", None)):
        if only is not None:
            break
        sums = {r["rank"]: (r[key][sub] if sub else r[key])["logits_sum"] for r in ranks}
        if len(set(sums.values())) != 1:
            raise AssertionError(f"{key} {sub}: the ranks' logits differ: {sums}")
    mp7 = {r["rank"]: (r["mp7"]["checksums"], r["mp7"]["errors"], r["mp7"]["degraded"],
                       r["mp7"]["restored"]) for r in ranks}
    if len({json.dumps(x) for x in mp7.values()}) != 1:
        raise AssertionError(f"MP7: the ranks' outputs or states differ: {mp7}")
    print(f"  MP7: {max(r['mp7']['seconds'] for r in ranks):.1f} s on the slowest rank; every "
          f"rank's checksums {mp7[0][0]}", flush=True)
    out = {"ranks": ranks, "phase_s": phase_s, "free_gb_before": free / 1e9,
           "parent_gb_before_gc": held / 1e9, "parent_gb_after_gc": after / 1e9, "cyclic": cyclic,
           "launches": {"flash_attention": sum(r["launches"] for r in ranks),
                        "paged_decode_attention": 0, "paged_decode_attention_q": 0}}
    if out["launches"]["flash_attention"] == 0:
        raise AssertionError("the parallel phase's paths never launched flash (Ulysses)")
    print(f"  parallel phase: {phase_s:.1f} s, flash launches on the paths "
          f"{out['launches']['flash_attention']} (Ulysses, every rank)", flush=True)
    return out


TP_RANKS = 4  # the tp phase's world: one engine's tp group on the one card over gloo
TP_DEPTH = 32  # the tp phase runs the model whole
TP_DEADLINE_S = 900.0  # run_spmd kills every rank past this
TP_FIRST_MIN = 7  # of the 9 greedy main prompts, first tokens equal to the one-card path's
TP_LOAD = (8, 4, 5)  # HTTP /generate calls, gRPC Generate calls, tokens each (the reference test's)


def main_prompts(vocab: int, lens: list[int]) -> tuple[list[int], list[list[int]]]:
    """(the warm-up prompt, the prompts of ``lens``) as ``serve_path``
    draws them for a path."""
    import torch

    rng = torch.Generator().manual_seed(SEED)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, vocab, (n,), generator=rng).tolist()

    warm = prompt(5)
    return warm, [prompt(n) for n in lens]


def tp_kernel_checks(torch, dev) -> dict:
    """Each kernel against its plain version on one call at the tp=4
    engine's local shapes (8 query heads over 2 KV heads, head dim 128),
    with the kernel checks' per-row tolerances. The launches here are no path's: the
    caller zeroes the counters after."""
    from gofr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from gofr_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_q,
        paged_decode_attention_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    shape = dict(H=8, Hkv=2, device=dev)
    out = {}
    q, k, v, kv_len = flash_inputs(torch, gen, 1024, [1000, 5], D=128, **shape)
    out["flash_attention"] = (flash_attention(q, k, v, kv_len, causal=True),
                              flash_attention_ref(q, k, v, kv_len, causal=True), FLASH_ROW_TOL)
    q, kp, vp, tables, lens = paged_inputs(torch, gen, DECODE_LENS, Dh=128, page=16, **shape)
    out["paged_decode_attention"] = (paged_decode_attention(q, kp, vp, tables, lens),
                                     paged_decode_attention_ref(q, kp, vp, tables, lens),
                                     PAGED_ROW_TOL)
    q, kq, vq, ks, vs, tables, lens = paged_inputs_q(torch, gen, DECODE_LENS, 32, Dh=128, **shape)
    out["paged_decode_attention_q"] = (
        paged_decode_attention_q(q, kq, vq, ks, vs, tables, lens),
        paged_decode_attention_ref(q, kq, vq, tables, lens, k_scale=ks, v_scale=vs), PAGED_ROW_TOL)
    errs = {}
    for name, (got, want, tol) in out.items():
        rel = row_rel_err(got, want)
        errs[name] = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                      "max_row_rel_err": rel, "tol": tol}
        if not rel <= tol or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"tp: {name} at the local shapes disagrees with its plain "
                                 f"version: {errs[name]}")
    return errs


def tp_serve(engine, warm: list[int], prompts: list[list[int]], new: int):
    """The main path's traffic on an engine: the warm-up, then every prompt
    at once, the fourth sampled (as ``serve_path`` submits them)."""
    engine.submit(warm, max_new_tokens=4).result(timeout=600)
    futs = [engine.submit(p, max_new_tokens=new,
                          **(dict(temperature=0.8, top_k=50, top_p=0.95) if i == 3 else {}))
            for i, p in enumerate(prompts)]
    return [f.result(timeout=900) for f in futs]


def tp_load(engine, app, base: str, grpc_target: str) -> dict:
    """The reference test's load on the tp engine behind an App: HTTP
    ``/generate`` and gRPC ``Generate`` at once, ``TP_LOAD[2]`` tokens
    each; ``app_ttft_seconds`` must count every one."""
    import concurrent.futures
    import urllib.request

    from gofr_tpu_torch.grpcx import InferenceClient

    n_http, n_grpc, new = TP_LOAD
    ttft = app.container.metrics_manager.get("app_ttft_seconds")
    count0 = ttft.snapshot()[1]

    def http_gen(i: int) -> tuple[float, dict]:
        body = json.dumps({"prompt": f"load {i}", "max_tokens": new, "temperature": 0.0}).encode()
        req = urllib.request.Request(base + "/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            data = json.loads(resp.read())["data"]
        return time.perf_counter() - t, data

    async def grpc_gen() -> list:
        client = InferenceClient(grpc_target)
        try:
            return await asyncio.gather(*[client.generate(f"grpc {i}", max_tokens=new)
                                          for i in range(n_grpc)])
        finally:
            await client.close()

    with concurrent.futures.ThreadPoolExecutor(n_http) as pool:
        futs = [pool.submit(http_gen, i) for i in range(n_http)]
        grpc_res = asyncio.run(grpc_gen())
        http_res = [f.result(timeout=600) for f in futs]
    count = ttft.snapshot()[1] - count0
    ttfts = sorted(d["usage"]["ttft_ms"] for _, d in http_res)
    answers = sorted(s * 1e3 for s, _ in http_res)  # client clock: the whole answer
    out = {"http": len(http_res), "grpc": len(grpc_res), "ttft_count": count,
           "http_ttft_ms_p50": ttfts[len(ttfts) // 2],
           "http_answer_ms_p50_client": answers[len(answers) // 2],
           "ttft_s_p50_histogram": ttft.percentile(0.5),
           "grpc_finish": sorted({r["finish_reason"] for r in grpc_res}),
           "http_completion_tokens": sorted({d["usage"]["completion_tokens"] for _, d in http_res})}
    if (out["http"] != n_http or out["grpc"] != n_grpc or count != n_http + n_grpc
            or not set(out["grpc_finish"]) <= {"length", "stop"}
            or min(out["http_completion_tokens"]) < 1):
        raise AssertionError(f"tp: the HTTP and gRPC load on TP-B: {out}")
    return out


def tp_rank(dev, inp: dict) -> dict:
    """One rank of the tp phase (``run_tp``): every rank draws the 8B
    weights from ``SEED`` leaf by leaf and keeps its tp=4 slices
    (``init_params(mesh=)``); rank 0 holds the kernels to their plain
    versions at the local shapes and its tp ``prefill`` logits to the
    one-card ones, then runs TP-B (with an App over HTTP and gRPC) and TP-Q
    as ``ServingEngine(..., mesh=)`` while every other rank runs
    ``serve_follower`` for each. Returns this rank's launches, peak memory,
    hash of its packed blocks and, on rank 0, the checks' record."""
    import torch
    import torch.distributed as dist

    from gofr_tpu_torch import EngineConfig, ServingEngine
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.parallel import build_mesh
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    from gofr_tpu_torch.serving.tp_group import serve_follower

    rank = dist.get_rank()
    lead = rank == 0
    t_rank = time.perf_counter()

    def say(msg: str) -> None:
        if lead:
            print(f"  {msg} ({time.perf_counter() - t_rank:.1f} s into the rank)", flush=True)

    mesh = build_mesh("tp=4")
    cfg = llama.LlamaConfig.llama3_8b(n_layers=TP_DEPTH)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                               mesh=mesh)
    torch.cuda.synchronize(dev)
    out: dict = {"rank": rank, "params_gb": llama.param_bytes(params) / 1e9,
                 "init_s": time.perf_counter() - t_rank}
    say(f"rank 0's slices: {out['params_gb']:.2f} GB, drawn leaf by leaf in {out['init_s']:.1f} s")
    if lead:
        out["kernel_checks"] = tp_kernel_checks(torch, dev)
        say(f"kernels at the local shapes (H 8, Hkv 2): {out['kernel_checks']}")
    # the numeric gate: the tp prefill the engine dispatches, against one card's
    ids = inp["logits_prompt"]
    cache = llama.KVCache.create(cfg, 1, max_len=len(ids), device=dev, mesh=mesh)
    logits, _ = llama.prefill(cfg, params, torch.tensor([ids], device=dev), cache,
                              torch.tensor([len(ids)], dtype=torch.int32, device=dev), mesh=mesh)
    del cache
    if lead:
        rel = rel_l2(logits[0].cpu(), inp["ref_logits"])
        out["logits_rel_l2"] = rel
        out["logits_argmax_equal"] = int(logits[0].argmax()) == int(inp["ref_logits"].argmax())
        say(f"tp prefill of the {len(ids)}-token prompt: logits relative L2 {rel:.3e} against one "
            f"card (tolerance {LOGITS_REL_TOL}), argmax equal {out['logits_argmax_equal']}")
        if not rel <= LOGITS_REL_TOL:
            raise AssertionError(f"tp: prefill logits relative L2 {rel} > {LOGITS_REL_TOL}")
    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out["engines"] = {}
    for name, path, lens in (("TP-B", "bf16", MAIN_LENS), ("TP-Q", "int8", MAIN_LENS + [LONG_PROMPT])):
        conf = EngineConfig(**MAIN_ENGINES[path])
        if not lead:
            res = serve_follower(cfg, params, conf, mesh=mesh, device=dev)
            out["engines"][name] = {"blocks": res.blocks, "digest": res.digest}
            continue
        warm, prompts = main_prompts(cfg.vocab_size, lens)
        app = thread = None
        if name == "TP-B":
            app, base, grpc_target = tp_app()
        engine = ServingEngine(cfg, params, conf, ByteTokenizer(cfg.vocab_size), seed=SEED,
                               device=dev, mesh=mesh,
                               metrics=app.container.metrics_manager if app else None)
        t0 = time.perf_counter()
        try:
            if app is not None:
                from gofr_tpu_torch.grpcx import InferenceService
                from gofr_tpu_torch.serving.handlers import register_generation_routes

                register_generation_routes(app, engine)
                app.register_grpc_service(InferenceService(engine))
                thread = threading.Thread(target=app.run, daemon=True)
                thread.start()
                wait_until(lambda: alive(base), 120, f"{base} to come up")
            else:
                engine.start()
            results = tp_serve(engine, warm, prompts, 32)
            rec = tp_record(results, inp["gold"][path], lens)
            say(f"{name} ({path} path's config): prompts {lens}; first tokens equal to the one-card "
                f"path's on {rec['first_equal']} of {rec['greedy']} greedy prompts, common "
                f"prefixes {rec['common_prefix']}; decode {rec['decode_ms_per_step']:.1f} ms a "
                f"step (median), TTFT max {rec['ttft_ms_max']:.1f} ms")
            if app is not None:
                rec["load"] = tp_load(engine, app, base, grpc_target)
                say(f"{name} HTTP and gRPC load: {rec['load']}")
        finally:
            if app is not None:
                app.stop()
            if thread is not None:
                thread.join(timeout=60)
            engine.stop()
        rec["seconds"] = time.perf_counter() - t0
        rec["blocks"], rec["digest"] = engine.tp_digest()
        out["engines"][name] = rec
        del engine
    torch.cuda.synchronize(dev)
    out["launches"] = {n: fn.launches for n, fn in kernels.items()}
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    say(f"rank 0's launches {out['launches']}, peak {out['peak_gb']:.2f} GB")
    return out


def tp_app():
    """An App on free ports with HTTP and gRPC for TP-B: (app, HTTP base,
    gRPC target); the caller registers the engine and runs it."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.testutil import new_server_configs

    ports = new_server_configs(set_env=False)
    app = App(MapConfig({"HTTP_PORT": str(ports.http_port), "GRPC_PORT": str(ports.grpc_port),
                         "METRICS_PORT": str(ports.metrics_port), "HTTP_HOST": "127.0.0.1",
                         "APP_NAME": "chip-smoke-tp", "LOG_LEVEL": "ERROR"}, use_env=False))
    return app, f"http://127.0.0.1:{ports.http_port}", f"127.0.0.1:{ports.grpc_port}"


def alive(base: str) -> bool:
    """The app at ``base`` answers ``/.well-known/alive``."""
    import urllib.request

    try:
        urllib.request.urlopen(base + "/.well-known/alive", timeout=1)
        return True
    except OSError:
        return False


def tp_record(results, gold: list[list[int]], lens: list[int]) -> dict:
    """Each result against the one-card path's tokens for the same prompt:
    the first tokens of the greedy prompts (the fourth samples) and each
    prompt's common prefix; every request must finish."""
    first, prefixes = 0, []
    greedy = [i for i in range(min(len(lens), len(MAIN_LENS))) if i != 3]
    for i, (r, want) in enumerate(zip(results, gold)):
        if r.finish_reason not in ("length", "stop") or not r.token_ids:
            raise AssertionError(f"tp: the {lens[i]}-token prompt ended {r.finish_reason}")
        n = 0
        while n < min(len(r.token_ids), len(want)) and r.token_ids[n] == want[n]:
            n += 1
        prefixes.append(n)
        first += i in greedy and r.token_ids[0] == want[0]
    per_step = sorted((r.duration_s - r.ttft_s) / (r.completion_tokens - 1) * 1e3
                      for r in results if r.completion_tokens > 1)
    rec = {"first_equal": first, "greedy": len(greedy), "common_prefix": prefixes,
           "decode_ms_per_step": per_step[len(per_step) // 2],
           "ttft_ms_max": max(r.ttft_s for r in results) * 1e3}
    if first < TP_FIRST_MIN:
        raise AssertionError(f"tp: first tokens equal on {first} of {len(greedy)} greedy prompts "
                             f"(at least {TP_FIRST_MIN})")
    return rec


def run_tp(torch, gold: dict | None = None) -> dict:
    """The tp phase: the one-card reference first (the whole weights from
    ``SEED``, ``llama.prefill``'s last-position logits of the main path's
    1000-token prompt), freed before one world of ``TP_RANKS`` spawned
    ranks on the one card over gloo runs ``tp_rank``. ``gold`` is each
    main path's tokens by prompt (the script's own ``MAIN_TOKENS``). Every
    rank's hash of its packed blocks must equal rank 0's; each kernel must
    launch on every rank."""
    import chip_smoke as me  # by its module name: a spawned rank imports it
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.parallel import world

    gold = MAIN_TOKENS if gold is None else gold
    if not {"bf16", "int8"} <= set(gold):
        raise AssertionError("tp: the bf16 and int8 paths' tokens are not recorded")
    held, _, cyclic = parent_memory(torch, "tp")
    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b(n_layers=TP_DEPTH)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                               device="cuda")
    _, prompts = main_prompts(cfg.vocab_size, MAIN_LENS)
    ids = prompts[MAIN_LENS.index(1000)]
    cache = llama.KVCache.create(cfg, 1, max_len=len(ids), device="cuda")
    logits, _ = llama.prefill(cfg, params, torch.tensor([ids], device="cuda"), cache,
                              torch.tensor([len(ids)], dtype=torch.int32, device="cuda"))
    ref_logits = logits[0].cpu()
    del params, cache, logits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    print(f"  one-card reference: the {len(ids)}-token prompt's prefill logits at full depth in "
          f"{ref_s:.1f} s; parent {torch.cuda.memory_allocated() / 1e9:.2f} GB after", flush=True)
    t0 = time.perf_counter()
    ranks = world.run_spmd(me.tp_rank, TP_RANKS, backend="gloo", timeout_s=TP_DEADLINE_S,
                           args=({"gold": {k: gold[k] for k in ("bf16", "int8")},
                                  "logits_prompt": ids, "ref_logits": ref_logits},))
    phase_s = time.perf_counter() - t0
    lead = ranks[0]
    for name in ("TP-B", "TP-Q"):
        want = (lead["engines"][name]["blocks"], lead["engines"][name]["digest"])
        got = {r["rank"]: (r["engines"][name]["blocks"], r["engines"][name]["digest"])
               for r in ranks}
        if set(got.values()) != {want} or want[0] == 0:
            raise AssertionError(f"tp {name}: the ranks' packed blocks differ: {got}")
    for r in ranks:
        if not all(r["launches"].values()):
            raise AssertionError(f"tp: rank {r['rank']} launched {r['launches']}; every kernel must "
                                 "launch on every rank")
    out = {"ranks": ranks, "phase_s": phase_s, "reference_s": ref_s,
           "parent_gb_before_gc": held / 1e9, "cyclic": cyclic,
           "launches": {n: sum(r["launches"][n] for r in ranks) for n in counters()},
           "launches_by_rank": [r["launches"] for r in ranks],
           "peak_gb_by_rank": [r["peak_gb"] for r in ranks]}
    print(f"  tp phase: {phase_s:.1f} s for the world; launches by rank {out['launches_by_rank']}; "
          f"peak GB by rank {out['peak_gb_by_rank']}; packed-block hashes equal on every rank",
          flush=True)
    return out


PLANE_DEPTH = 4  # layers of the phases run at a cut depth (kv-reuse and spec, tenancy, healing,
# observability, HA, fleet, http H1-H2, surface, sql, pubsub, files jobs, stores, analytics, grpc,
# and the parallel phase's MP1 and MP4)
DEVICE_T_DEPTH = 2  # layers of the device phase's T (and K and D on T's weights): the embedding
# and lm_head dominate its checkpoint, which halves against PLANE_DEPTH


def release_engines() -> int:
    """Undo the harness's instance patches of every live engine and drop a
    stopped engine's KV storage and prefix cache (ROADMAP Queue C 61).
    Each ``engine._x = wrapper`` (``Gate``, ``SyncProbe``, the hooks and
    spies) closes over the engine's own bound methods, so a patched engine
    holds itself in a cycle (engine, its ``__dict__``, the wrapper, a cell,
    the engine) until a garbage collection; deleting the instance
    attributes that shadow the class's methods breaks every such cycle. An
    engine that something else keeps in a cycle (a frame an exception's
    traceback holds) keeps no device memory of its own once stopped; its
    weights go with :func:`drop_weights`. Returns the patches undone."""
    import gc

    from gofr_tpu_torch.serving.engine import ServingEngine

    undone = 0
    for obj in gc.get_objects():
        if type(obj) is ServingEngine:
            for name in [k for k in vars(obj) if callable(getattr(ServingEngine, k, None))]:
                del obj.__dict__[name]
                undone += 1
            if obj._thread is None and not obj._running:
                obj.cache = obj._prefix_cache = None
    return undone


CUT_TREES: list = []  # every cut_depth tree, for drop_weights


def drop_weights(*trees) -> None:
    """End the life of a phase's weights where the last phase that serves
    them ends: each params tree, and every tree ``cut_depth`` cut from one,
    is emptied in place. An engine or a frame still holding one (a frame
    an exception's traceback keeps in a reference cycle until a
    collection) then holds no tensor of it (ROADMAP Queue C 61)."""
    def empty(tree: dict) -> None:
        for value in tree.values():
            if isinstance(value, dict):
                empty(value)
        tree.clear()

    for tree in (*trees, *CUT_TREES):
        empty(tree)
    CUT_TREES.clear()


def run_phase(name: str, fn, *args, **kw):
    """One phase: ``fn(*args, **kw)`` with its seconds printed on a line of
    their own, and its engines' patches undone when it ends, failed or
    not (:func:`release_engines`)."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        undone = release_engines()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s ({undone} engine patches undone)",
              flush=True)


def cut_depth(cfg, params, n_layers: int):
    """The config and weights of the first ``n_layers`` layers: views of the
    stacked per-layer tensors, no copy."""
    import dataclasses

    cut = {**params, "layers": {k: v[:n_layers] for k, v in params["layers"].items()}}
    CUT_TREES.append(cut)
    return dataclasses.replace(cfg, n_layers=n_layers), cut


def run_engine(torch) -> tuple[dict, ...]:
    from gofr_tpu_torch import EngineConfig, LlamaConfig
    from gofr_tpu_torch.models.llama import init_params, param_bytes, quantize_params

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params["layers"].values()) + params["embedding"].numel() \
        + params["lm_head"].numel()
    print(f"engine: Llama-3-8B widths, {cfg.n_layers} layers, {n_params / 1e9:.2f}B params "
          f"bf16, random init in {time.perf_counter() - t0:.1f}s")
    launches, timings = {}, {}
    # bf16: the monolithic path as it was; a chunk of 2048 keeps every prompt up
    # to the largest bucket monolithic. 45 tokens: decode crosses a page
    # boundary at 48
    launches["bf16"], timings["bf16"] = run_phase(
        "bf16 path", serve_path, torch, cfg, params, "bf16", EngineConfig(**MAIN_ENGINES["bf16"]),
        MAIN_LENS, must={"flash_attention", "paged_decode_attention"},
        must_not={"paged_decode_attention_q"}, logits_prompt=45, logits_steps=8,
        ttft_lens=(100, 1000),
    )
    torch.cuda.empty_cache()
    # int8: the reference's 256-token chunks; 600 tokens make three chunks
    # and ten decode steps write positions 600-609, across the page
    # boundary at 608
    launches["int8"], timings["int8"] = run_phase(
        "int8 path", serve_path, torch, cfg, params, "int8", EngineConfig(**MAIN_ENGINES["int8"]),
        MAIN_LENS + [LONG_PROMPT], must={"flash_attention", "paged_decode_attention_q"},
        must_not={"paged_decode_attention"}, logits_prompt=600, logits_steps=10,
        ttft_lens=(1000,),
    )
    torch.cuda.empty_cache()
    # dense: the reference's defaults (dense layout, bf16 KV, 256-token
    # chunks); 333, 480, 777 and 1000 chunk through the dense ragged
    # dispatch. 45 tokens prefill whole, as on the bf16 path
    launches["dense"], timings["dense"] = run_phase(
        "dense path", serve_path, torch, cfg, params, "dense",
        EngineConfig(max_slots=8, max_seq_len=2048, kv_layout="dense", multi_step=4,
                     max_new_tokens_default=32, prefill_chunk_tokens=256),
        MAIN_LENS, must={"flash_attention"},
        must_not={"paged_decode_attention", "paged_decode_attention_q"}, logits_prompt=45,
        logits_steps=8, ttft_lens=(100, 1000),
    )
    torch.cuda.empty_cache()
    # dense-w8: int8 KV and weight-only int8 params made on the card from
    # the same weights (the embedding is shared, not copied); 600 tokens
    # make three chunks
    t0 = time.perf_counter()
    params_w8 = quantize_params(params)
    torch.cuda.synchronize()
    print(f"weight-only int8: quantize_params in {time.perf_counter() - t0:.1f}s, "
          f"{param_bytes(params_w8) / 1e9:.2f} GB (bf16 tree {param_bytes(params) / 1e9:.2f} GB)")
    launches["dense-w8"], timings["dense-w8"] = run_phase(
        "dense-w8 path", serve_path, torch, cfg, params_w8, "dense-w8",
        EngineConfig(max_slots=8, max_seq_len=4096, kv_layout="dense", multi_step=4,
                     max_new_tokens_default=32, prefill_chunk_tokens=256, kv_dtype="int8"),
        MAIN_LENS + [LONG_PROMPT], must={"flash_attention"},
        must_not={"paged_decode_attention", "paged_decode_attention_q"}, logits_prompt=600,
        logits_steps=10, ttft_lens=(1000,),
    )
    torch.cuda.empty_cache()
    print("dispatch time against kernel time (torch.profiler):")
    timings["dispatch_busy"] = run_phase("dispatch-busy", dispatch_busy, torch, cfg, params,
                                         params_w8)
    drop_weights(params_w8)
    torch.cuda.empty_cache()
    print("lifecycle phase (dense bf16 and paged int8 engines, full depth; L: under leaktrace, "
          "installed before the first engine is built):")
    lifecycle = run_phase("lifecycle", leak_traced, torch,
                          lambda: run_lifecycle(torch, cfg, params))
    torch.cuda.empty_cache()
    print("kv-reuse and spec phase (prefix caches, spill tier, speculative decoding, "
          f"{PLANE_DEPTH} layers):")
    reuse = run_phase("kv-reuse and spec", run_kv_reuse_spec, torch,
                      *cut_depth(cfg, params, PLANE_DEPTH))
    torch.cuda.empty_cache()
    # the planes at a cut depth keep the script inside its time limit as
    # later phases are added
    cut_cfg, cut_params = cut_depth(cfg, params, PLANE_DEPTH)
    print(f"LoRA and tenancy phase (adapter registry, tenant storm and preemption, "
          f"{PLANE_DEPTH} layers):")
    tenancy = run_phase("LoRA and tenancy", run_tenancy_lora, torch, cut_cfg, cut_params)
    tenancy["dense_path_decode_ms_per_step_batch8"] = timings["dense"]["decode_ms_per_step_batch8"]
    torch.cuda.empty_cache()
    print("healing phase (hang, device loss, poison storm, crash and budget, "
          f"{PLANE_DEPTH} layers):")
    healing = run_phase("healing", run_healing, torch, cut_cfg, cut_params)
    torch.cuda.empty_cache()
    print("observability phase (metrics, tracing, timelines, each engine beside a bare twin, "
          f"{PLANE_DEPTH} layers):")
    observability = run_phase("observability", run_observability, torch, cut_cfg, cut_params)
    del cut_params
    torch.cuda.empty_cache()
    # D: deadlinetrace over the HA and fleet phases
    from gofr_tpu_torch.analysis import deadlinetrace

    dmon = deadlinetrace.install()
    t_d = time.perf_counter()
    try:
        print("HA and cross-replica KV phase (keyed submits, resume, orphan, fencing, KV "
              f"migration, P/D handoff, {PLANE_DEPTH} layers; D: under deadlinetrace):")
        cut_cfg, cut_params = cut_depth(cfg, params, PLANE_DEPTH)
        ha = run_phase("HA", run_ha, torch, cut_cfg, cut_params)
        del cut_params
        torch.cuda.empty_cache()
        print("fleet phase (membership, router, reclamation, autoscaler, P/D routing, "
              f"{PLANE_DEPTH} layers; D: under deadlinetrace):")
        cut_cfg, cut_params = cut_depth(cfg, params, PLANE_DEPTH)
        fleet = run_phase("fleet", run_fleet, torch, cut_cfg, cut_params)
        del cut_params
        torch.cuda.empty_cache()
    finally:
        deadlinetrace.uninstall()
    deadline_checks(dmon, time.perf_counter() - t_d)
    print("http phase (App, generation routes, /metrics, HTTPReplica and a router over HTTP, "
          "the serve entry point as a process, full depth):")
    http = run_phase("http", run_http, torch, cfg, params)
    torch.cuda.empty_cache()
    cut_cfg, cut_params = cut_depth(cfg, params, PLANE_DEPTH)
    print("surface phase (WebSocket generation, API-key auth, cron, a subscriber, CMD mode, the "
          f"drain behind auth, {PLANE_DEPTH} layers):")
    surface = run_phase("surface", run_surface, torch, cut_cfg, cut_params)
    drop_weights(params, cut_params)
    return (launches, timings, lifecycle, reuse, tenancy, healing, observability, ha, fleet, http,
            surface)


def sql_phase(torch) -> tuple[dict, dict, dict, dict, dict, dict]:
    """The sql phase, then the pubsub phase, the files phase (its jobs'
    engine; its weights' loads are ``FILES_S1_DEPTH`` layers of their own),
    the stores phase, the analytics phase and the grpc phase, each at
    Llama-3-8B widths and
    ``PLANE_DEPTH`` layers: views of the first layers of the same weights,
    made again from ``SEED`` (the same tensors ``run_engine`` served; the main
    paths' copy was freed before the models and device phases, which need
    the room), and the time to make them is recorded."""
    from gofr_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the job phases at a cut depth keep the script inside its time limit
    cut_cfg, cut_params = cut_depth(cfg, params, PLANE_DEPTH)
    print(f"sql phase (migrations with a ds.tpu warm-up, CRUD over HTTP, generation jobs recorded "
          f"in SQL, a restart, the postgres and mysql wire dialects; Llama-3-8B widths, "
          f"{PLANE_DEPTH} layers, weights remade from the seed in {init_s:.1f}s):")
    out = run_phase("sql", run_sql, torch, cut_cfg, cut_params, torch.device("cuda"))
    out["params_init_s"] = init_s
    torch.cuda.empty_cache()
    print("pubsub phase (generation jobs through Kafka, NATS, MQTT and Event Hubs, each the port's "
          f"fake on 127.0.0.1 behind an App; the same weights, {PLANE_DEPTH} layers):")
    pubsub = run_phase("pubsub", run_pubsub, torch, cut_cfg, cut_params)
    torch.cuda.empty_cache()
    print("files phase (weights through the local, S3, GCS and FTP file systems and from_hf at "
          f"Llama-3-8B widths, {FILES_S1_DEPTH} layer; generation jobs from files on each file "
          f"system, SFTP too, with a Redis result cache; the same weights, {PLANE_DEPTH} "
          "layers):")
    files = run_phase("files", run_files, torch, cut_cfg, cut_params,
                      LlamaConfig.llama3_8b(n_layers=FILES_S1_DEPTH))
    torch.cuda.empty_cache()
    print("stores phase (generation jobs claimed in Cassandra, logged in Mongo, metered in a "
          "logged batch, indexed in Solr and tracked in DynamoDB, each the port's fake on "
          "127.0.0.1, with the card's memory sampled into a time-series store; then the same jobs "
          f"over the embedded stores; paged int8, the same weights, {PLANE_DEPTH} layers):")
    stores = run_phase("stores", run_stores, torch, cut_cfg, cut_params)
    torch.cuda.empty_cache()
    print("analytics phase (the FFI check of csrc against _build.SIGNATURES; generation jobs "
          "metered in ClickHouse (the port's fake on 127.0.0.1) and linked in the graph store, "
          "the vendor facades over the same records, all under the lock-order shim checked "
          f"against lockcheck's static graph; paged bf16, the same weights, {PLANE_DEPTH} "
          "layers):")
    analytics = run_phase("analytics", run_analytics, torch, cut_cfg, cut_params)
    torch.cuda.empty_cache()
    print("grpc phase (InferenceService over the port's own HTTP/2 wire: streaming decode and the "
          "lifecycle over gRPC on a paged bf16 engine; Google Pub/Sub jobs on the port's fake over "
          "a paged int8 engine; the coordination plane with two worker processes on the card; the "
          f"same weights, {PLANE_DEPTH} layers):")
    grpc = run_phase("grpc", run_grpc, torch, cut_cfg, cut_params)
    drop_weights(params, cut_params)
    torch.cuda.empty_cache()
    return out, pubsub, files, stores, analytics, grpc


def main() -> int:
    if not (ROOT / "gofr_tpu_torch" / "_build.py").is_file():
        return fail(f"no gofr_tpu_torch package beside {Path(__file__).name}: run it from a checkout")
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from gofr_tpu_torch import _build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = t_script = time.perf_counter()
    ptxas_jobs = start_ptxas(_build)
    try:
        _build.build_all()
    except BaseException:
        for proc in ptxas_jobs.values():  # stop the report's compiles too
            proc.kill()
            proc.wait()
        raise
    print(f"kernels built in {time.perf_counter() - t0:.1f}s ({_build.BUILD_DIR})")
    ptxas = ptxas_report(ptxas_jobs)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = check_kernels(torch, gen)

    (launches, engine_timings, lifecycle, reuse, tenancy, healing, observability,
     ha, fleet, http, surface) = run_engine(torch)
    from gofr_tpu_torch.models.bert import BertConfig
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.models.whisper import WhisperConfig

    print("models phase (BERT-base /embed, Whisper-large-v3 ASR over Pub/Sub from a written "
          f"checkpoint, Llama-3-8B widths at {MODELS_L_DEPTH} layers through from_hf):")
    models = run_phase("models", run_models, torch, BertConfig.base(), WhisperConfig.large_v3(),
                       LlamaConfig.llama3_8b(n_layers=MODELS_L_DEPTH))
    print(f"device phase (training at Llama-3-8B widths, {DEVICE_T_DEPTH} layers; checkpoints "
          f"and from_checkpoint; ctx.tpu executables as CUDA graphs; MoE at Mixtral widths, "
          f"{MOE_DEPTH} layers):")
    from gofr_tpu_torch.models.moe import MoeConfig

    device = run_phase("device", run_device, torch, LlamaConfig.llama3_8b(n_layers=DEVICE_T_DEPTH),
                       MoeConfig.mixtral_8x7b(n_layers=MOE_DEPTH), torch.device("cuda"))
    sql, pubsub, files, stores, analytics, grpc = sql_phase(torch)
    print(f"parallel phase (one world of {PARALLEL_RANKS} ranks on the one card over gloo: MP1 "
          f"tensor parallel at Llama-3-8B widths, {PLANE_DEPTH} layers, tp=4 and dp=2,tp=2; MP2 ring "
          f"and Ulysses attention at S={MP2_SEQ} and the cp forward; MP3 expert parallel at Mixtral "
          f"widths, {MOE_DEPTH} layers; MP4 the GPipe pipeline on pp=4; MP5 sharded and pipelined "
          f"training; MP6 a sharded restore; MP7 TPUClient over dp={PARALLEL_RANKS} through the "
          "sick-chip failover):")
    parallel = run_phase("parallel", run_parallel, torch)
    print(f"tp phase (the tensor-parallel ServingEngine: {TP_RANKS} ranks on the one card over gloo, "
          f"Llama-3-8B widths, all {TP_DEPTH} layers, tp=4; TP-B the bf16 path's config with HTTP "
          "and gRPC, TP-Q the int8 path's with chunked prefill):")
    tp = run_phase("tp", run_tp, torch)
    timer = Timer(torch)
    rows = time_kernels(torch, gen, timer, errs, launches)
    for r in rows:  # the later phases' launches beside the main paths'
        r["launches_fleet"] = fleet["launches"].get(r["name"], 0)
        r["launches_http"] = http["launches"].get(r["name"], 0)
        r["launches_surface"] = surface["launches"].get(r["name"], 0)
        r["launches_models"] = models["launches"].get(r["name"], 0)
        r["launches_device"] = device["launches"].get(r["name"], 0)
        r["launches_sql"] = sql["launches"].get(r["name"], 0)
        r["launches_pubsub"] = pubsub["launches"].get(r["name"], 0)
        r["launches_files"] = files["launches"].get(r["name"], 0)
        r["launches_stores"] = stores["launches"].get(r["name"], 0)
        r["launches_analytics"] = analytics["launches"].get(r["name"], 0)
        r["launches_grpc"] = grpc["launches"].get(r["name"], 0)
        r["launches_parallel"] = parallel["launches"].get(r["name"], 0)
        r["launches_tp"] = tp["launches"].get(r["name"], 0)
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']}) at {r['shape']}")
    print(json.dumps({"information": time_information(torch, gen, timer), "ptxas": ptxas}))
    print(json.dumps({"engine": engine_timings}))
    print(card)
    print(json.dumps({"lifecycle": lifecycle}))
    print(json.dumps({"kv_reuse_spec": reuse}))
    print(json.dumps({"lora_tenancy": tenancy}))
    print(json.dumps({"healing": healing}, default=str))
    print(json.dumps({"observability": observability}, default=str))
    print(json.dumps({"ha": ha}, default=str))
    print(json.dumps({"fleet": fleet}, default=str))
    print(json.dumps({"http": http}, default=str))
    print(json.dumps({"surface": surface}, default=str))
    print(json.dumps({"models": models}, default=str))
    print(json.dumps({"device": device}, default=str))
    print(json.dumps({"sql": sql}, default=str))
    print(json.dumps({"pubsub": pubsub}, default=str))
    print(json.dumps({"files": files}, default=str))
    print(json.dumps({"stores": stores}, default=str))
    print(json.dumps({"analytics": analytics}, default=str))
    print(json.dumps({"grpc": grpc}, default=str))
    print(json.dumps({"parallel": parallel}, default=str))
    print(json.dumps({"tp": tp}, default=str))
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f}s from the kernel build to here")
    print(card)
    print(json.dumps({"analysis": ANALYSIS}, default=str))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
