#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final ``ok`` line). The
exit status is 0 exactly when the ``ok`` line is printed: a failed check
exits 1 through ``fail`` before it, and so does an uncaught exception.

1. device and card: CUDA must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build ``libgst_cuda.so`` from ``gibbs_student_t_tpu_torch/csrc`` with
   nvcc (sm_90a) and print the build seconds;
3. kernel-vs-plain parity on the card: the flagship kernels' inputs are
   captured from a sweep of the flagship run itself (demo pulsar,
   ``mixture``, 1024 chains), and each kernel is held against its plain
   PyTorch version on those inputs (the MH blocks' accept decisions also
   against a float64 run of the plain version); then the factor and the
   hyper block in the launch forms the flagship does not take (a block
   per matrix at m = v = 160, an odd size, 64 chains), and failed
   factorizations among good ones that share their thread block;
4. one deterministic sweep on the card against the same sweep on the CPU
   (plain versions), with identical state and draws: every chain's accept
   counts equal;
5. the flagship run through ``TorchGibbs.sample`` (``record="full"``):
   1024 chains, adapt 100 sweeps with population-covariance proposals,
   then 200 more; every kernel's launch count must equal its launches per
   sweep x sweeps plus its launches per chunk x chunks (chol_fused 2 a
   sweep and 1 a chunk, the telemetry's chunk-end log-posterior;
   tri_solve_T 2, white_mh 1, hyper_mh 1 a sweep), every chain must stay
   finite;
6. timings of each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (a yardstick only); the factor
   and the hyper block also with every matrices-per-block count, at the
   64-chain and m = 160 shapes; the factor, the back-solve, the hyper
   block, the Gram kernels (phases 8 and 11e) and the white MH and MTM
   kernels (with their launch form; phases 8, 9, 10e and 11e too) beside
   their first design's times;
7. torch.profiler over 20 flagship sweeps: device time per sweep, launches
   per sweep and the device's idle share against phase 5's wall;
8. the 1e5-TOA stress path (``bench.py --stress``: 100,000 TOAs padded to
   102,400, 64 chains, no adaptation, ``record="light"``): the white
   kernels' launch form there (a thread-block cluster a chain, the slices
   in shared memory), the Gram kernel (tnt_batched) and the white kernel
   held against their plain versions and float64 on inputs captured from
   a stress sweep, one stress sweep on the card against the CPU at 8 chains, the
   stress run (10 + 20 sweeps; tnt_batched 1, white_mh 1, hyper_mh 1,
   chol_fused 2, tri_solve_T 2 launches per sweep, tnt_batched 1 and
   chol_fused 1 per chunk), the two kernels' timings at the stress shapes
   and a profile of 10 stress sweeps;
9. multiple-try Metropolis (K = 4): the white MTM kernel held against its
   plain version and float64 on inputs captured from a sweep of the
   flagship with MTM on the white block, that run (adapt 100 + 200
   sweeps, ``record="full"``; white_mtm 1, white_mh 0, hyper_mh 1,
   chol_fused 2, tri_solve_T 2 launches per sweep, chol_fused 1 per
   chunk), one sweep with MTM on both blocks on
   the card against the CPU at 64 chains (with b at the next four sweeps
   reported beside it), the same at 1024 chains (adapt 100 + 200 sweeps;
   white_mtm 1, chol_fused 23, tri_solve_T 2, white_mh and hyper_mh 0
   launches per sweep), and the kernel's timing;
10. the multi-pulsar ensemble (``EnsembleGibbs``, the grouped kernels;
   ens32's white kernels must take their warp form, a warp a chain):
   a. the grouped white MH and hyper MH kernels held against their grouped
      plain versions and float64 on inputs captured from a sweep of ens32
      (32 demo pulsars of 130 - (i mod 3) 10 TOAs, 256 chains each, the
      flagship's model), on the draws as they are and with every tie
      separated by a float64 replay, and the factor and solves at the
      ensemble's shapes; the hyper kernel also with warps of two
      pulsars in one block (3 pulsars x 5 chains, 8 chains a block);
   b. one ensemble sweep on the card against the CPU at 4 pulsars x 32
      chains: every chain's accept counts equal;
   c. the ens32 run (adapt 100 + 200 sweeps, ``record="light"``; grouped
      white_mh 1, grouped hyper_mh 1, chol_fused 2, tri_solve_T 2,
      tnt_batched 0 launches per sweep, chol_fused 1 per 50-sweep
      chunk): every chain finite, padded rows
      pinned, pulsar-chain-sweeps/s, ms per sweep and the median and
      minimum over pulsars of ESS(log10_A)/s;
   d. the MTM arm (8 pulsars x 128 chains, MTM on the white block, 20 + 20
      sweeps): the grouped white MTM kernel against its plain version, its
      launches (1 per sweep; chol_fused 1 per chunk) and finite chains;
   e. the grouped kernels' timings beside the same kernel launched
      ungrouped on as many chains, the factor and solves at the ensemble's
      shapes, and a profile of 20 ens32 sweeps;
11. the serving slot pool (``serve.ChainServer``/``SlotPool``, the lanes
   kernels), at pool1024: 1024 lanes in groups of 16, 25-sweep quanta, the
   serving bench's models (130 TOAs, m = 74, Schur 14 + 60, ``mixture``):
   a. the lanes kernels (the Gram kernel with one basis per group, the
      white and hyper blocks at 16 chains a group) held against their
      plain versions and float64 on inputs captured from a sweep of a full
      pool (4 tenants x 256 chains), the MH blocks on the draws as they
      are and with ties separated, the Gram kernel's error as a fraction
      of the same sums over absolute values; the factor and back-solve
      lanes entries at the pool's shapes;
   b. one pool sweep on the card against the CPU at 64 lanes (two tenants
      of 32 chains): every chain's accept counts equal, b reported beside
      the float32 spread of two summation orders on the CPU;
   c. a tenant of 256 chains against ``TorchGibbs`` on the card: its draws
      bit for bit the solo sampler's, and one sweep from the same state
      with the same accept counts once ties are separated;
   d. the pool1024 run through ``ChainServer.run()`` on the serial
      executor (8 tenants of 256
      chains with budgets of 4-7 quanta, then a 40-chain tenant with 8 pad
      lanes; ``record="light"``; tnt_lanes 1, white_mh_lanes 1,
      hyper_mh_lanes 1, chol_fused 2, tri_solve_T 2 launches per pool
      sweep, tnt_lanes 1 and chol_fused 1 more a quantum for the
      telemetry's log-posterior, no dense TNT product, no ungrouped or
      ensemble-form MH launch): results finite and shaped, inactive lanes frozen at every
      quantum, every group freed; busy chain-sweeps/s, occupancy, and
      from a profile of 4 full quanta the launches that draw the lanes'
      numbers (beside the parent's generator draws, a set a tenant) and
      the device's idle share;
   e. the lanes kernels' timings, B3-L and B4-L beside the ensemble's
      grouped launch on the same 1,024 chains, B5-L beside the ensemble's
      matmul per basis.

12. the sampling surface of ``TorchGibbs`` and ``EnsembleGibbs`` at the
   flagship (1024 chains, from phase 5's state):
   a. the factor kernel in its warp form (three rows a lane) at (1024,
      74), as the telemetry's chunk-end log-posterior launches it, and at
      (1, 74), as ``lnlikelihood`` does, against its plain version; the
      (1024, 74) operands with two matrices negated: those two alone turn
      NaN, the others bit for bit as before; both shapes timed (every
      matrices-per-block count too) and again in turns beside the block
      form (``per_block=0``) and ``cholesky_ex``; ``lnlikelihood`` on the
      card against the CPU at 8 points (rtol 1e-5); the launches and
      device time the telemetry adds a sweep and a chunk;
   b. 200 sweeps at ``record="compact8"``, ``"compact"`` and ``"full"``
      from one seed, in turns twice: x, theta, df, z and the acceptance
      rates bitwise equal, b and alpha within one bfloat16 step, pout
      within 1/510 (compact8) or one float16 step (compact); each tier's
      wall per sweep, bytes a chunk and the host's time to turn a chunk
      back into float32 arrays;
   c. ``record_thin=5``: its rows bitwise rows 5k of the full run;
   d. telemetry on and off: chains bitwise equal, the accept sums equal
      to the records' to 1e-5, every log-posterior finite, the wall with
      it on and off (two of each);
   e. recovery: NaN in x and b of 5 chains and alpha = 0 on every TOA of
      2 more: ``diverged_mask`` flags exactly those 7,
      ``sample(reinit_diverged=True)`` re-draws 7, every other chain is
      bitwise the run without the injection, every chain finite at the
      end;
   f. ``sample_until`` (check every 100 sweeps, at most 1000; its first
      100 sweeps adapt): sweeps taken, split-R-hat, ESS(log10_A)/s, its
      first 100 rows bitwise a plain ``sample``'s; the runs of b-f are
      the ``sample`` column of the launch counts (the flagship's launches
      per sweep, and per chunk of the telemetry-on runs); then the
      ensemble's ``sample_until`` on 4 pulsars x 32 chains at compact8:
      its telemetry (4, 32), ``n_toa`` and R-hat (4, p).
13. resumable runs and the drivers (``sample(spool_dir=)``, utils/spool.py,
   gibbs_student_t_tpu_torch/drivers), in a temporary directory removed
   at the end:
   a. the solo spool at the flagship (1024 chains, adapt 100 with
      population-covariance proposals, chunk 100, compact8): 300 sweeps
      in memory, then spooled: the spooled run bitwise the in-memory one
      (every recorded field and stat, the last state, the checkpoint); a
      run killed at sweep 200 (a torn row and one orphan chunk appended
      to every spool file) and resumed from its checkpoint equals the
      unbroken spooled run; ``record_thin=5`` killed at 100 (a torn row
      and an orphan chunk of 20 thinned rows) and resumed gives rows 5k
      of the in-memory run; a resume with another ``record`` or
      ``record_thin`` is refused; 3 dead chains re-drawn under
      ``reinit_diverged`` in memory, spooled, and spooled, killed and
      resumed: the same rows, checkpoint and ``n_reinits``; two spooled
      10-sweep chunks unprofiled, profiled, unprofiled;
   b. the ensemble's spool on ens32's pulsars (256 chains each,
      ``record="light"``, chunk 10): killed at sweep 20 and resumed, it
      equals the unbroken run of 40 sweeps, and ``select_pulsar`` keeps
      each pulsar's TOA count;
   c. the ensemble's ``sample_until`` with a spool on 4 x 32 chains: the
      rows of phase 12's in-memory ``sample_until``, each spooled once;
   d. the drivers on the card: ``drivers.simulate_data``, then
      ``drivers.run_sims`` over the five models on both twins (1024 chains,
      200 sweeps, burn 100, with ``--telemetry-dir`` and ``--ledger``): 10
      trees of ``(100, 1024, 3)`` chains, every array finite, a ``chunk``
      event a chunk, one ledger record on the ``cuda`` platform; then
      ``--ensemble 8 --nchains 128 --models beta --trace-dir``: 8 trees of
      130 - (i mod 3) 10 TOAs and a Chrome trace with the sweep's
      ``gibbs/hyper_mh`` spans;
   e. the spool's cost: the walls a sweep of (a)'s runs in turns, the MB
      written and MB/s of ``ChainSpool.append`` (rows and checkpoint),
      the profile's idle share against the unprofiled wall, and the
      phase's seconds. Launches are checked on the paths ``spool`` (a),
      ``spool_ens`` (b, c), ``drivers`` and ``drivers_ens`` (d).
14. per-chain draws (ops/rng.py, the draw kernel D1 ``csrc/draws.cu``),
   which every path above launched once a sweep:
   a. D1 against its plain version on each path's operands (captured in
      phases 3, 8, 9, 10 and 11: the flagship's 1024 chains, stress 64 x
      102,400 TOAs, full MTM, ens32's 32 x 256, pool1024's lanes), the
      plain version on the card and on the CPU: uniforms bit for bit,
      the share of other values that differ and their largest distance
      in ulps, and the gammas accepted at another attempt; then the retry
      queue and its edges in the flagship's table at 96 chains (whole
      tiles of a = 1 and of a = 0.5 boosted, shapes 0, NaN, inf, -1,
      1e-30, 3e38, 1e20 and 1e30 among good chains) at three tile
      lengths: every value bit for bit the plain version's on the card,
      NaN exactly for the bad shapes, the good chains as when drawn
      alone;
   b. independence on the card: the flagship's chains 0-15 drawn alone,
      and the batch permuted, give their draws bit for bit; a pool tenant
      in the first groups and behind a neighbour gives the same records;
   c. card against CPU: 5 flagship sweeps (64 chains) from one state,
      each side drawing its own numbers from the same seed, every sweep
      held as phase 4 holds one;
   d. costs: the draws' launches and device time a sweep beside the
      parent's generator draws on the flagship, stress, ens32 and
      pool1024, each path's launches a sweep then and now, and D1's time
      beside its first design's, its byte bound, its instruction floor
      (tools/torch_kernel_ab.py: each class of instruction the path's
      values and Marsaglia-Tsang attempts need, counted in the SASS of
      probe kernels, over its rate), its plain version and the generator
      draws.
15. the scheduler and the pipelined executor (``serve.ChainServer``
   ``scheduler=``, ``pipeline=``) at pool1024, in a temporary directory
   removed at the end:
   a. phase 11d's tenant set through the serial loop and the pipelined
      executor in turns (serial, pipelined, pipelined, serial): every
      tenant bit for bit across the four runs, finite and shaped;
   b. lossless preemption on each executor: two spooled priority-2
      tenants of 512 chains x 250 sweeps fill the pool, a priority-0
      tenant of 1024 chains x 50 sweeps arrives after their second
      quantum (the trigger reads ``server.quanta``); both victims are
      preempted, requeued and finish bit for bit their uninterrupted runs
      (every light record field and the accept rates); then a
      deadline-armed victim (deadline 50 sweeps, the interactive tenant
      arriving after the first quantum) resolves with
      ``DeadlineExceeded`` whose spooled prefix is bit for bit the
      uninterrupted run's first rows, and the other victim finishes bit
      for bit; the launches of every phase-15 run are checked as pool
      sweeps (path ``pool_sched``);
   c. serial against pipelined: ms a quantum, device ms a quantum (a
      profile of 4 tenants x 2 quanta under each) and idle share, busy
      chain-sweeps/s, the drain's, dispatch's and admission's host ms a
      quantum and the gap between dispatches; the preemptions, the
      victims' re-admission delay in quanta and the sweep they were
      frozen at; with the card's name and power limit.
16. fault containment and crash recovery (``serve.faults``, the server's
   supervision and lane-health policies, ``serve/manifest.py``,
   ``ChainServer.recover``) at pool1024, in a temporary directory removed
   at the end:
   a. phase 11d's tenant set under a fault script, serial, pipelined (with
      the drain thread's death), pipelined, serial: a NaN lane after the
      first quantum of t0 (``on_divergence="fail"``), t1 (``quarantine``)
      and t2 (``reinit``), t3's ``on_chunk`` raising at its second
      quantum, t4's staging failing, and on the second run the drain
      thread dying in t5's entry of its second quantum. t0 and t3 fail
      with their two quanta drained (``where`` divergence and drain), t5
      with one (``worker``), t4 is rejected; t1 finishes with chain 0
      quarantined, t2 with it re-drawn and finite; every victim's other
      chains and every other tenant bit for bit 15a's results;
      ``summary()["faults"]`` the same on both executors (plus one failure
      and exactly one worker restart with the death); ms a quantum with
      the script beside 15a's without it;
   b. a process kill on the card: two child processes each serve phase
      15b's two spooled tenants (512 chains x 250 sweeps) with a manifest
      and a flight recorder synced every quantum (``flight_dir``),
      killed (``os._exit(9)``) in the first tenant's second spool append,
      one before and one after its state checkpoint; each left a
      parseable ``flight.json``, valid against the port's schema and at
      most one quantum behind the two it dispatched; a third process calls
      ``ChainServer.recover`` on both manifests and serves them to their
      end: every tenant bit for bit 15b's uninterrupted run, each log
      compacted to its ``server`` record at the close; the seconds from
      that process's start to its first dispatch and each recovered run's
      wall;
   c. the pool's telemetry on and off in turns (4 tenants of 256 chains, 4
      quanta): records bit for bit, launches a sweep, device and wall ms a
      quantum. With telemetry on (the default) every pool quantum launches
      one more tnt_lanes and one more chol_fused (the log-posterior at the
      quantum's end), as phases 11d, 15 and 16 count them (path
      ``pool_faults``).
   The serving observability plane is on by default, so phases 11d, 14,
   15 and 16 run with it; no run of phases 15 and 16 may trip the
   watchdog.
17. the serving observability plane (``serve.MonitorSpec``, spans,
   ``obs_dir``, the flight recorder, the watchdog) at pool1024, in a
   temporary directory removed at the end:
   a. phase 11d's tenant set with every tenant monitored (parameters 0-2)
      and the whole plane on (a span JSONL sink, ``obs_dir``, a metrics
      run directory, the flight recorder, the watchdog), and with all of
      it off, on both executors in turns (serial on, off; pipelined on,
      off, off, on; serial off, on): every tenant bit for bit 15a's
      results; every kernel's launches a quantum equal in every run;
      device ms a quantum on and off (a device-only profile of 4 tenants x
      2 quanta on the serial loop each) within 3 %, and the device events
      whose counts differ on and off reported by name; each tenant's
      final ``progress()`` equal to
      ``ess_per_param``/``split_rhat_per_param`` of its rows to 1e-6; the
      trace a span per (tenant, quantum, role) and a staging span per
      tenant; every record (live and final status, healthz, status.json,
      span lines, events, the metrics manifest, cost, the postmortem,
      flight.json, the Chrome trace) valid against the port's schema; the
      tenants' cost summing to ``dispatch_wall_ms`` to 1e-9; no watchdog
      trip; printed: ms a quantum on and off and the host ms of the
      monitor feed and the ``obs_dir`` refresh, per executor;
   b. a stalled dispatch on each executor: two tenants of the set, the
      second dispatch sleeping 2 s (``dispatch_stall``, ``after=1``)
      under a watchdog whose floor is 0.5 s: ``healthz()``, polled from a
      thread, reports the trip with cause ``dispatch_stall`` during the
      stall (at quantum 1); the postmortem on disk is valid and says why;
      both tenants bit for bit 15a's;
   c. eviction at convergence on each executor: the longest-budget tenant
      of the first four gets ``on_converged="evict"`` and an ESS target
      its 15a rows first reach at a quantum k >= 2 before its budget: it
      converges at exactly k quanta, ends ``done`` with a prefix bit for
      bit 15a's (exactly k quanta on the serial loop), a queued tenant
      takes its groups at the next quantum, ``converged_evictions`` is 1,
      and every other tenant is bit for bit 15a's; occupancy and busy
      chain-sweeps/s beside 15a's. The launches of every phase-17 run are
      checked as pool sweeps (path ``pool_obs``).
18. the serving stack's capacity arms at pool1024 (a window of 4 tenants
   of 256 chains), in a temporary directory removed at the end:
   a. adaptive block scans (``serve.AdaptScanSpec``): a 64-lane pool on
      the card and its CPU twin, the first tenant's white, hyper (so b)
      and z blocks gated, the second's theta, alpha and df, after a
      quantum at full rate two quanta of 5 sweeps, sweep by sweep from
      the card's state and draws (ties separated as in 11b): the gated fields bitwise their carried values
      on the card, accept counts equal and x to 1e-4 (b reported); two of
      four monitored tenants with an ``AdaptScanSpec`` (ESS target 1)
      against none for 5 quanta, both executors in turns: each of the two
      thins, no other does, kernel launches a quantum equal (a gated
      block still launches); printed: the selection probabilities, ms a
      quantum thinning and not, and a device-only profile's launches a
      sweep and device ms a quantum (serial) of each;
   b. warm starts: four ``WarmStartSpec()`` tenants and one
      ``kind="flow"`` tenant of 128 chains, monitored, on the pipelined
      executor with a manifest: one pilot wave served on the pool, none
      degraded; two journaled fits (a mixture and the flow) given to a
      new server draw the same x0 and serve the same tenants bit for bit,
      with no pilot; printed per tenant beside the same tenants cold:
      pilot ms, admission and first-result ms, the final min-ESS, and the
      sweep at which one ESS target (the cold tenants' median min-ESS at
      half the budget) holds, by the monitor's own update on the rows;
   c. recycling on against off, both executors in turns, two tenants
      spooled, and (18a's all-ones check) the first run with every
      lane's gates armed at ones and a fifth on a pool built with
      ``GST_ADAPT_SCAN=0``: chains and spool bytes bit for bit,
      ``recycled_rows`` = (rows - 1) x chains with recycling on and 0
      off, kernel launches a quantum equal; printed: the drain's host ms
      a quantum on and off.
   The launches of every served run of phase 18 are checked as pool
   sweeps (path ``pool_capacity``). Recycling is on by default (as in
   the JAX server), so the served runs of phases 11d and 14-17 tag their
   rows too; the pools of every phase carry block gates, all ones.
19. the wire for one pool (``serve/rpc.py``, ``obs/http.py``,
   ``serve/pool_main.py``) at pool1024, in a temporary directory removed
   at the end; every worker is a ``python -m
   gibbs_student_t_tpu_torch.serve.pool_main`` process on the card (a
   second CUDA context), stopped before the phase ends:
   a. a worker spawned on pool1024's spec (the serial executor, light
      records, telemetry on): the seconds from its spawn to its
      ``ready.json``, which must hold both ports, and whether it built the
      kernels' library or loaded it from the stamp of phase 2's build;
   b. the tenant set submitted through ``RemoteChainServer``: every
      tenant bit for bit 15a's in-process serial results; one tenant
      streamed, its chunk frames one a quantum and their concatenation
      its chain; two tenants with a ``trace_id``, carried by exactly their
      spans in the worker's ``/trace``;
   c. the worker's HTTP endpoints: ``/healthz`` 200, ``/status`` valid
      against the port's schema, ``/metrics`` Prometheus text,
      ``/tenants/<name>/progress`` equal to the remote handle's
      ``progress()``, ``/postmortem`` a valid flight bundle, an unknown
      tenant 404;
   d. control over the wire: a resubmit of a model the worker holds goes
      out digest-only (both submit frames' bytes printed), a queued
      tenant cancelled resolves as cancelled, a model of another basis
      size is rejected while the pool serves on, ``reset`` zeroes the
      counters;
   e. chaos: the worker armed with ``rpc_sever`` severs a streamed
      tenant at its second chunk, and its result fetched by id on a new
      connection is bit for bit; a second worker armed with ``pool_kill``
      dies at its fourth quantum over phase 15b's two spooled victims, a
      ``--recover`` worker maps both in ``ready.json["recovered"]`` and
      serves them bit for bit their uninterrupted runs; printed: the
      seconds from that worker's spawn to its first dispatch;
   f. the wire's cost, in turns: the set in process, through the worker
      (its ``summary()`` written at its ``shutdown``, which must exit 0),
      in process again, and behind an ``RpcServer`` mounted on an
      in-process server, whose kernel launches must equal the in-process
      run's (path ``pool_wire``); printed: ms a quantum and the dispatch
      and drain host ms a quantum of each, the bytes and encode and
      decode ms of a 256-chain result frame and of a chunk frame, and the
      worker's watchdog state (reported: its throughput rule reads
      chain-sweeps/s, which falls with occupancy).
20. the fleet on one card (``serve/router.py``, ``obs/aggregate.py``) at
   pool1024, in a temporary directory removed at the end; each fleet is
   two ``python -m gibbs_student_t_tpu_torch.serve.pool_main`` workers on
   the card (the serial executor, light records), spawned together by
   ``spawn_fleet`` and retired by ``teardown_fleet``:
   a. round-robin placement: 15a's tenant set through the router, every
      tenant bit for bit 15a's in-process serial results, the placements on
      both workers; the fleet's ``/status`` valid against the port's
      ``fleet_status`` schema with both pools reachable, ``/metrics``
      Prometheus text (``prometheus_labeled``), ``/trace`` stitched over
      the router and both workers with a clock a worker and every job's
      router and pool spans (``trace_coverage``); printed: each worker's
      spawn-to-ready seconds and library, and each pool's healthz cause
      (reported, not gated: the watchdog's throughput rule reads
      chain-sweeps/s);
   b. live migration: the set's longest tenant, spooled, pinned to worker
      0 and moved to worker 1 once worker 0 has counted two quanta, with a
      caller blocked in ``result()`` that rides through; a queued tenant
      behind a full pool moved by replay; both bit for bit 15a's results;
   c. dead-pool failover: a fleet whose worker 1 dies at its third
      quantum (``pool_kill``) under two spooled tenants and one in memory;
      the router's watch respawns it with ``--recover``: the spooled ones
      resume and the other is replayed, all bit for bit, and worker 0's
      tenants are untouched; printed: the seconds from the kill to the
      recovered worker's first dispatch;
   d. rebalancing (``rebalance=True``, a fleet of its own): a queued
      tenant behind a full worker 0 stolen by the drained worker 1, bit
      for bit;
   e. reported, not gated, in turns after 20a: the set's busy
      chain-sweeps/s through one worker (all pinned to worker 0), both,
      both, one, with each worker's ms a quantum. The workers' launches are not
      counted (the parent cannot count them); the kernels line is
      unchanged.
21. the pool's last gaps (``SlotPool(record=...)``, whose default is now
   ``"compact8"``, and ``heterogeneous=True``) at pool1024:
   a. B3-L, B4-L and B5-L on masked lanes operands: inputs captured from a
      sweep of a heterogeneous pool1024 holding tenants of 130, 120 and
      100 TOAs (256 chains each; each tenant's groups carry its row mask
      in the white constants and zero suffix rows of T and y, checked),
      held against their plain versions and float64 as 11a holds them
      (accept counts against the float64 referee on the draws as they
      are and with ties separated; B5-L to 1e-4 of M); B3-L and B5-L
      timed on those operands beside their plain versions (B5-L also
      beside the ensemble's matmul per basis), each bound counted over
      every group's real TOAs;
   b. a heterogeneous pool's sweep on the card against the CPU at 96
      lanes (tenants of 130, 120 and 100 TOAs, 32 chains each), ties
      separated, as 11b: accept counts equal, x to 1e-4, the padded rows
      pinned (z 0, alpha 1);
   c. a 256-chain tenant beside another in a 512-lane pool (two quanta)
      under ``"compact8"`` and ``"full"``, and the solo sampler under
      both: the pool's compact8 records are the compact8 casts of its
      full records bit for bit, as the solo sampler's are of its own, and
      the tenant equals the solo compact8 sampler bit for bit wherever its
      full records equal the solo full sampler's (each field's share of
      equal elements printed);
   d. phase 11d's tenant set on the pipelined executor under ``"full"``
      and ``"compact8"`` in turns (full, compact8, compact8, full): each
      compact8 tenant the compact8 casts of its full run, bit for bit;
      printed: the bytes the drain pulls a quantum, one quantum's copy to
      pinned host memory (CUDA events), and the drain's and dispatch's
      host ms a quantum under each. The launches of 21c and 21d are
      checked as pool sweeps (path ``pool_tiers``).
22. the profiling plane (``ops/timers.py``, the server's ``stages``,
   ``obs/introspect.py``), each number beside the card's name and power
   limit, in a temporary directory removed at the end:
   a. the flagship's 20 sweeps from phase 5's state with the stage timers
      off, then on: records bit for bit, each kernel's launches equal
      (paths ``timers_off`` and ``timers_on``) and, counted by the
      profiler by the build's entry-function names, equal on and off and
      to the wrappers' counts; every stage reports once a sweep; printed:
      each stage's ms a sweep, the host ms a sweep of ``sample`` (3 each)
      and of the sweep alone (5 each) in turns, and the host us and the
      stream us (issued behind a hold) of a sweep's eight brackets,
      empty;
   b. ens32 after its adaptation, 20 sweeps of ``_draw`` and ``_sweep``:
      each stage's event ms, as the sweeps run and with the stream held
      50 ms by a sleep kernel before each sweep (the whole sweep queued
      before the stream reaches it, so that no bracket waits for the
      host), beside the profiler's device time of the kernels launched
      inside its bracket (by the launching runtime call's host time
      within the ``stage/<name>`` annotation; profiled with the holds,
      after a warm-up step): in that profiled run, ``hyper_mh`` and
      ``bdraw_factor`` within -2 % / +15 % of their kernels;
   c. phase 11d's tenant set under ``ChainServer``, serial, off (the
      default, ``kernel_timers="auto"``, which leaves the timers down),
      on (``kernel_timers=True``), on, off, off, on: every tenant bit for
      bit; every closed server's hold on the flag given back; the
      first on run's ``summary()``/``status()["stages"]`` valid against
      ``stage_timings`` with the eight names, its shares of the dispatch
      wall summing to at most 1, the tenants' ``stage_device_ms`` summing
      to the totals within 2 % + 0.01 ms, the flight ring's entries and
      context, ``/status`` over HTTP carrying ``stages``; the off
      servers' ``stages`` None; 4 tenants x 4 quanta under the profiler
      (path ``pool_prof`` with 22c's runs): each stage's event ms a
      quantum beside its kernels' device ms; busy chain-sweeps/s off and
      on;
   d. ``run_sims --introspect --device cuda`` (one model, both twins, 20
      sweeps) in a process of its own: its stderr names the build record
      and exactly the kernels the flagship's model launches, each
      ``impl=cuda``; each factor, white and hyper entry in the launch
      form its shape takes (``chol.launch_form``, ``white_form``,
      ``hyper_mh.launch_form``); the ledger record valid against the
      port's schema, its ``cuda`` block's ``peak_bytes`` above 0.
23. the ensemble over a mesh (``parallel/mesh.py``,
   ``parallel/multihost.py``, ``EnsembleGibbs(mesh=)``, ``rhat_collective``)
   at ens32's full width (32 pulsars x 256 chains, ``mixture``, ``vary_df``,
   a beta theta prior, covariance adaptation; 10 adaptive sweeps then 10
   more in chunks of 5, ``record="full"``), in a temporary directory
   removed at the end:
   a. a 1 x 1 mesh over cuda:0 against ``mesh=None``: every record, stat
      and the last state bit for bit (paths ``mesh_none`` and
      ``mesh_1x1``);
   b. a ``{"pulsar": 2, "chain": 2}`` mesh over ``[cuda:0] * 4`` against
      ``mesh=None`` at rtol 2e-4 / atol 1e-5 (the JAX tests' gate): x,
      theta and df after sweeps 1 and 2 (the JAX dryrun's niter=2), z bit
      for bit there, and b after sweep 1 (a block's dense TOA product
      rounds otherwise than the whole batch's, and the b draw, a solve
      through an ill-conditioned Sigma, carries that into the next draw:
      the chains whose b after sweep 2 is more than 2e-4 of its scale
      apart are reported); the largest difference and bitwise equality
      at each of the 20 sweeps;
      the covariance factor of the second adapting chunk within the gate
      for every pulsar whose x was bit for bit through the first chunk
      (bitwise share printed); ms a sweep and launches a sweep of both
      runs (path ``mesh_2x2``, a block's sweep counted as a sweep);
   c. two processes on cuda:0 over ``gloo``, under ``dcn {"pulsar": 2}``
      and under ``dcn {"chain": 2}`` (the covariance gather then crosses
      the processes): each rank's rows within b's gate of its slice of
      b's unsharded run (and whether bit for bit b's 2 x 2 run, whose
      blocks they are), the two tiling the population once, and
      ``rhat_collective`` over the ranks equal to the host's
      ``gelman_rubin`` of their rows to 1e-5 relative;
   d. a one-rank NCCL group (``initialize_distributed(backend="nccl")``):
      ``rhat_collective`` of CUDA tensors against ``gelman_rubin``;
   e. ``run_sims --ensemble 4 --device cuda`` prints its 1 x 1 mesh.
   The processes of c-e run together after b; their launches are not
   counted. One card cannot show blocks on different cards overlapping,
   NCCL between ranks, or the launch guard on cuda:1.
24. the north-star posterior gate on the card (drivers/posterior_gate.py,
   backends/numpy_backend.py), each number beside the card's name and
   power limit:
   o. seven float64 ``NumpyGibbs`` runs start first, in a pool of
      min(7, cores - 1) spawned processes (one BLAS thread each), and work
      while the card's arms run: the five models of
      ``run_sims.model_configs()`` and mixture/beta on the ensemble's
      pulsars 0 and 1 (tools/tpu_gate.py's 10,000 sweeps, burn 1,000,
      thin 20; on a host with too few cores for one round the six
      non-flagship runs are shortened, to no fewer than 4,000 sweeps; the
      lengths used are printed);
   a-d. the arms, at 1024 chains (1,000 sweeps, burn 500, thin 20,
      ``record="compact"`` every 10th sweep; tpu_gate.py's 500 / 150 is
      short of mixture/beta's burn-in of df and alpha on the flagship's
      pulsar, in the JAX package's kernel as in the port's): a. the five
      models at their defaults on the flagship's pulsar (vvh17 from
      ``z_init="zeros"``), but uniform on the ensemble's pulsar 0 (same n,
      m and Schur split; on the flagship's pulsar its posterior has two
      modes that no 10,000-sweep oracle weighs: its own seeds disagree);
      b. the flagship as the bench runs it (100 adapting sweeps with
      population-covariance proposals); c. full MTM (K = 4 on both
      blocks: B6 and the MTM hyper path); d. an 8-pulsar heterogeneous
      ``EnsembleGibbs`` (mixture/beta, ens32's pulsars 0-7, 128 chains
      each: the grouped kernels), its pulsars 0 and 1 gated against their
      own oracle runs. Each arm's launches are checked as its path's
      (flagship, flagship, full_mtm, ens32), and no wrapper may take its
      plain version;
   g. per arm and quantity (the parameters, theta, pout_mean, z_frac, df,
      alpha_log10_mean as the model updates them) the oracle and kernel
      means, the gap in posterior sd and the KS p (the kernel's draws
      subsampled to 4,000): every quantity must hold gap <= 0.33 and
      p >= 0.001; each arm's wall, launches a sweep and the chains the
      telemetry's ``diverged`` flag marks are printed;
   n. the north star, with nothing else running: the adapted flagship's
      chain-sweeps/s over 100 sweeps on the card over the oracle's
      sweeps/s (300 sweeps, one process) on the host; reported, not gated.
   The runs of phase 24 are one path of the kernels line, ``gate``.
25. the pool's constructor surface at pool1024, each number beside the
   card's name and power limit:
   a. phase 11's tenant set (compact8, pipelined) at full rate and at
      ``record_thin=5``, in turns (1, 5, 5, 1): each tenant's thinned rows
      must be its full-rate rows ``[::5]`` bit for bit, and each run's
      launches a sweep equal (the runs are the ``pool_thin`` path); the
      wire MB a quantum, the drain's host ms and ms a quantum of each run
      are printed;
   b. the admission arms, ``GST_SERVE_SCATTER`` 1 against 0 in turns
      (1, 0, 0, 1), each a fresh pipelined server, on the JAX package's
      scatter-vs-bounce schedule at 1024 lanes (two tenants of 512 chains,
      a ``lane_nan`` fault re-drawn on one and quarantined on the other, a
      spooled third admitted mid-flight): every tenant bit for bit across
      the runs, both faults applied, fewer bytes moved by the scatter;
      each run's bytes an admission and admission apply ms percentiles;
   c. a 20-chain tenant of a ``group=32`` pool beside a 256-chain
      neighbour against the same two in a ``group=16`` pool (the same
      lanes): bit for bit, each on the lanes it should hold; against
      ``TorchGibbs.sample`` its start row bit for bit and the later rows
      reported (the lanes kernels are not the solo sampler's, phase 11c).
26. ``dtype=torch.float64`` on the card, the flagship (1024 chains) and
   ens32 (32 x 256), each number beside the card's name and power limit:
   e. on CUDA a float64 path with a kernel that has no float64 form yet
      raises ``NotImplementedError`` at construction: the TOA-blocked
      reduction (B5), a 2,000-TOA pulsar (B3's cluster form), MTM on the
      white block (B6) and a ``SlotPool``;
   a. each float64 kernel (B1, B2, B3's warp form, B4, D1, single-model
      and grouped) against its float64 plain version on the card, on
      inputs captured from a float64 flagship sweep (and its chunk-end
      log-posterior and ``lnlikelihood``) and a float64 ens32 sweep: the
      factor and back-solve to 1e-9 relative, the MH blocks' accept
      counts equal on every chain and x to 1e-12, D1's uniforms bit for
      bit and its other values to 1e-12; D1's float64 draws rounded to
      float32 bit for bit its float32 draws on the same operands;
   c. each float64 kernel's time at those shapes beside the float32
      kernel's on the same operands rounded (in turns: 32, 64, 64, 32),
      its bound (bytes at 3.35 TB/s, FP64 operations at 33.5 TFLOP/s),
      its plain version's and, where one PyTorch call computes the same
      function, that call's in float64; the ptxas registers and spills of
      the float64 entries;
   then the main paths, counts reset before each: the float64 flagship
   (adapt 20 with covariance proposals, then 20; path ``flagship_f64``)
   and the float64 ens32 (20 + 20; path ``ens32_f64``): every chain finite
   and float64, and each path's wall ms a sweep (20 sweeps, in turns:
   32, 64, 64, 32) and device ms a sweep, launches a sweep and idle share
   (10 profiled sweeps) beside the float32 sampler's;
   b. 4 float64 flagship sweeps at 64 chains, the card against the CPU
      (plain versions), each side drawing its own numbers from the same
      seed and state: the first sweep's x, z, theta and df decisions equal
      as integer counts (accepts a chain, z and df per chain) on every
      chain, and the sweeps the trajectories stay equal reported;
   d. the float64 flagship's arm of phase 24 (mixture/beta, 1,000 sweeps,
      burn 500, thin 20) in law against phase 24's mixture/beta oracle
      run, under phase 24's thresholds (no new oracle run; path
      ``gate_f64``).

Launch counts are read per path: every count is set to 0 just before a
run and read just after it; a count is launches per sweep x sweeps plus
launches per chunk x chunks; a grouped launch counts on its wrapper's
``launches_grouped``, a lanes launch of the white or hyper block on its
``launches_lanes``, a float64 launch on its wrapper's ``launches_f64``
or ``launches_grouped_f64``. The last stdout lines are the ``kernels``
JSON line (the six kernels, the three grouped forms, the five lanes
entries, the draw kernel and the seven float64 forms),
the card line, and
``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# launches of each kernel per sweep on each path, and the TPU kernel each
# one replaces
_CHOL = "gibbs_student_t_tpu_torch/csrc/chol.cu"
_WHITE = "gibbs_student_t_tpu_torch/csrc/white_mh.cu"
_HYPER = "gibbs_student_t_tpu_torch/csrc/hyper_mh.cu"
KERNELS = {
    # full_mtm: the Schur A-block and the b draw, plus the hyper MTM
    # loop's 1 + 2 x 10 stacked factorizations (10 hyper steps); per
    # chunk: the telemetry's chunk-end log-posterior, one factorization of
    # the full m x m Sigma (and, on the stress path, one Gram launch) on
    # every path that samples through TorchGibbs._run, and on the pool
    # once a quantum with its telemetry on (then also one tnt_lanes); a
    # pool path's chunks are its telemetry-on quanta
    "chol_fused": dict(
        per_sweep={"flagship": 2, "stress": 2, "mtm": 2, "full_mtm": 23,
                   "ens32": 2, "ens_mtm": 2, "pool": 2},
        per_chunk={"flagship": 1, "stress": 1, "mtm": 1, "full_mtm": 1,
                   "ens32": 1, "ens_mtm": 1, "pool": 1},
        source=_CHOL,
        replaces="gibbs_student_t_tpu/ops/pallas_chol.py:81 _chol_kernel"),
    "tri_solve_T": dict(
        per_sweep={"flagship": 2, "stress": 2, "mtm": 2, "full_mtm": 2,
                   "ens32": 2, "ens_mtm": 2, "pool": 2},
        source=_CHOL,
        replaces="gibbs_student_t_tpu/ops/pallas_chol.py:117 _backsolve_kernel"),
    "white_mh": dict(
        per_sweep={"flagship": 1, "stress": 1, "mtm": 0, "full_mtm": 0,
                   "ens32": 0, "ens_mtm": 0, "pool": 0},
        source=_WHITE,
        replaces="gibbs_student_t_tpu/ops/pallas_white.py:322 _white_kernel"),
    "hyper_mh": dict(
        per_sweep={"flagship": 1, "stress": 1, "mtm": 1, "full_mtm": 0,
                   "ens32": 0, "ens_mtm": 0, "pool": 0},
        source=_HYPER,
        replaces="gibbs_student_t_tpu/ops/pallas_hyper.py:290 _hyper_kernel"),
    "tnt_batched": dict(
        per_sweep={"flagship": 0, "stress": 1, "mtm": 0, "full_mtm": 0,
                   "ens32": 0, "ens_mtm": 0, "pool": 0},
        per_chunk={"stress": 1},
        source="gibbs_student_t_tpu_torch/csrc/tnt.cu",
        replaces="gibbs_student_t_tpu/ops/pallas_tnt.py:53 _tnt_kernel"),
    "white_mtm": dict(
        per_sweep={"flagship": 0, "stress": 0, "mtm": 1, "full_mtm": 1,
                   "ens32": 0, "ens_mtm": 0, "pool": 0},
        source=_WHITE,
        replaces="gibbs_student_t_tpu/ops/pallas_white.py:350 "
                 "_white_mtm_kernel"),
    # the grouped forms: the same kernels with G pulsars' constants, one
    # launch for every pulsar of the ensemble
    "white_mh_grouped": dict(
        per_sweep={"flagship": 0, "stress": 0, "mtm": 0, "full_mtm": 0,
                   "ens32": 1, "ens_mtm": 0, "pool": 0},
        source=_WHITE,
        replaces="gibbs_student_t_tpu/ops/pallas_white.py:482 "
                 "white_mh_fused (G > 1)"),
    "hyper_mh_grouped": dict(
        per_sweep={"flagship": 0, "stress": 0, "mtm": 0, "full_mtm": 0,
                   "ens32": 1, "ens_mtm": 1, "pool": 0},
        source=_HYPER,
        replaces="gibbs_student_t_tpu/ops/pallas_hyper.py:371 "
                 "hyper_mh_fused (G > 1)"),
    "white_mtm_grouped": dict(
        per_sweep={"flagship": 0, "stress": 0, "mtm": 0, "full_mtm": 0,
                   "ens32": 0, "ens_mtm": 1, "pool": 0},
        source=_WHITE,
        replaces="gibbs_student_t_tpu/ops/pallas_white.py:552 "
                 "white_mtm_fused (G > 1)"),
    # the serving slot pool's lanes entries: one launch for every lane of
    # the pool, 16 lanes a group. The factor and back-solve entries have no
    # caller on the pool's path (the pool factors through chol_fused and
    # tri_solve_T, as the JAX pool does); phase 11a holds them
    "tnt_lanes": dict(
        per_sweep={"flagship": 0, "stress": 0, "mtm": 0, "full_mtm": 0,
                   "ens32": 0, "ens_mtm": 0, "pool": 1},
        per_chunk={"pool": 1},
        source="gibbs_student_t_tpu_torch/csrc/tnt.cu",
        replaces="gibbs_student_t_tpu/ops/pallas_tnt.py:173 "
                 "tnt_lanes_pallas"),
    "white_mh_lanes": dict(
        per_sweep={"flagship": 0, "stress": 0, "mtm": 0, "full_mtm": 0,
                   "ens32": 0, "ens_mtm": 0, "pool": 1},
        source=_WHITE,
        replaces="gibbs_student_t_tpu/ops/pallas_white.py:749 "
                 "make_white_block_lanes (Pallas arm)"),
    "hyper_mh_lanes": dict(
        per_sweep={"flagship": 0, "stress": 0, "mtm": 0, "full_mtm": 0,
                   "ens32": 0, "ens_mtm": 0, "pool": 1},
        source=_HYPER,
        replaces="gibbs_student_t_tpu/ops/linalg.py:1245 "
                 "_fused_hyper_lanes_dispatcher (Pallas core)"),
    "chol_fused_lanes": dict(
        per_sweep={"flagship": 0, "stress": 0, "mtm": 0, "full_mtm": 0,
                   "ens32": 0, "ens_mtm": 0, "pool": 0},
        source=_CHOL,
        replaces="gibbs_student_t_tpu/ops/pallas_chol.py:264 "
                 "chol_fused_lanes"),
    "tri_solve_T_lanes": dict(
        per_sweep={"flagship": 0, "stress": 0, "mtm": 0, "full_mtm": 0,
                   "ens32": 0, "ens_mtm": 0, "pool": 0},
        source=_CHOL,
        replaces="gibbs_student_t_tpu/ops/pallas_chol.py:291 "
                 "tri_solve_T_lanes"),
    # D1, the per-chain draws: one launch a sweep on every path (the pool's
    # for every lane). It has no Pallas counterpart: the JAX sweep draws
    # with jax.random, keyed by fold_in(chain key, sweep), inside its XLA
    # program
    "sweep_draws": dict(
        per_sweep={"flagship": 1, "stress": 1, "mtm": 1, "full_mtm": 1,
                   "ens32": 1, "ens_mtm": 1, "pool": 1},
        source="gibbs_student_t_tpu_torch/csrc/draws.cu",
        replaces="none: the jax.random draws XLA fuses into the sweep, "
                 "gibbs_student_t_tpu/backends/jax_backend.py:1907"),
}
DRAWS = "sweep_draws"
# the float64 forms (phase 26): the same wrappers, counted on their
# launches_f64 / launches_grouped_f64, on the float64 flagship and ens32
# paths only
F64_PATHS = ("flagship_f64", "ens32_f64")
for _meta in KERNELS.values():
    for _p in F64_PATHS:
        _meta["per_sweep"][_p] = 0
_PATHS = tuple(KERNELS[DRAWS]["per_sweep"])
_F64 = "gibbs_student_t_tpu_torch/csrc/"
F64_KERNELS = {
    # name: (base kernel, source, launches a sweep on flagship_f64 and
    # ens32_f64, launches a chunk)
    "chol_fused_f64": ("chol_fused", _F64 + "chol.cu", (2, 2), (1, 1)),
    "tri_solve_T_f64": ("tri_solve_T", _F64 + "chol.cu", (2, 2), (0, 0)),
    "white_mh_f64": ("white_mh", _F64 + "white_mh.cu", (1, 0), (0, 0)),
    "white_mh_grouped_f64": ("white_mh_grouped", _F64 + "white_mh.cu",
                             (0, 1), (0, 0)),
    "hyper_mh_f64": ("hyper_mh", _F64 + "hyper_mh.cu", (1, 0), (0, 0)),
    "hyper_mh_grouped_f64": ("hyper_mh_grouped", _F64 + "hyper_mh.cu",
                             (0, 1), (0, 0)),
    "sweep_draws_f64": ("sweep_draws", _F64 + "draws.cu", (1, 1), (0, 0)),
}
for _name, (_base, _src, _ps, _pc) in F64_KERNELS.items():
    KERNELS[_name] = dict(
        per_sweep={**{p: 0 for p in _PATHS}, **dict(zip(F64_PATHS, _ps))},
        per_chunk=dict(zip(F64_PATHS, _pc)), source=_src,
        replaces=KERNELS[_base]["replaces"])
FP64_FLOPS = 33.5e12           # H100 SXM float64 rate outside tensor cores
# phase 26: the float64 main paths' adapting and further sweeps and their
# chunk (also the sweeps of each timed run in turns, after 5 to warm); the
# profiled sweeps; the card-vs-CPU sweeps and chains
F64_ADAPT, F64_MORE, F64_CHUNK = 20, 20, 20
F64_PROFILE_SWEEPS, F64_CPU_SWEEPS, F64_CPU_CHAINS = 10, 4, 64
# phase 12's runs (the "sample" column of launches_by_path) sweep the
# flagship's model and config: they launch the flagship's kernels; so do
# phase 13's solo spool runs ("spool") and the driver's five models
# ("drivers": the reference's model of a simulated 130-TOA pulsar, the
# flagship's shapes), and its ensemble runs launch ens32's grouped kernels
SAME_AS = {"sample": "flagship", "spool": "flagship", "spool_ens": "ens32",
           "drivers": "flagship", "drivers_ens": "ens32",
           "pool_sched": "pool", "pool_faults": "pool", "pool_obs": "pool",
           "pool_capacity": "pool", "pool_wire": "pool",
           "pool_tiers": "pool", "pool_thin": "pool",
           "timers_off": "flagship",
           "timers_on": "flagship", "pool_prof": "pool",
           "mesh_none": "ens32", "mesh_1x1": "ens32", "mesh_2x2": "ens32",
           "gate_a": "flagship", "gate_b": "flagship",
           "gate_c": "full_mtm", "gate_d": "ens32", "gate_ns": "flagship",
           "gate_f64": "flagship_f64"}
# phase 24's runs, merged into one path of the kernels line after checking
GATE_PATHS = ("gate_a", "gate_b", "gate_c", "gate_d", "gate_ns")
# a grouped kernel's entry: the wrapper it shares with the single-model
# launch; it counts on the wrapper's launches_grouped
GROUPED = {"white_mh_grouped": "white_mh", "hyper_mh_grouped": "hyper_mh",
           "white_mtm_grouped": "white_mtm"}
# a lanes entry that counts on its single-model wrapper's launches_lanes
LANES = {"white_mh_lanes": "white_mh", "hyper_mh_lanes": "hyper_mh"}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
FP32_FLOPS = 67e12             # H100 SXM float32 rate outside tensor cores
# phase 14 (per-chain draws): the 14c card-vs-CPU sweeps, the profiled
# draw calls a path, and the stress chains the CPU plain version draws
DRAW_SWEEPS, DRAW_PROFILE_CALLS, DRAW_CPU_STRESS_CHAINS = 5, 10, 4
NCHAINS = 1024
ADAPT, MORE = 100, 200
# the stress config of bench.py --stress, and its card-vs-CPU sweep size
STRESS_N, STRESS_CHAINS, STRESS_WARM, STRESS_MORE = 100_000, 64, 10, 20
STRESS_CPU_CHAINS = 8
# at the stress shape, MH draws within this margin (in nats) of their
# float64 decision are moved clear of it before decisions are compared: a
# float32 log-likelihood summed over 1e5 TOAs is uncertain by far more
# than the 1e-3 the flagship's 130 TOAs need
STRESS_TIE_MARGIN = 0.1
MTM_TRIES = 4
# the ensemble (ens32): 32 demo pulsars (the seeds of
# tools/ensemble_bench.py), 130 - (i mod 3) 10 TOAs (run_sims.py's rule
# for unequal TOA counts at 130), 256 chains each; the MTM arm: 8 pulsars
# of 128 chains, adapt 20 + 20 sweeps; the card-vs-CPU sweep: 4 x 32
ENS_PULSARS, ENS_CHAINS = 32, 256
ENS_MTM_PULSARS, ENS_MTM_CHAINS, ENS_MTM_SWEEPS = 8, 128, 20
ENS_CPU_PULSARS, ENS_CPU_CHAINS = 4, 32
# the serving slot pool (pool1024): tools/serve_bench.py's mixed workload
# (its template and tenant models, 25-sweep quanta, budgets of 4-7 quanta
# from np.random.default_rng(0)), cut in the number of jobs: 8 tenants of
# 256 chains, then one of 40 chains (48 lanes, 8 of them pad lanes) for 4
# quanta; the card-vs-CPU sweep at 64 lanes (2 x 32 chains); the solo
# tenant of 256 chains in a 512-lane pool beside another; the profiled
# window: 4 tenants of 256 chains, 4 quanta
POOL_LANES, POOL_QUANTUM = 1024, 25
POOL_TENANTS, POOL_CHAINS = 8, 256
POOL_PAD_CHAINS, POOL_PAD_SWEEPS = 40, 100
POOL_CPU_LANES, POOL_CPU_CHAINS = 64, 32
# phase 21 (record tiers and heterogeneous pools): the TOA counts of the
# heterogeneous pool's tenants (pool1024's template is 130 TOAs; 120 and
# 100 are run_sims.py's ensemble rule of 130 - (i mod 3) 10)
HET_NS = (130, 120, 100)
POOL_PROFILE_QUANTA = 4
# phase 25: the thinned arm's record_thin
THIN25 = 5
# phase 22 (the profiling plane): sweeps of each flagship and ens32 window;
# sweeps of empty brackets timed for their host cost, and for their
# stream cost behind a hold (few enough to be queued before it ends)
PROF_SWEEPS, BRACKET_SWEEPS, BRACKET_STREAM_SWEEPS = 20, 200, 50
# the stream hold before each of ens32's held sweeps, longer than the host
# takes to issue one, and before the brackets' stream timing: 1e8 cycles,
# at least 50 ms
HOLD_CYCLES = 100_000_000
# phase 12 (the sampling surface): sweeps of each record-tier run, the
# recovery runs' chunk (two chunks a run), sample_until's check interval
# and its most sweeps
TIER_SWEEPS, RECOVERY_CHUNK = 200, 10
UNTIL_CHECK, UNTIL_MAX = 100, 1000
# phase 13 (resumable runs and the drivers): the solo spool's sweeps and
# chunk; the drivers' sweeps and burn-in rows, and their ensemble
SPOOL_SWEEPS, SPOOL_CHUNK, PROFILE_CHUNK = 300, 100, 10
DRIVER_SWEEPS, DRIVER_BURN = 200, 100
DRIVER_ENS, DRIVER_ENS_CHAINS = 8, 128
# phase 16 (fault containment and crash recovery): the killed servers'
# two spooled tenants (phase 15b's victims: 512 chains x 250 sweeps, seeds
# 300 and 301, tenant models 4 and 5), the quanta of each telemetry run
# (one to warm, two timed, one profiled), and the longest a child process
# may take
KILL_CHAINS, KILL_SWEEPS = POOL_LANES // 2, 10 * POOL_QUANTUM
TELE_QUANTA, CHILD_TIMEOUT_S = 4, 300
# the server processes of phase 16b, run as ``python3 -c CHILD16 <checkout>
# <json>``: "kill" serves the two spooled tenants with a manifest until the
# armed kill point ends the process; "recover" calls ChainServer.recover on
# each manifest, serves it to its end and prints one JSON line
CHILD16 = r"""
import json, os, sys, time
t_start = time.time()
sys.path.insert(0, sys.argv[1])
cfg = json.loads(sys.argv[2])
import torch
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import (
    make_contaminated_pulsar, make_reference_pta)
from gibbs_student_t_tpu_torch.serve import ChainServer, TenantRequest, faults


def pool_model(seed):
    psr, _ = make_contaminated_pulsar(n=130, components=30, theta=0.02,
                                      sigma_out=1e-5, seed=seed)
    return make_reference_pta(psr, 30).frozen(0)


if cfg["mode"] == "kill":
    faults.install(faults.FaultSpec(cfg["arm"], tenant="v0", after=1,
                                    action="kill"))
    srv = ChainServer(pool_model(42), GibbsConfig(model="mixture"),
                      nlanes=cfg["nlanes"], quantum=cfg["quantum"],
                      record="light", pipeline=False,
                      manifest_dir=cfg["manifest"], flight_dir=cfg["flight"],
                      flight_sync_every=1)
    for i in range(2):
        srv.submit(TenantRequest(
            ma=pool_model(104 + i), niter=cfg["sweeps"],
            nchains=cfg["chains"], seed=300 + i, priority=2, name=f"v{i}",
            spool_dir=os.path.join(cfg["spools"], f"v{i}")))
    srv.run()
    sys.exit(3)  # not reached: the armed kill ends the process first
runs = []
for man in cfg["manifests"]:
    t0, first = time.time(), []

    def on_quantum(s):
        if s.quanta and not first:      # after the first dispatch
            first.append(time.time())

    srv, handles = ChainServer.recover(man)
    srv.run(on_quantum=on_quantum)
    torch.cuda.synchronize()
    srv.close()
    runs.append({"manifest": man, "recover_t": t0,
                 "first_dispatch_t": first[0], "wall_s": time.time() - t0,
                 "start_sweeps": {k: h.request.start_sweep
                                  for k, h in sorted(handles.items())},
                 "status": {k: h.status for k, h in sorted(handles.items())},
                 "lost": len(srv.lost_tenants),
                 "watchdog": srv.healthz()["watchdog"]["state"]})
print(json.dumps({"t_start": t_start, "runs": runs}))
"""
# phase 23 (the ensemble over a mesh): ens32 at full width, 10 adaptive
# sweeps then 10 more in chunks of 5; the sweeps the shardings are held
# at (the JAX dryrun's niter=2) and their gate
MESH_ADAPT, MESH_SWEEPS, MESH_CHUNK, MESH_SEED = 10, 20, 5, 41
MESH_GATE_SWEEP, MESH_RTOL, MESH_ATOL = 2, 2e-4, 1e-5
# b is held after one sweep: a block's dense TOA product rounds otherwise
# than the whole batch's (the GEMM's kernel follows its shape), and the b
# draw, a solve through an ill-conditioned Sigma, carries that rounding
# into its next draw, up to several % of a chain's largest |b| after two
# sweeps with x, z, theta and df still bit for bit (PERF.md §6)
MESH_B_SWEEP = 1
# the processes of phase 23c/d, run as ``python3 -c CHILD23 <checkout>
# <json>``: "mesh" joins a gloo group of two on one card and samples its
# blocks of ens32 over a hybrid mesh (its rows to an .npz, R-hat over the
# mesh's chain line, or over both ranks where the line stays in one
# process); "nccl" joins a one-rank NCCL group and reduces R-hat of
# CUDA tensors
CHILD23 = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
cfg = json.loads(sys.argv[2])
import numpy as np
import torch
import torch.distributed as dist
from gibbs_student_t_tpu_torch.parallel import (
    EnsembleGibbs, gelman_rubin, initialize_distributed, make_hybrid_mesh,
    rhat_collective)

t0 = time.time()
ok = initialize_distributed(
    coordinator_address=f"127.0.0.1:{cfg['port']}",
    num_processes=cfg["nproc"], process_id=cfg["rank"],
    backend=cfg["backend"])
out = {"rank": cfg["rank"], "initialized": ok,
       "backend": dist.get_backend()}
if cfg["mode"] == "nccl":
    data = (np.random.default_rng(7).normal(size=(8, 50))
            + np.arange(8)[:, None])
    x = torch.as_tensor(data, dtype=torch.float32, device="cuda")
    out["rhat"] = rhat_collective(x)
    out["gelman_rubin"] = gelman_rubin(x.double().cpu().numpy().T)
else:
    from gibbs_student_t_tpu_torch.config import GibbsConfig
    from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
    dcn = cfg["dcn"]
    other = "chain" if dcn == "pulsar" else "pulsar"
    mesh = make_hybrid_mesh({other: 2}, {dcn: 2},
                            devices=[torch.device("cuda", 0)] * 2)
    mas = [make_demo_model_arrays(n=130 - (i % 3) * 10, components=30,
                                  seed=100 + i)
           for i in range(cfg["pulsars"])]
    c = GibbsConfig(model="mixture", vary_df=True,
                    theta_prior="beta").with_adapt(cfg["adapt"],
                                                   adapt_cov=True)
    ens = EnsembleGibbs(mas, c, nchains=cfg["chains"],
                        chunk_size=cfg["chunk"], record="full", mesh=mesh)
    t1 = time.time()
    res = ens.sample(cfg["sweeps"], seed=cfg["seed"])
    torch.cuda.synchronize()
    out["sample_s"] = time.time() - t1
    k = cfg["gate_sweep"] + 1
    np.savez(cfg["out"], chain=res.chain, bchain=res.bchain[:k],
             zchain=res.zchain[:k], thetachain=res.thetachain,
             dfchain=res.dfchain,
             **{k: res.stats[k] for k in ("pulsar_start", "pulsar_stop",
                                         "chain_start", "chain_stop")})
    group = mesh.group("chain", (0, 0)) if dcn == "chain" else None
    out["rhat"] = rhat_collective(res.chain[:, 0, :, 0].T, group=group)
    out["blocks"] = len(ens._blocks)
dist.destroy_process_group()
out["seconds"] = time.time() - t0
print(json.dumps(out), flush=True)
"""
# phase 24 (the north-star posterior gate on the card): the seed and the
# oracle's lengths of tools/tpu_gate.py (10,000 sweeps, burn 1,000, thin
# 20); the kernel's 1,000 sweeps, burn 500, thin 20, recorded every 10th
# sweep (its rows are then the gate's sweeps): from the reference's start
# (z = 1, alpha = 1, df = 4) mixture/beta's df and alpha reach their
# posterior on the flagship's pulsar only after ~500 sweeps, in the JAX
# package's kernel as in the port's (PERF.md §6, PR 25), where
# tpu_gate.py's 500 / 150 fails them; arm b (the flagship as the bench
# runs it) adapts for its first 100; arm d's ensemble (pulsars, chains a
# pulsar) and the pulsars gated against their own oracle; the pulsar of
# the ensemble's set on which arm a gates the uniform model (on the
# flagship's pulsar its posterior has two modes that the oracle stays
# in for ~800-2,000 sweeps at a time, so no 10,000-sweep oracle
# decides it: four oracle seeds put 36-83 % of their sweeps in the second
# mode; pulsar 0 has the flagship's n, m and Schur split); the oracle
# pool's size, the shortest a non-flagship oracle is cut to on a host with
# too few cores for one round, the longest the phase waits for the pool;
# the north-star timing's sweeps on each side
GATE_SEED, GATE_NP, GATE_J, GATE_THIN = 123, (10000, 1000, 20), (1000, 500,
                                                                20), 10
GATE_CHUNK, GATE_B_ADAPT, GATE_UNIFORM_PULSAR = 100, 100, 0
GATE_ENS_PULSARS, GATE_ENS_CHAINS, GATE_ENS_GATED = 8, 128, 2
GATE_POOL, GATE_NP_MIN, GATE_WAIT_S = 7, 4000, 600
NS_KERNEL_SWEEPS, NS_ORACLE_SWEEPS = 100, 300
# times of the first design of chol_fused (one 128-thread block per matrix),
# hyper_mh (one per chain) and tri_solve_T (one 32-thread block per
# system), ms per launch by (kernel, batch, size); of tnt_batched (16 x 16
# Gram tiles for 16 chains), by (kernel, chains, TOAs, m); and of tnt_lanes
# (the 64-chain pair product at 16 chains a block, then an unpack kernel),
# by (kernel, groups, TOAs, m); as this script measured them on an NVIDIA
# H100 80GB HBM3 at 700.00 W before the redesigns replaced them
FIRST_DESIGN_MS = {
    ("chol_fused", 4096, 60): 0.4920, ("chol_fused", 1024, 14): 0.01150,
    ("chol_fused", 256, 60): 0.08115, ("chol_fused", 64, 14): 0.009384,
    ("hyper_mh", 1024, 60): 2.181, ("hyper_mh", 64, 60): 0.9602,
    ("tnt_batched", 64, 102400, 74): 3.351,
    ("tri_solve_T", 1024, 60): 0.02697, ("tri_solve_T", 1024, 14): 0.007304,
    ("tri_solve_T", 64, 60): 0.02619, ("tri_solve_T", 64, 14): 0.006847,
    ("tri_solve_T", 8192, 60): 0.1735, ("tri_solve_T", 8192, 14): 0.01668,
    ("tnt_lanes", 64, 130, 74): 0.1503,
    # white_mh and white_mtm (a block per chain), by (kernel, chains, TOAs)
    ("white_mh", 1024, 130): 0.04089, ("white_mh", 64, 102400): 1.375,
    ("white_mh_grouped", 8192, 130): 0.2698,
    ("white_mh_lanes", 1024, 130): 0.04696,
    ("white_mtm", 1024, 130): 0.2502,
    ("white_mtm_grouped", 1024, 130): 0.2713,
    # sweep_draws (a thread a value, each gamma looping until it accepts),
    # by (kernel, chains, values a chain): flagship, stress, ens32, pool
    ("sweep_draws", 1024, 646): 0.01752, ("sweep_draws", 64, 307426): 0.6102,
    ("sweep_draws", 8192, 646): 0.1085, ("sweep_draws", 1024, 616): 0.01794}
# the redesigned kernels, reported beside their first design
REDESIGNED = ("chol_fused", "hyper_mh", "tnt_batched", "tri_solve_T",
              "tnt_lanes", "white_mh", "white_mh_grouped", "white_mh_lanes",
              "white_mtm", "white_mtm_grouped", "sweep_draws")
# the stream hold before a timed loop: 5e7 cycles, at least 25 ms below the
# H100's 1.98 GHz top SM clock
SLEEP_CYCLES, SLEEP_MS = 50_000_000, 25.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def profile_sweeps(torch, sampler, nsweeps: int) -> dict:
    """Device time by kernel over ``nsweeps`` steady-state sweeps of the
    flagship sampler (torch.profiler, CUDA activity), the wall time of the
    same window, and the device's idle share within it. The sweep indices
    are one device tensor made before the window, as ``TorchGibbs._run``
    makes a chunk's."""
    keys = sampler._chain_keys(3)
    sweeps = torch.arange(500, 503 + nsweeps, device=sampler.device)
    st = sampler.init_state(seed=3)
    for i in range(3):
        st = sampler._sweep(st, sampler._draw(keys, sweeps[i], st),
                            sweep=500 + i)
    torch.cuda.synchronize()
    box = [st, 3]

    def sweep():
        box[0] = sampler._sweep(box[0], sampler._draw(
            keys, sweeps[box[1]], box[0]), sweep=500 + box[1])
        box[1] += 1

    return profile_calls(torch, sweep, nsweeps)


def legacy_draw(torch, smp, gen, state):
    """One sweep's draws as the port made them before its draws were keyed
    per chain: every field from one ``torch.Generator`` (``torch.rand``,
    ``randn``, ``randint``, ``_standard_gamma``), at the state's batch
    shape, the same fields as ``TorchGibbs._draw``. Phase 14 times it
    beside the draw kernel; nothing in the port calls it."""
    cfg, mh = smp.config, smp.config.mh
    B, n, m, p = tuple(state.df.shape), smp._n, smp._ma.m, smp._ma.nparam
    dev, f32 = state.df.device, torch.float32

    def mh_draws(ind, nsteps, jump_scale, cov_chol):
        sigma = mh.sigma_per_param * len(ind) * jump_scale
        u = torch.rand((*B, nsteps), generator=gen, device=dev, dtype=f32)
        k = torch.searchsorted(smp._scale_cdf, u, right=True)
        step = sigma[..., None] * smp._scale_sizes[
            k.clamp_(max=len(mh.scale_sizes) - 1)]
        if cov_chol is None:
            pick = torch.randint(0, len(ind), (*B, nsteps), generator=gen,
                                 device=dev)
            jumps = torch.randn((*B, nsteps), generator=gen, device=dev,
                                dtype=f32) * step
            dx = torch.zeros((*B, nsteps, p), dtype=f32, device=dev)
            dx.scatter_(-1, ind[pick][..., None], jumps[..., None])
        else:
            xi = torch.randn((*B, nsteps, p), generator=gen, device=dev,
                             dtype=f32)
            dx = step[..., None] * torch.matmul(xi, cov_chol.transpose(-1,
                                                                       -2))
        logu = torch.log(torch.rand((*B, nsteps), generator=gen,
                                    device=dev, dtype=f32))
        return dx, logu

    def block(blk, ind, nsteps, jump_scale, cov_chol):
        if not smp._mtm[blk]:
            return mh_draws(ind, nsteps, jump_scale, cov_chol)
        K = mh.mtm_tries
        dx, _ = mh_draws(ind, nsteps * K, jump_scale, cov_chol)
        dxr, _ = mh_draws(ind, nsteps * (K - 1), jump_scale, cov_chol)
        u = torch.rand((*B, nsteps, K), generator=gen, device=dev, dtype=f32)
        logu = torch.log(torch.rand((*B, nsteps), generator=gen, device=dev,
                                    dtype=f32))
        return dx, dxr, -torch.log(-torch.log(u)), logu

    cov = state.mh_cov_chol if mh.adapt_cov else None
    scale = torch.exp(state.mh_log_scale)
    out = [block("white", smp._white_idx, mh.n_white_steps, scale[..., 0],
                 None if cov is None else cov[..., 0, :, :]),
           block("hyper", smp._hyper_idx, mh.n_hyper_steps, scale[..., 1],
                 None if cov is None else cov[..., 1, :, :])]
    out.append(torch.randn((*B, m), generator=gen, device=dev, dtype=f32))
    a, b = smp._theta_shapes(state.z)
    out.append(torch._standard_gamma(torch.stack([a, b], -1), generator=gen))
    out.append(torch.rand((*B, n), generator=gen, device=dev, dtype=f32))
    shape = torch.stack([state.df, state.df + 1.0], -1) / 2.0
    out.append(torch._standard_gamma(
        shape[..., None].expand(*B, 2, n).contiguous(), generator=gen))
    ug = torch.rand((*B, cfg.df_max), generator=gen, device=dev, dtype=f32)
    out.append(-torch.log(-torch.log(ug)))
    return out


def profile_calls(torch, fn, ncalls: int, cpu: bool = True) -> dict:
    """Device time by kernel over ``ncalls`` calls of ``fn`` (torch.profiler,
    CUDA activity, and with ``cpu`` the CPU ops too) and the wall time of
    the same window, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ncalls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    rows = []
    dev_total = 0.0
    launches = 0
    events = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, memcpy/memset): the CPU ops
        # that launched them carry the same device time again, and so do
        # the sweep's named spans (record_function), which the profiler
        # mirrors onto the device timeline
        if ev.device_type != DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False):
            continue
        events[ev.key] = events.get(ev.key, 0) + ev.count
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if dt <= 0:
            continue
        dev_total += dt
        launches += ev.count
        rows.append({"name": ev.key, "ms_per_sweep": dt / 1e3 / ncalls,
                     "calls_per_sweep": ev.count / ncalls})
    rows.sort(key=lambda r: -r["ms_per_sweep"])
    dev_ms = dev_total / 1e3 / ncalls
    return {"sweeps": ncalls, "wall_ms_per_sweep": wall * 1e3 / ncalls,
            "device_ms_per_sweep": dev_ms,
            "launches_per_sweep": launches / ncalls,
            # every device event by name, those timed at 0 included
            "device_events": events, "top": rows[:12]}


def stage_kernel_ms(events) -> dict:
    """From a Chrome trace's events (``torch.profiler`` with CPU and CUDA
    activity): the device ms of the kernels, copies and fills launched
    inside each ``stage/<name>`` annotation of ops/timers.py, each placed
    by the host time of the runtime call that launched it (matched by its
    correlation id) on the same thread; ``unattributed_ms`` is the rest."""
    ann, launch, dev = {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat == "user_annotation" and e.get("name", "").startswith(
                "stage/"):
            t0 = float(e["ts"])
            ann.setdefault(e.get("tid"), []).append(
                (t0, t0 + float(e.get("dur", 0.0)), e["name"][6:]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = (e.get("tid"), float(e["ts"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset") and (
                "correlation" in args):
            dev.append((args["correlation"], float(e.get("dur", 0.0))))
    every = sorted(a for v in ann.values() for a in v)
    for v in ann.values():
        v.sort()
    starts = {t: [a[0] for a in v] for t, v in ann.items()}
    starts_all = [a[0] for a in every]
    ms, n, other = {}, {}, 0.0
    for corr, dur in dev:
        stage = None
        if corr in launch:
            tid, ts = launch[corr]
            lst, st = ann.get(tid), starts.get(tid)
            if not lst:
                lst, st = every, starts_all
            k = bisect.bisect_right(st, ts) - 1
            if k >= 0 and lst[k][0] <= ts <= lst[k][1]:
                stage = lst[k][2]
        if stage is None:
            other += dur / 1e3
        else:
            ms[stage] = ms.get(stage, 0.0) + dur / 1e3
            n[stage] = n.get(stage, 0) + 1
    return {"ms": ms, "launches": n, "unattributed_ms": other,
            "device_events": len(dev), "annotations": len(every)}


def profile_counts(torch, fn) -> dict:
    """Device events by name of one call of ``fn`` (torch.profiler, CUDA
    activity), counted in the profiler's active step after a warm-up step
    that runs ``fn`` too: kernels launched just as a capture starts can be
    missing from its first step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    out = {}

    def ready(prof):
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and not getattr(
                    ev, "is_user_annotation", False):
                out[ev.key] = out.get(ev.key, 0) + ev.count

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return out


def profile_stages(torch, fn, trace_dir: str, warmup, between=None) -> dict:
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activity; the
    stage timers' flag must be up, so that their brackets annotate the
    trace) in the active step, after a warm-up step that runs ``warmup()``
    (kernels launched just as a capture starts can be missing from it) and
    then ``between()``; export the active step's Chrome trace into
    ``trace_dir`` and read it with :func:`stage_kernel_ms` (the trace is
    removed after)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    path = os.path.join(trace_dir, f"stages_{time.time_ns()}.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        warmup()
        torch.cuda.synchronize()
        prof.step()
        if between is not None:
            between()
        fn()
        torch.cuda.synchronize()
        prof.step()
    try:
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.remove(path)
    return stage_kernel_ms(doc["traceEvents"] if isinstance(doc, dict)
                           else doc)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs only on a GPU")
    sys.path.insert(0, HERE)
    try:
        from gibbs_student_t_tpu_torch.backends import torch_backend as tb
        from gibbs_student_t_tpu_torch.config import GibbsConfig
        from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
        from gibbs_student_t_tpu_torch.ops import _cuda, chol, hyper_mh, linalg
        from gibbs_student_t_tpu_torch.ops import rng, tnt, white_mh
        from gibbs_student_t_tpu_torch.parallel.diagnostics import (
            effective_sample_size,
        )
        from gibbs_student_t_tpu_torch.serve import pool as serve_pool
        from gibbs_student_t_tpu_torch.testing import (
            separate_mtm_ties,
            separate_ties,
        )
        from tools.torch_kernel_ab import (
            draw_floor,
            draw_instructions,
        )
        from tools.torch_kernel_ab import draw_work as draw_counts
    except ImportError as exc:
        fail(f"the port's package is not importable here: {exc}")

    import numpy as np

    dev = torch.device("cuda")
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        fail(f"nvidia-smi did not report the card: {exc!r}")
    report = {"card": card, "kind": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"# card: {report['card']} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # --- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    try:
        _cuda.build(force=True)
        _cuda.lib()
    except Exception as exc:  # noqa: BLE001
        fail(f"kernel build failed: {exc}")
    report["build_s"] = time.perf_counter() - t0
    print(f"# build: libgst_cuda.so in {report['build_s']:.2f} s", flush=True)
    for line in _cuda.ptxas_report.splitlines():
        if "Used" in line or "spill" in line:
            print(f"# ptxas: {line.strip()}")

    wrappers = {"chol_fused": (linalg, "chol_fused", chol.chol_fused),
                "tri_solve_T": (linalg, "tri_solve_T", chol.tri_solve_T),
                "white_mh": (tb, "white_mh", white_mh.white_mh),
                "hyper_mh": (tb, "hyper_mh", hyper_mh.hyper_mh),
                "tnt_batched": (tb, "tnt_batched", tnt.tnt_batched),
                "white_mtm": (tb, "white_mtm", white_mh.white_mtm)}
    plains = {"chol_fused": chol.chol_fused_plain,
              "tri_solve_T": chol.tri_solve_T_plain,
              "white_mh": white_mh.white_mh_loop,
              "hyper_mh": hyper_mh.hyper_mh_loop,
              "tnt_batched": tnt.tnt_products,
              "white_mtm": white_mh.white_mtm_loop}
    for name, base in GROUPED.items():
        wrappers[name] = wrappers[base]
        plains[name] = plains[base]
    # the lanes entries: the pool's sweep calls them from serve/pool.py
    for name, mod in (("tnt_lanes", tnt), ("white_mh_lanes", white_mh),
                      ("hyper_mh_lanes", hyper_mh)):
        wrappers[name] = (serve_pool, name, getattr(mod, name))
        plains[name] = getattr(mod, name + "_plain")
    for name in ("chol_fused_lanes", "tri_solve_T_lanes"):
        wrappers[name] = (chol, name, getattr(chol, name))
    plains["chol_fused_lanes"] = lambda S, r, gid: chol.chol_fused_plain(S, r)
    plains["tri_solve_T_lanes"] = lambda L, r, gid: chol.tri_solve_T_plain(
        L, r)
    wrappers[DRAWS] = (tb, DRAWS, rng.sweep_draws)
    plains[DRAWS] = rng.sweep_draws_plain
    # the float64 forms: the same wrappers and plain versions
    for name, (base, *_) in F64_KERNELS.items():
        wrappers[name] = wrappers[base]
        plains[name] = plains[base]

    def counter(name):
        """(object, attribute) of kernel ``name``'s launch count."""
        if name in F64_KERNELS:
            base = F64_KERNELS[name][0]
            return (wrappers[name][2], ("launches_grouped_f64"
                                        if base in GROUPED
                                        else "launches_f64"))
        if name in GROUPED:
            return wrappers[name][2], "launches_grouped"
        if name in LANES:
            return wrappers[LANES[name]][2], "launches_lanes"
        return wrappers[name][2], "launches"

    def count(name):
        """Launches of kernel ``name`` since reset_counts()."""
        return getattr(*counter(name))

    def reset_counts():
        for name in wrappers:
            setattr(*counter(name), 0)

    launches_by_path = {}

    def check_launches(path, sweeps, chunks):
        """Every kernel's count since reset_counts() against its launches
        per sweep on ``path`` x sweeps plus its launches per chunk x
        chunks (the telemetry's chunk-end log-posterior)."""
        counts = {n: count(n) for n in wrappers}
        launches_by_path[path] = counts
        base = SAME_AS.get(path, path)
        for name, meta in KERNELS.items():
            per_sweep = meta["per_sweep"][base]
            per_chunk = meta.get("per_chunk", {}).get(base, 0)
            want = per_sweep * sweeps + per_chunk * chunks
            if counts[name] != want:
                fail(f"{name} launched {counts[name]} times in the {path} "
                     f"run, expected {per_sweep} x {sweeps} sweeps + "
                     f"{per_chunk} x {chunks} chunks = {want}")
        return counts

    def chunks_of(smp, *niters):
        """Chunks of ``smp.sample`` calls of ``niters`` sweeps each."""
        return sum(-(-n // smp.chunk_size) for n in niters)

    def capture(names, run):
        """Run ``run()`` with the named kernels' wrappers replaced by
        recorders; returns {(name, shape of the first operand): operands
        of the last call of that shape}. A call with a grouped first
        operand (pulsars x chains) is the grouped kernel's."""
        got = {}

        def recorder(fn):
            def rec(*args, **kw):
                name = fn.__name__
                if name + "_grouped" in GROUPED and args[0].dim() == 3:
                    name += "_grouped"
                if name in names:
                    got[(name, tuple(args[0].shape))] = tuple(
                        a.clone() if torch.is_tensor(a) else a for a in args)
                return fn(*args, **kw)
            return rec

        targets = {wrappers[name][:2]: wrappers[name][2] for name in names}
        for (mod, attr), fn in targets.items():
            setattr(mod, attr, recorder(fn))
        try:
            run()
            torch.cuda.synchronize()
        finally:
            for (mod, attr), fn in targets.items():
                setattr(mod, attr, fn)
        return got

    # --- the flagship model ----------------------------------------------
    ma = make_demo_model_arrays()
    cfg = GibbsConfig(model="mixture", vary_df=True,
                      theta_prior="beta").with_adapt(ADAPT, adapt_cov=True)
    # record="full": phase 5 holds the recorded b finite
    sampler = tb.TorchGibbs(ma, cfg, nchains=NCHAINS, device=dev,
                            record="full")
    print(f"# flagship: n={ma.n} m={ma.m} p={ma.nparam} chains={NCHAINS} "
          f"schur={len(sampler._schur[0])}+{len(sampler._schur[1])}",
          flush=True)

    # --- 3. capture the kernels' inputs from the main path, then parity ---
    def keyed(smp, seed, nsweeps):
        """``(keys, sweeps)``: the chain keys of ``smp``'s run ``seed`` and
        sweep indices 0 .. nsweeps - 1 on the device (``TorchGibbs._run``'s
        draw operands)."""
        return (smp._chain_keys(seed),
                torch.arange(nsweeps, device=smp.device))

    def run_capture(smp, seed, sweeps):
        def run():
            keys, sw = keyed(smp, seed, sweeps)
            st = smp.init_state(seed=seed)
            if smp.config.mh.adapt_cov:
                st = smp._prop_cov_update(st)
            for i in range(sweeps):
                st = smp._sweep(st, smp._draw(keys, sw[i], st), sweep=i)
        return run

    # the draw kernel's operands of each path, for phase 14
    draw_args = {}

    def split_draws(capt, path):
        """``capt`` without the draw kernel's operands, which go to
        ``draw_args[path]`` (phase 14 holds the kernel to its plain
        version)."""
        for k in [k for k in capt if k[0] == DRAWS]:
            draw_args[path] = capt.pop(k)
        if path not in draw_args:
            fail(f"the {path} sweep did not reach the draw kernel")
        return capt

    # the last sweep's operands of each call shape are kept
    captured = split_draws(capture(wrappers, run_capture(sampler, 7, 5)),
                           "flagship")
    shapes = sorted(k for k in captured)
    print(f"# captured kernel inputs: {shapes}", flush=True)
    for name, meta in KERNELS.items():
        if (meta["per_sweep"]["flagship"] and name != DRAWS
                and not any(k[0] == name for k in captured)):
            fail(f"{name} was not reached by the sweep")

    def rel_err(a, b):
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        both = fa & fb
        mism = int((fa != fb).sum())
        if not both.any():
            return 0.0, 0.0, mism
        d = (a - b).abs()[both]
        return (float(d.max()), float((d / (1.0 + b.abs()[both])).max()),
                mism)

    def mh_steps(name, args):
        """The MH steps S of an MH block's operands."""
        if name.startswith("hyper_mh"):
            return args[5].shape[-2]
        return args[3].shape[-3 if name.startswith("white_mtm") else -2]

    def mh_parity(name, args, **kw):
        """Kernel, plain version and the float64 plain version of an MH
        block on the same operands: outputs and per-chain accept counts.
        ``kw`` goes to the kernel's wrapper only."""
        out_k = wrappers[name][2](*args, **kw)
        out_p = plains[name](*args)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(out_k, out_p)]
        rec = {"shape": list(args[0].shape),
               "max_abs_err": max(e[0] for e in errs),
               "max_rel_err": max(e[1] for e in errs),
               "nonfinite_mismatch": sum(e[2] for e in errs)}
        acc_k, acc_p = out_k[1], out_p[1]
        steps = mh_steps(name, args)
        # the float64 plain version is the referee for decisions the
        # float32 likelihood cannot resolve (near-ties, ill-conditioned
        # proposals)
        args64 = tuple(a.double() if torch.is_tensor(a) else a
                       for a in args)
        x_64, acc_64 = plains[name](*args64)
        # per-chain accept counts (rates x steps, rounded: a rate is
        # count / steps, and torch may divide by multiplying with 1/steps)
        n_k, n_p, n_64 = (torch.round(a.double() * steps).long()
                          for a in (acc_k, acc_p, acc_64))
        rec["accepts_kernel"] = int(n_k.sum())
        rec["accepts_plain"] = int(n_p.sum())
        rec["accepts_f64"] = int(n_64.sum())
        rec["chains_acc_mismatch"] = int((n_k != n_p).sum())
        rec["chains_kernel_vs_f64"] = int((n_k != n_64).sum())
        rec["chains_plain_vs_f64"] = int((n_p != n_64).sum())
        agree = n_k == n_64
        rec["x_max_rel_err_vs_f64"] = rel_err(
            out_k[0][agree], x_64[agree].float())[1]
        # tolerance: the kernel's float32 decisions depart from the
        # float64 referee on no more chains than the plain float32
        # version's do (0 of 1024 at the flagship inputs in every
        # reading so far), and x of every chain whose count agrees with
        # the referee's matches the referee's x to 1e-4 relative
        rec["ok"] = bool(
            rec["chains_kernel_vs_f64"] <= rec["chains_plain_vs_f64"]
            and rec["x_max_rel_err_vs_f64"] <= 1e-4)
        return rec

    parity = {}
    for (name, shape), args in sorted(captured.items()):
        if name in ("white_mh", "hyper_mh"):
            rec = mh_parity(name, args)
            ok = rec["ok"]
        else:
            out_k = wrappers[name][2](*args)
            out_p = plains[name](*args)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(out_k, out_p)]
            rec = {"shape": list(shape),
                   "max_abs_err": max(e[0] for e in errs),
                   "max_rel_err": max(e[1] for e in errs),
                   "nonfinite_mismatch": sum(e[2] for e in errs)}
            # tolerance: 1e-3 relative (|a-b| / (1+|b|)) on every output;
            # non-finite pattern (failed pivots) identical
            ok = rec["max_rel_err"] <= 1e-3 and rec["nonfinite_mismatch"] == 0
            rec["ok"] = bool(ok)
        parity.setdefault(name, []).append(rec)
        print(f"# parity {name} {list(shape)}: {json.dumps(rec)}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version at {shape}")
    report["parity"] = parity

    # --- 3b. the launch forms the flagship does not take --------------------
    # 64 chains (the warp form at one matrix per block), m = v = 160 (the
    # block form; demo pulsar with 80 Fourier components), and an odd size
    # (4-byte copies): the leading 15 x 15 block of the 64-chain operands
    small = tb.TorchGibbs(ma, cfg, nchains=64, device=dev)
    small_cpu = tb.TorchGibbs(ma, cfg, nchains=64, device="cpu")
    ma_w = make_demo_model_arrays(components=80)
    wide = tb.TorchGibbs(ma_w, cfg, nchains=64, device=dev)
    forms = ("chol_fused", "hyper_mh")
    captured_f = {(n, "64 chains", shp): a for (n, shp), a in capture(
        forms, run_capture(small, 5, 3)).items()}
    captured_f.update({(n, "m=160", shp): a for (n, shp), a in capture(
        forms, run_capture(wide, 5, 3)).items()})
    (hargs,) = (a for k, a in captured_f.items()
                if k[:2] == ("hyper_mh", "64 chains"))
    odd = 15
    captured_f[("hyper_mh", "odd", (64, odd))] = (
        hargs[0], hargs[1][:, :odd, :odd].contiguous(),
        *(t[:, :odd].contiguous() for t in hargs[2:4]), *hargs[4:7],
        hargs[7][:, :odd].contiguous(), hargs[8][:odd].contiguous(),
        *hargs[9:])
    S15 = torch.cat([a[0].reshape(-1, 60, 60)[:, :odd, :odd]
                     for k, a in captured.items()
                     if k[0] == "chol_fused" and k[1][-1] == 60])
    isd15 = torch.rsqrt(torch.diagonal(S15, dim1=-2, dim2=-1))
    captured_f[("chol_fused", "odd", tuple(S15.shape))] = (
        (S15 * isd15[:, :, None] * isd15[:, None, :]).contiguous(),
        torch.ones_like(isd15))
    seen = set()
    for key, args in sorted(captured_f.items(), key=lambda kv: kv[0][:2]):
        name = key[0]
        m_ = args[0 if name == "chol_fused" else 1].shape[-1]
        # each kernel's own warp bound: the factor's three rows a lane,
        # the hyper kernel's 64
        warp_max = (chol.WARP_MAX_DIM if name == "chol_fused"
                    else hyper_mh.HYPER_WARP_MAX_V)
        want = ("block" if m_ > warp_max else "warp")
        form = (chol.launch_form(args[0].numel() // (m_ * m_), m_)
                if name == "chol_fused"
                else hyper_mh.launch_form(args[0].shape[0], m_))
        if form[0] != want:
            fail(f"{name} at {key[1:]} (size {m_}) takes the {form[0]} form")
        seen.add((name, key[1]))
        if name == "hyper_mh":
            rec = mh_parity(name, args)
        else:
            out_k = chol.chol_fused(*args)
            out_p = chol.chol_fused_plain(*args)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(out_k, out_p)]
            rec = {"max_abs_err": max(e[0] for e in errs),
                   "max_rel_err": max(e[1] for e in errs),
                   "nonfinite_mismatch": sum(e[2] for e in errs)}
            # tolerance as in phase 3
            rec["ok"] = bool(rec["max_rel_err"] <= 1e-3
                             and rec["nonfinite_mismatch"] == 0)
        rec["form"] = list(form)
        rec["shape"] = [key[1], *key[2]]
        parity.setdefault(name, []).append(rec)
        print(f"# parity {name} {rec['shape']}: {json.dumps(rec)}",
              flush=True)
        if not rec["ok"]:
            fail(f"{name} disagrees with its plain version at {key[1:]}")
    if seen != {(n, f) for n in forms for f in ("64 chains", "m=160", "odd")}:
        fail(f"the other launch forms reached only {sorted(seen)}")

    # failed factorizations among good ones, several matrices a block: a
    # negative first pivot, a negative pivot deeper in, and a zero last
    # pivot give a non-finite logdet (NaN for the first two) for their own
    # matrix only; every other matrix comes out bit for bit as it does in
    # the batch without failures
    (cargs,) = (a for k, a in captured.items()
                if k[0] == "chol_fused" and k[1][-1] == 60)
    S_ok = cargs[0].reshape(-1, 60, 60)
    r_ok = cargs[1].reshape(-1, 60)
    S_bad = S_ok.clone()
    bad = [5, 1030, 2047]
    S_bad[5] = -S_bad[5]
    S_bad[1030, 40, 40] = -1.0
    S_bad[1030, 40, :40] = 0.0
    S_bad[1030, :40, 40] = 0.0
    S_bad[2047, 59, 59] = 0.0
    S_bad[2047, 59, :59] = 0.0
    S_bad[2047, :59, 59] = 0.0
    good = torch.ones(S_ok.shape[0], dtype=torch.bool, device=dev)
    good[bad] = False
    out_b = chol.chol_fused(S_bad, r_ok)
    out_g = chol.chol_fused(S_ok, r_ok)
    torch.cuda.synchronize()
    nan_rec = {
        "batch": list(S_bad.shape), "failed": bad,
        "form": list(chol.launch_form(S_bad.shape[0], 60)),
        "failed_logdet": [float(v) for v in out_b[1][bad]],
        "others_finite": bool(all(torch.isfinite(t[good]).all()
                                  for t in out_b)),
        "others_bitwise_equal": bool(all(torch.equal(a[good], b[good])
                                         for a, b in zip(out_b, out_g)))}
    nan_rec["ok"] = bool(
        torch.isnan(out_b[1][bad[:2]]).all()
        and not torch.isfinite(out_b[1][bad]).any()
        and nan_rec["others_finite"] and nan_rec["others_bitwise_equal"])
    report["failed_pivots"] = nan_rec
    print(f"# failed pivots among good matrices: {json.dumps(nan_rec)}",
          flush=True)
    if not nan_rec["ok"]:
        fail("a failed factorization leaked out of its own matrix")
    del S_bad, out_b, out_g, wide

    # --- 4. one sweep on the card vs the same sweep on the CPU -----------
    keys, sw = keyed(small, 11, 4)
    st = small._prop_cov_update(small.init_state(seed=11))
    for i in range(3):
        st = small._sweep(st, small._draw(keys, sw[i], st), sweep=i)
    dr = small._draw(keys, sw[3], st)

    def to_cpu(t):
        return t.detach().cpu()

    def card_vs_cpu(gpu, cpu, st, dr, sweep):
        """One sweep of ``gpu`` (kernels) and of its CPU twin (plain
        versions) from the same state and draws: x and b relative errors
        and the number of chains whose accept counts differ."""
        out_g = gpu._sweep(st, dr, sweep=sweep)
        out_c = cpu._sweep(type(st)(*map(to_cpu, st)),
                           type(dr)(*map(to_cpu, dr)), sweep=sweep)
        nw, nh = gpu.config.mh.n_white_steps, gpu.config.mh.n_hyper_steps
        agree = ((torch.round(to_cpu(out_g.acc_white) * nw)
                  == torch.round(out_c.acc_white * nw))
                 & (torch.round(to_cpu(out_g.acc_hyper) * nh)
                    == torch.round(out_c.acc_hyper * nh)))
        cmp = {f: rel_err(to_cpu(getattr(out_g, f)), getattr(out_c, f))[:2]
               for f in ("x", "b")}
        cmp["chains_acc_mismatch"] = int((~agree).sum())
        return cmp

    sweep_cmp = card_vs_cpu(small, small_cpu, st, dr, 3)
    print(f"# sweep card-vs-cpu (64 chains): {json.dumps(sweep_cmp)}",
          flush=True)
    report["sweep_card_vs_cpu"] = sweep_cmp
    # tolerance: every chain's accept counts equal (0 of 64 differed in
    # every reading so far); x of every chain to 1e-4 relative, b (drawn
    # through the chol kernels vs their plain versions on the CPU) to 1e-3
    if (sweep_cmp["chains_acc_mismatch"] > 0 or sweep_cmp["x"][1] > 1e-4
            or sweep_cmp["b"][1] > 1e-3):
        fail("one sweep on the card disagrees with the same sweep on the CPU")

    # --- 5. the flagship run ----------------------------------------------
    # adaptation (100 sweeps) then 200 timed sweeps, as bench.py times the
    # JAX sampler: the metrics come from the steady post-adaptation window
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sampler.sample(niter=ADAPT, seed=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = sampler.sample(niter=MORE, seed=1, state=sampler.last_state,
                         start_sweep=ADAPT)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    niter = ADAPT + MORE
    launches = check_launches("flagship", niter,
                              chunks_of(sampler, ADAPT, MORE))
    st = sampler.last_state
    # phase 22 runs the flagship on from here
    flagship_state = type(st)(*(t.clone() for t in st))
    finite = torch.ones(NCHAINS, dtype=torch.bool, device=dev)
    for f in ("x", "b", "alpha", "theta", "df"):
        v = getattr(st, f)
        finite &= torch.isfinite(v.reshape(NCHAINS, -1)).all(-1)
    share_finite = float(finite.float().mean())
    ia = [i for i, nm in enumerate(ma.param_names) if "log10_A" in nm][0]
    ess_a = effective_sample_size(res.chain[..., ia])
    run = {"sweeps": niter, "adapt_wall_s": t1 - t0, "timed_sweeps": MORE,
           "timed_wall_s": t2 - t1,
           "chain_sweeps_per_s": NCHAINS * MORE / (t2 - t1),
           "ess_log10A": ess_a, "ess_log10A_per_s": ess_a / (t2 - t1),
           "acc_white": float(res.stats["acc_white"].mean()),
           "acc_hyper": float(res.stats["acc_hyper"].mean()),
           "theta_mean": float(res.thetachain.mean()),
           "param_means": dict(zip(ma.param_names,
                                   map(float, res.chain.mean((0, 1))))),
           "share_finite": share_finite,
           "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "records_finite": bool(np.isfinite(res.chain).all()
                                  and np.isfinite(res.bchain).all()),
           "launches": launches}
    print(f"# flagship run: {json.dumps(run)}", flush=True)
    report["run"] = run
    if share_finite != 1.0 or not run["records_finite"]:
        fail(f"non-finite chains after the run (finite share {share_finite})")
    if res.chain.shape != (MORE, NCHAINS, ma.nparam):
        fail(f"unexpected chain shape {res.chain.shape}")
    if not 0.0 < run["theta_mean"] < 0.5:
        fail(f"theta mean {run['theta_mean']} outside (0, 0.5)")

    # --- 6. timings at the flagship shapes --------------------------------
    def timed(fn, args, reps, queue_ahead=True):
        """Milliseconds per call of ``fn(*args)``: CUDA events around
        ``reps`` back-to-back calls. With ``queue_ahead`` a sleep kernel
        holds the stream while the host enqueues the calls, so the events
        bracket device work only and not the host's launch overhead (a
        30 us kernel is otherwise timed at the host's launch rate). The
        plain versions, launch-bound by nature, are timed without it."""
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        h0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        e1.record()
        enqueue_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        if queue_ahead and enqueue_ms > SLEEP_MS:
            # the hold ended before the host had enqueued every call (a
            # call that synchronises): the time then includes launch gaps
            print(f"# timing note: {getattr(fn, '__name__', fn)} took "
                  f"{enqueue_ms:.1f} ms to enqueue {reps} calls, past the "
                  f"{SLEEP_MS} ms hold", flush=True)
        return ms / reps

    def work(name, args):
        """(bytes moved, float32 operations) of one call: each input read
        once, each output written once; operations counted from shapes.
        A symmetric or triangular input counts its lower triangle only
        (m(m+1)/2 floats): that is all the function reads of S, L and S0.
        chol_fused's L is counted in full, zeros above the diagonal
        included: the output is the dense factor, which its callers read
        as a dense matrix (the robust draw's finiteness test, the products
        of the b draw)."""
        f4 = 4
        if name == "chol_fused":
            S = args[0]
            m = S.shape[-1]
            B = S.numel() // (m * m)
            tri = m * (m + 1) // 2
            return (f4 * (B * tri + B * m * m + 2 * B * m + B),
                    B * (m ** 3 / 3 + m * m))
        if name == "tri_solve_T":
            L = args[0]
            m = L.shape[-1]
            B = L.numel() // (m * m)
            tri = m * (m + 1) // 2
            return f4 * (B * tri + 2 * B * m), B * m * m
        if name.startswith(("white_mh", "white_mtm")):
            # white_mtm: x, az, y2, dx, dxr, gumb, logu, rows, specs, var;
            # 1 + S (2K - 1) likelihood evaluations. Grouped: every
            # group's constant rows are read once
            x, az, var = args[0], args[1], args[-1]
            p = x.shape[-1]
            C = x.numel() // p
            n, S = az.shape[-1], mh_steps(name, args)
            evals = 1 + S * (2 * args[3].shape[-2] - 1
                             if name.startswith("white_mtm") else 1)
            byts = f4 * (sum(t.numel() for t in args[:-1]) + C * p + C)
            return byts, C * evals * n * (10 + 2 * len(var))
        if name == "tnt_batched":
            # T, y, nvec in; TNT (dense), d, const out; the lower triangle
            # and d: C n (m (m + 1) / 2 + m) multiply-adds
            T, nvec = args[0], args[2]
            (n, m), C = T.shape, nvec.shape[0]
            byts = f4 * (n * m + n + C * n + C * m * m + C * m + C)
            return byts, 2 * C * n * (m * (m + 1) // 2 + m)
        if name == "tnt_lanes":
            # each group's basis (its n real TOAs) and y read once, the
            # lanes' nvec and gid; TNT (dense), d, const out
            T, nvec = args[0], args[2]
            G_, C_, n = nvec.shape
            m, B_ = T.shape[-1], G_ * C_
            byts = f4 * (G_ * n * m + G_ * n + B_ * n + B_ + B_ * m * m
                         + B_ * m + B_)
            return byts, 2 * B_ * n * (m * (m + 1) // 2 + m)
        if name in LANES:
            # the grouped block on each tile's constants, and the gid
            byts, flops = work(LANES[name] + "_grouped",
                               lanes_grouped(name, args))
            return byts + f4 * args[-3 if name.startswith("hyper")
                                    else -2].numel(), flops
        if name in ("chol_fused_lanes", "tri_solve_T_lanes"):
            byts, flops = work(name[:-6], args[:2])
            return byts + f4 * args[2].numel(), flops
        if name.startswith("hyper_mh"):
            x, S0 = args[0], args[1]
            v = S0.shape[-1]
            C = S0.numel() // (v * v)
            S = mh_steps(name, args)
            byts = f4 * (sum(t.numel() for t in args[:10]) - C * v * v
                         + C * v * (v + 1) // 2 + C * x.shape[-1] + C)
            return byts, C * (S + 1) * (v ** 3 / 3 + 4 * v * v)
        raise KeyError(name)

    def library(name, args):
        """(fn, its operands) of one PyTorch call computing the same
        function, or None."""
        if name == "chol_fused":
            return (lambda S, r: torch.linalg.cholesky_ex(S)), args[:2]
        if name == "tri_solve_T":
            return (lambda L, r: torch.linalg.solve_triangular(
                L.transpose(-1, -2), r[..., None], upper=True)), args[:2]
        if name == "tnt_batched":
            # the batched product with the weighted basis materialised
            T, w = args[0], 1.0 / args[2]
            return (lambda T, w: torch.matmul(T.T, w[..., None] * T)), (T, w)
        if name == "tnt_lanes":
            # the ensemble's dense product: one matmul per basis, the
            # group's weighted basis materialised with its chains as rows
            T_l, nv = args[0], args[2]
            G_, C_, n = nv.shape
            Tg = T_l[:, 0, :n].contiguous()
            TwT = (Tg.transpose(-1, -2)[:, None] * (1.0 / nv)[..., None, :]
                   ).reshape(G_, C_ * Tg.shape[-1], n)
            return torch.matmul, (TwT, Tg)
        if name in ("chol_fused_lanes", "tri_solve_T_lanes"):
            return library(name[:-6], args)
        return None

    timing = {}
    other_forms = report["other_forms"] = {}

    def batch_size(name, args):
        """(batch, matrix size) of a factor, back-solve or hyper-block
        call."""
        mat = args[1 if name == "hyper_mh" else 0]
        m_ = mat.shape[-1]
        return mat.numel() // (m_ * m_), m_

    def ungrouped(name, args):
        """A grouped MH block's operands as one single-model launch on the
        same total number of chains: the per-chain operands with their
        (pulsar, chain) axes folded, the constants of the first pulsar."""
        k = {"white_mh_grouped": 5, "white_mtm_grouped": 7,
             "hyper_mh_grouped": 7}[name]
        nconst = 3 if name == "hyper_mh_grouped" else 2
        return (*(t.reshape(-1, *t.shape[2:]) for t in args[:k]),
                *(t[0] for t in args[k:k + nconst]), *args[k + nconst:])

    def time_captured(capt, path, into=timing):
        """Kernel, plain and library times and the bound of every captured
        call shape, into ``into`` (``timing``: the shapes the paths
        launch). The factor and the hyper block also get the first
        design's time at the same shape, where this script measured one,
        and their time at every matrices-per-block count (0: a block per
        matrix); a grouped kernel gets the time of the same kernel
        launched ungrouped on the same number of chains."""
        for (name, shape), args in sorted(capt.items(),
                                          key=lambda kv: kv[0]):
            byts, flops = work(name, args)
            bound = max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
            lib = library(name, args)
            extra = {}
            if name == "tnt_batched":
                T, nvec = args[0], args[2]
                extra = {"first_design_ms": FIRST_DESIGN_MS.get(
                    (name, nvec.shape[0], *T.shape))}
            elif name == "tri_solve_T":
                extra = {"first_design_ms": FIRST_DESIGN_MS.get(
                    (name, *batch_size(name, args)))}
            elif name == "tnt_lanes":
                T_l, nv_l = args[0], args[2]
                extra = {
                    "first_design_ms": FIRST_DESIGN_MS.get(
                        (name, nv_l.shape[0], nv_l.shape[-1],
                         T_l.shape[-1])),
                    "form": tnt.lanes_form(nv_l.shape[0], T_l.shape[-1])}
            elif name in ("chol_fused", "hyper_mh"):
                Bm = batch_size(name, args)
                fn = wrappers[name][2]
                mod = chol if name == "chol_fused" else hyper_mh
                extra = {
                    "first_design_ms": FIRST_DESIGN_MS.get((name, *Bm)),
                    "form": list(mod.launch_form(*Bm)),
                    "ms_by_per_block": {
                        str(pb): timed(
                            lambda *a, pb=pb: fn(*a, per_block=pb), args, 20)
                        for pb in ((1, 2, 4, 8, 0)
                                   if Bm[1] <= (chol.WARP_MAX_DIM
                                                if name == "chol_fused"
                                                else hyper_mh.HYPER_WARP_MAX_V)
                                   else ())}}
            elif name in GROUPED:
                extra = {"ungrouped_ms": timed(wrappers[name][2],
                                               ungrouped(name, args), 50)}
            elif name in LANES:
                extra = {"ensemble_form_ms": timed(
                    wrappers[LANES[name]][2], ensemble_form(name, args), 50)}
            if name.startswith("white"):
                x_, n_ = args[0], args[1].shape[-1]
                chains = x_.numel() // x_.shape[-1]
                extra["first_design_ms"] = FIRST_DESIGN_MS.get(
                    (name, chains, n_))
                extra["form"] = list(white_mh.white_form(n_, x_.shape[-1]))
            row = dict(
                path=path, shape=list(shape), **extra,
                ms=timed(wrappers[name][2], args, 50),
                plain_ms=timed(plains[name], args, 3, queue_ahead=False),
                library_ms=timed(lib[0], lib[1], 50) if lib else None,
                bound_ms=bound,
                bound_by="bytes" if byts / HBM_BYTES_PER_S
                >= flops / FP32_FLOPS else "operations",
                bytes=byts, flops=flops)
            into.setdefault(name, []).append(row)
            print(f"# time {name} {list(shape)}: {json.dumps(row)}",
                  flush=True)

    time_captured(captured, "flagship")
    # the factor and the hyper block in their other launch forms (on no
    # path of this script, so not in the kernels line)
    time_captured({(k[0], (k[1], *k[2])): a for k, a in captured_f.items()
                   if k[1] != "odd"}, "other forms", into=other_forms)
    del captured_f

    # --- 7. where a flagship sweep's time goes (profiler) -----------------
    def profile(path, smp, nsweeps, wall_ms):
        """profile_sweeps on ``smp``, fatal when it sees no device time;
        the idle share is taken against ``wall_ms``, the unprofiled wall
        per sweep of the path's run (the profiler's own host overhead
        stretches the profiled wall)."""
        try:
            prof = profile_sweeps(torch, smp, nsweeps)
        except Exception as exc:  # noqa: BLE001
            fail(f"the profiler did not trace the {path} sweeps: {exc!r}")
        if prof["device_ms_per_sweep"] <= 0 or prof["launches_per_sweep"] <= 0:
            fail(f"the profiler saw no device time in the {path} sweeps")
        prof["idle_share"] = max(0.0, 1.0 - prof["device_ms_per_sweep"]
                                 / wall_ms)
        chains = " x ".join(map(str, smp._batch))
        print(f"# profile {path} ({prof['sweeps']} sweeps, {chains} "
              f"chains): device busy {prof['device_ms_per_sweep']:.4f} "
              f"ms/sweep, {prof['launches_per_sweep']:.1f} launches/sweep; "
              f"wall {wall_ms:.4f} ms/sweep unprofiled "
              f"({prof['wall_ms_per_sweep']:.4f} profiled); idle share "
              f"{prof['idle_share']:.4f}")
        for row in prof["top"]:
            print(f"#   {row['ms_per_sweep']:8.4f} ms/sweep "
                  f"{row['calls_per_sweep']:6.1f} calls  {row['name'][:90]}")
        return prof

    report["profile"] = profile("flagship", sampler, 20,
                                1e3 * run["timed_wall_s"] / MORE)

    # --- 8. the 1e5-TOA stress path ---------------------------------------
    t0 = time.perf_counter()
    ma_s = make_demo_model_arrays(n=STRESS_N, components=30)
    cfg_s = GibbsConfig(model="mixture", vary_df=True, theta_prior="beta")
    stress = tb.TorchGibbs(ma_s, cfg_s, nchains=STRESS_CHAINS, device=dev,
                           record="light")
    stress_rep = report["stress"] = {
        "model_build_s": time.perf_counter() - t0, "n": ma_s.n,
        "n_padded": stress._n, "block_size": stress._block_size,
        "chains": STRESS_CHAINS,
        "white_form": white_mh.white_form(stress._n, ma_s.nparam)._asdict()}
    print(f"# stress: {json.dumps(stress_rep)}", flush=True)
    wf = stress_rep["white_form"]
    if (stress._block_size is None or wf["form"] != "cluster"
            or wf["cluster"] < 2 or not wf["on_chip"]):
        fail("the stress config did not take the blocked TNT path and the "
             "white kernels' cluster form with the slices on chip")
    # every kernel's operands at the stress shapes: B5 and B3 are held
    # against their plain versions below, and all five are timed. B1, B2
    # and B4 are held against theirs at the flagship shapes (phase 3)
    captured_s = split_draws(capture([n for n, k in KERNELS.items()
                                      if k["per_sweep"]["stress"]],
                                     run_capture(stress, 13, 3)), "stress")
    reached = sorted({k[0] for k in captured_s})
    if reached != sorted(n for n, k in KERNELS.items()
                         if k["per_sweep"]["stress"] and n != DRAWS):
        fail(f"the stress sweep reached {reached}")

    # B5 against its float32 plain version and float64: a float32 sum over
    # 1e5 TOAs cannot meet a plain relative bound on entries that cancel,
    # so each entry is held to 1e-4 of the same sum over absolute values
    # (M = |T|^T w |T|, |T|^T |w y| for d, sum |log nvec| + y^2 w for the
    # constant)
    (T, y, nv, bs), = (a for k, a in captured_s.items()
                       if k[0] == "tnt_batched")
    out_k = tnt.tnt_batched(T, y, nv, bs)
    out_p = tnt.tnt_products(T, y, nv, bs)
    T64, y64, nv64 = T.double(), y.double(), nv.double()
    out_64 = tnt.tnt_products(T64, y64, nv64, bs)
    M, Md, _ = tnt.tnt_products(T64.abs(), y64.abs(), nv64, bs)
    Mc = 0.5 * (torch.log(nv64).abs().sum(-1) + (y64 * y64 / nv64).sum(-1))
    scales = (M, Md, Mc)

    def scaled_err(out):
        return max(float(((a.double() - b) / s_).abs().max())
                   for a, b, s_ in zip(out, out_64, scales))

    rec = {"shape": list(T.shape), "chains": int(nv.shape[0]),
           "max_abs_err": max(rel_err(a, b)[0] for a, b in zip(out_k, out_p)),
           "kernel_err_over_M": scaled_err(out_k),
           "plain_err_over_M": scaled_err(out_p),
           "symmetric": bool(torch.equal(out_k[0], out_k[0].transpose(1, 2)))}
    rec["ok"] = (rec["kernel_err_over_M"] <= 1e-4
                 and rec["plain_err_over_M"] <= 1e-4 and rec["symmetric"])
    parity["tnt_batched"] = [rec]
    print(f"# parity tnt_batched {rec['shape']}: {json.dumps(rec)}",
          flush=True)
    if not rec["ok"]:
        fail("tnt_batched disagrees with float64 at the stress shape")

    # B3 past shared memory. On the captured draws as they are (reported),
    # then with every decision moved STRESS_TIE_MARGIN clear of its float64
    # threshold (gated): kernel, plain version and float64 referee must
    # then take the same decisions, as phase 3 requires
    (wargs,) = (a for k, a in captured_s.items() if k[0] == "white_mh")
    raw = mh_parity("white_mh", wargs)

    def white_sep(args):
        """The white block's logu with ties separated by a float64
        replay."""
        x, az, y2, dx, lu, rows, specs, var = args
        a64 = [t.double() for t in (az, y2, rows, specs)]
        return separate_ties(
            lambda q: white_mh.white_ll_lp(q, *a64[:3], var, a64[3]),
            x, dx, lu, margin=STRESS_TIE_MARGIN, push=2 * STRESS_TIE_MARGIN)

    lu = wargs[4]
    lu_sep = white_sep(wargs)
    rec = mh_parity("white_mh", wargs[:4] + (lu_sep,) + wargs[5:])
    rec["raw_draws"] = {k: raw[k] for k in (
        "accepts_kernel", "accepts_plain", "accepts_f64",
        "chains_kernel_vs_f64", "chains_plain_vs_f64")}
    rec["draws_moved"] = int((lu_sep != lu).sum())
    parity["white_mh"].append(rec)
    print(f"# parity white_mh {rec['shape']} (n={wargs[1].shape[1]}): "
          f"{json.dumps(rec)}", flush=True)
    if not rec["ok"] or rec["chains_kernel_vs_f64"]:
        fail("white_mh disagrees with its plain version at the stress shape")

    # one stress sweep on the card vs the CPU (8 chains). At 1e5 TOAs the
    # float32 hyper likelihood is ill-posed for some chains of an early
    # state: its delta moves by nats to orders of magnitude, or turns
    # non-finite, between the card's and the CPU's float32 operands (the
    # TOA sums rounded in another order), so two correct float32 sweeps
    # differ there. Each MH block's draws are therefore separated from
    # ties by a float64 replay on the card's operands: each step's margin
    # widens to 4x the largest departure of a float32 evaluation (on the
    # card's operands and on the CPU's, captured from both sweeps) from the
    # float64 delta, and a step where one of them is not finite and the
    # float64 delta is (or the other way round) is forced to the float64
    # decision. The counts of both are reported
    s8 = tb.TorchGibbs(ma_s, cfg_s, nchains=STRESS_CPU_CHAINS, device=dev,
                       record="light")
    s8_cpu = tb.TorchGibbs(ma_s, cfg_s, nchains=STRESS_CPU_CHAINS,
                           device="cpu", record="light")
    keys, sw = keyed(s8, 17, 3)
    st = s8.init_state(seed=17)
    for i in range(2):
        st = s8._sweep(st, s8._draw(keys, sw[i], st), sweep=i)
    dr = s8._draw(keys, sw[2], st)
    st_c = type(st)(*map(to_cpu, st))

    def both_operands(name, dr):
        """The operands of ``name`` in the card's sweep and the CPU's."""
        dr_c = type(dr)(*map(to_cpu, dr))
        (g,) = capture([name], lambda: s8._sweep(st, dr, 2)).values()
        (c,) = capture([name], lambda: s8_cpu._sweep(st_c, dr_c, 2)).values()
        return g, c

    def white_f(a, dtype):
        a = [t.to(dtype) for t in (a[1], a[2], a[5], a[6])] + [a[7]]
        return lambda q: white_mh.white_ll_lp(
            q.to(a[0].device, dtype), a[0], a[1], a[2], a[4], a[3])

    def hyper_f(a, dtype):
        a = [t.to(dtype) if torch.is_tensor(t) else t for t in a]
        return lambda q: hyper_mh.hyper_ll_lp(
            q.to(a[1].device, dtype), *a[1:5], *a[7:10], *a[10:12])

    sep = {}
    for name, ev, ix, field in (("white_mh", white_f, (3, 4), "logu_w"),
                                ("hyper_mh", hyper_f, (5, 6), "logu_h")):
        g, c = both_operands(name, dr)
        info = sep[name] = {}
        lu = separate_ties(
            ev(g, torch.float64), g[0], g[ix[0]], g[ix[1]],
            margin=STRESS_TIE_MARGIN, push=2 * STRESS_TIE_MARGIN,
            others=(ev(g, torch.float32), ev(c, torch.float32)), info=info)
        info["moved"] = int((lu != g[ix[1]]).sum())
        dr = dr._replace(**{field: lu})
    cmp = stress_rep["sweep_card_vs_cpu"] = card_vs_cpu(s8, s8_cpu, st, dr,
                                                        2)
    cmp["separation"] = sep
    # the float32 b draw's own spread: the same CPU sweep with the TOA sums
    # taken in blocks of 5120 instead of 4096 (both pad to 102,400 TOAs)
    s8_alt = tb.TorchGibbs(ma_s, cfg_s, nchains=STRESS_CPU_CHAINS,
                           device="cpu", record="light", tnt_block_size=5120)
    if s8_alt._n != s8_cpu._n:
        fail("the two TOA block sizes pad the stress pulsar differently")
    dr_c = type(dr)(*map(to_cpu, dr))
    cmp["b_cpu_blocks_5120_vs_4096"] = rel_err(
        s8_alt._sweep(st_c, dr_c, 2).b, s8_cpu._sweep(st_c, dr_c, 2).b)[:2]
    print(f"# stress sweep card-vs-cpu ({STRESS_CPU_CHAINS} chains): "
          f"{json.dumps(cmp)}", flush=True)
    # tolerance: every chain's accept counts equal and x to 1e-4 relative,
    # as phase 4. b is reported, not held, beside the spread of a float32
    # b draw at 1e5 TOAs between two summation orders of the same sums on
    # the CPU (b_cpu_blocks_5120_vs_4096)
    if cmp["chains_acc_mismatch"] > 0 or cmp["x"][1] > 1e-4:
        fail("one stress sweep on the card disagrees with the CPU")

    # the stress run
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stress.sample(niter=STRESS_WARM, seed=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = stress.sample(niter=STRESS_MORE, seed=1, state=stress.last_state,
                        start_sweep=STRESS_WARM)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check_launches("stress", STRESS_WARM + STRESS_MORE,
                   chunks_of(stress, STRESS_WARM, STRESS_MORE))
    st = stress.last_state
    finite = all(bool(torch.isfinite(getattr(st, f)).all())
                 for f in ("x", "b", "alpha", "theta", "df"))
    srun = stress_rep["run"] = {
        "sweeps": STRESS_WARM + STRESS_MORE, "timed_sweeps": STRESS_MORE,
        "warm_wall_s": t1 - t0, "timed_wall_s": t2 - t1,
        "ms_per_sweep": 1e3 * (t2 - t1) / STRESS_MORE,
        "chain_sweeps_per_s": STRESS_CHAINS * STRESS_MORE / (t2 - t1),
        "acc_white": float(res.stats["acc_white"].mean()),
        "acc_hyper": float(res.stats["acc_hyper"].mean()),
        "param_means": dict(zip(ma_s.param_names,
                                map(float, res.chain.mean((0, 1))))),
        "state_finite": finite,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches_by_path["stress"]}
    print(f"# stress run: {json.dumps(srun)}", flush=True)
    if (not finite or not np.isfinite(res.chain).all()
            or res.chain.shape != (STRESS_MORE, STRESS_CHAINS, ma_s.nparam)
            or res.bchain.size or res.zchain.size):
        fail("the stress run's chains are not finite light records")
    time_captured(captured_s, "stress")
    stress_rep["profile"] = profile("stress", stress, 10,
                                    srun["ms_per_sweep"])
    # the stress sampler stays for phase 14's draw costs
    del s8, s8_cpu, s8_alt, captured_s, T64, y64, nv64, M, Md, out_64

    # --- 9. multiple-try Metropolis ------------------------------------------
    cfg_m = cfg.with_mtm(MTM_TRIES, blocks=("white",))
    # record="full": mtm_run holds the recorded b finite
    mtm = tb.TorchGibbs(ma, cfg_m, nchains=NCHAINS, device=dev,
                        record="full")
    captured_m = capture(["white_mtm"], run_capture(mtm, 19, 5))
    if [k[0] for k in captured_m] != ["white_mtm"]:
        fail(f"the MTM sweep reached {sorted(captured_m)}")
    (margs,) = captured_m.values()
    rec = mh_parity("white_mtm", margs)
    parity["white_mtm"] = [rec]
    print(f"# parity white_mtm {rec['shape']} (K={MTM_TRIES}): "
          f"{json.dumps(rec)}", flush=True)
    if not rec["ok"]:
        fail("white_mtm disagrees with its plain version")

    def mtm_run(smp, path, blocks):
        """Adapt ADAPT sweeps, then MORE timed ones, of an MTM sampler at
        the flagship; launch counts checked for ``path``."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smp.sample(niter=ADAPT, seed=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = smp.sample(niter=MORE, seed=1, state=smp.last_state,
                         start_sweep=ADAPT)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check_launches(path, ADAPT + MORE, chunks_of(smp, ADAPT, MORE))
        ess_a = effective_sample_size(res.chain[..., ia])
        rec = report[f"{path}_run"] = {
            "tries": MTM_TRIES, "blocks": list(blocks),
            "sweeps": ADAPT + MORE, "adapt_wall_s": t1 - t0,
            "timed_sweeps": MORE, "timed_wall_s": t2 - t1,
            "ms_per_sweep": 1e3 * (t2 - t1) / MORE,
            "chain_sweeps_per_s": NCHAINS * MORE / (t2 - t1),
            "ess_log10A": ess_a, "ess_log10A_per_s": ess_a / (t2 - t1),
            "acc_white": float(res.stats["acc_white"].mean()),
            "acc_hyper": float(res.stats["acc_hyper"].mean()),
            "param_means": dict(zip(ma.param_names,
                                    map(float, res.chain.mean((0, 1))))),
            "records_finite": bool(np.isfinite(res.chain).all()
                                   and np.isfinite(res.bchain).all()),
            "launches": launches_by_path[path]}
        print(f"# {path} run: {json.dumps(rec)}", flush=True)
        if not rec["records_finite"]:
            fail(f"non-finite chains after the {path} run")
        return rec

    mtm_run(mtm, "mtm", ("white",))

    # one sweep with MTM on both blocks, card vs CPU (64 chains)
    cfg_f = cfg.with_mtm(MTM_TRIES)
    full = tb.TorchGibbs(ma, cfg_f, nchains=64, device=dev)
    full_cpu = tb.TorchGibbs(ma, cfg_f, nchains=64, device="cpu")
    keys, sw = keyed(full, 23, 8)
    st = full._prop_cov_update(full.init_state(seed=23))
    for i in range(3):
        st = full._sweep(st, full._draw(keys, sw[i], st), sweep=i)
    dr = full._draw(keys, sw[3], st)
    cmp = report["mtm_sweep_card_vs_cpu"] = card_vs_cpu(
        full, full_cpu, st, dr, 3)
    # the spread of the b reading, reported beside the gate: the same
    # comparison at the next four sweeps of the card's chain. b is drawn
    # through the factor of an equilibrated matrix whose conditioning moves
    # from state to state, and float32 differences between the card's and
    # the CPU's inputs to it grow with that conditioning
    cmp["b_next_sweeps"] = []
    for i in range(4, 8):
        st = full._sweep(st, dr, sweep=i - 1)
        dr = full._draw(keys, sw[i], st)
        cmp["b_next_sweeps"].append(
            card_vs_cpu(full, full_cpu, st, dr, i)["b"][1])
    print(f"# full-MTM sweep card-vs-cpu (64 chains): {json.dumps(cmp)}",
          flush=True)
    # tolerance as phase 4
    if (cmp["chains_acc_mismatch"] > 0 or cmp["x"][1] > 1e-4
            or cmp["b"][1] > 1e-3):
        fail("one full-MTM sweep on the card disagrees with the CPU")
    # the same at 1024 chains: each hyper step factors 4096 candidate and
    # 3072 reference matrices through chol_fused
    full = tb.TorchGibbs(ma, cfg_f, nchains=NCHAINS, device=dev,
                         record="full")
    frec = mtm_run(full, "full_mtm", ("white", "hyper"))
    frec["profile"] = profile("full_mtm", full, 5, frec["ms_per_sweep"])
    split_draws(capture([DRAWS], run_capture(full, 23, 1)), "full_mtm")
    time_captured(captured_m, "mtm")

    # --- 10. the multi-pulsar ensemble ------------------------------------
    del full, mtm, captured_m
    from gibbs_student_t_tpu_torch.parallel import EnsembleGibbs

    def ens_pulsars(count):
        """Demo pulsars 100, 101, ... with 130 - (i mod 3) 10 TOAs each."""
        return [make_demo_model_arrays(n=130 - (i % 3) * 10, components=30,
                                       seed=100 + i) for i in range(count)]

    def grouped_ll(name, a, dtype):
        """``q (P C, p) -> (ll, lp)`` of a grouped MH block's operands
        ``a`` in ``dtype``, the (pulsar, chain) axes folded."""
        G, C, p = a[0].shape
        if name.startswith("hyper"):
            ops = ([t.to(dtype) for t in a[1:5]]
                   + [t[:, None].to(dtype) for t in a[7:10]])

            def f(q):
                return hyper_mh.hyper_ll_lp(q, *ops, a[10], a[11])
        else:
            az, y2 = a[1].to(dtype), a[2].to(dtype)
            rows, specs = (t[:, None].to(dtype) for t in a[-3:-1])

            def f(q):
                return white_mh.white_ll_lp(q, az, y2, rows, a[-1], specs)

        def ll_lp(qf):
            ll, lp = f(qf.to(a[0].device, dtype).reshape(G, C, p))
            return ll.reshape(-1), lp.reshape(-1)
        return ll_lp

    def grouped_sep(name, a, others=(), info=None):
        """A grouped single-try block's logu with its ties separated by a
        float64 replay (phase 8's rule, margin 1e-3 as at 130 TOAs),
        widened where the float32 block on the same operands (and on
        ``others``' operands) departs from it, and forced to the float64
        decision where float32 rounds a proposal onto a prior bound or
        off it (``testing.separate_ties``)."""
        G, C, p = a[0].shape
        dx, lu = (a[5], a[6]) if name.startswith("hyper") else (a[3], a[4])
        S = dx.shape[-2]
        return separate_ties(
            grouped_ll(name, a, torch.float64), a[0].reshape(-1, p),
            dx.reshape(-1, S, p), lu.reshape(-1, S),
            others=(grouped_ll(name, a, torch.float32), *others),
            info=info).reshape(G, C, S)

    def grouped_mtm_sep(a):
        """The grouped white MTM block's (gumb, logu) with selection and
        accept ties separated by a float64 replay."""
        x, az, y2, dx, dxr, gumb, lu, rows, specs, var = a
        G, C, S, K, p = dx.shape
        a64 = [t.double() for t in (az[..., None, :], y2[..., None, :],
                                    rows[:, None, None], specs[:, None, None])]

        def weight64(qf):
            ll, lp = white_mh.white_ll_lp(qf.reshape(G, C, -1, p), *a64[:3],
                                          var, a64[3])
            return (ll + lp).reshape(G * C, -1)

        gs, ls = separate_mtm_ties(
            weight64, x.reshape(-1, p), dx.reshape(-1, S, K, p),
            dxr.reshape(-1, S, K - 1, p), gumb.reshape(-1, S, K),
            lu.reshape(-1, S))
        return gs.reshape(G, C, S, K), ls.reshape(G, C, S)

    def grouped_parity(name, args, sep_args, **kw):
        """mh_parity on the captured draws (reported: over 8,192 chains a
        float32 decision within roundoff of its threshold can go either
        way between two summation orders) and on the draws with every tie
        separated by a float64 replay (gated: kernel, plain version and
        float64 referee take the same decisions, x as in phase 3)."""
        raw = mh_parity(name, args, **kw)
        rec = mh_parity(name, sep_args, **kw)
        rec["raw_draws"] = {k: raw[k] for k in (
            "ok", "accepts_kernel", "accepts_plain", "accepts_f64",
            "chains_kernel_vs_f64", "chains_plain_vs_f64")}
        rec["draws_moved"] = int(sum((a != b).sum() for a, b in zip(
            args, sep_args) if torch.is_tensor(a)))
        rec["ok"] = bool(rec["ok"] and rec["chains_kernel_vs_f64"] == 0
                         and rec["chains_acc_mismatch"] == 0)
        parity.setdefault(name, []).append(rec)
        print(f"# parity {name} {rec['shape']}{' ' + str(kw) if kw else ''}"
              f": {json.dumps(rec)}", flush=True)
        if not rec["ok"]:
            fail(f"{name} disagrees with its plain version at {rec['shape']}")

    t0 = time.perf_counter()
    cfg_e = GibbsConfig(model="mixture", vary_df=True,
                        theta_prior="beta").with_adapt(ADAPT, adapt_cov=True)
    ens = EnsembleGibbs(ens_pulsars(ENS_PULSARS), cfg_e, nchains=ENS_CHAINS,
                        device=dev, record="light")
    ens_rep = report["ens32"] = {
        "model_build_s": time.perf_counter() - t0, "pulsars": ENS_PULSARS,
        "chains": ENS_CHAINS, "n_toa": ens.n_toa.tolist(),
        "n_padded": ens._n, "m": ens._ma.m, "p": ens._ma.nparam,
        "schur": [len(i) for i in ens._schur],
        "white_form": white_mh.white_form(ens._n, ens._ma.nparam)._asdict()}
    print(f"# ens32: {json.dumps(ens_rep)}", flush=True)
    if (ens_rep["schur"] != [14, 60] or ens._n != 130
            or ens_rep["white_form"]["form"] != "warp"):
        fail("the ens32 config is not the flagship's shape per pulsar, or "
             "its white kernels do not take the warp form")

    # 10a. the grouped kernels and the factor and solves at the ensemble's
    # shapes, on inputs captured from an ens32 sweep
    ens_names = [n for n, k in KERNELS.items() if k["per_sweep"]["ens32"]]
    captured_e = split_draws(capture(ens_names, run_capture(ens, 7, 2)),
                             "ens32")
    ens_names.remove(DRAWS)
    if sorted({k[0] for k in captured_e}) != sorted(ens_names):
        fail(f"the ens32 sweep reached {sorted(captured_e)}")
    for (name, shape), args in sorted(captured_e.items()):
        if name in GROUPED:
            dx_i = 6 if name.startswith("hyper") else 4
            grouped_parity(name, args, args[:dx_i] + (
                grouped_sep(name, args),) + args[dx_i + 1:])
            continue
        out_k = wrappers[name][2](*args)
        out_p = plains[name](*args)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(out_k, out_p)]
        rec = {"shape": list(shape), "path": "ens32",
               "max_abs_err": max(e[0] for e in errs),
               "max_rel_err": max(e[1] for e in errs),
               "nonfinite_mismatch": sum(e[2] for e in errs)}
        # tolerance as in phase 3
        rec["ok"] = bool(rec["max_rel_err"] <= 1e-3
                         and rec["nonfinite_mismatch"] == 0)
        parity.setdefault(name, []).append(rec)
        print(f"# parity {name} {list(shape)}: {json.dumps(rec)}", flush=True)
        if not rec["ok"]:
            fail(f"{name} disagrees with its plain version at {shape}")
    # warps of two pulsars in one block: 3 pulsars x 5 chains,
    # 8 chains a block
    (hargs,) = (a for k, a in captured_e.items() if k[0] == "hyper_mh_grouped")
    adv = (tuple(t[:3, :5].contiguous() for t in hargs[:7])
           + tuple(t[:3].contiguous() for t in hargs[7:10]) + hargs[10:])
    grouped_parity("hyper_mh_grouped", adv, adv[:6] + (
        grouped_sep("hyper_mh_grouped", adv),) + adv[7:], per_block=8)

    # 10b. one deterministic ensemble sweep on the card against the CPU
    cpu_mas = ens_pulsars(ENS_CPU_PULSARS)
    eg = EnsembleGibbs(cpu_mas, cfg_e, nchains=ENS_CPU_CHAINS, device=dev)
    ec = EnsembleGibbs(cpu_mas, cfg_e, nchains=ENS_CPU_CHAINS, device="cpu")
    keys, sw = keyed(eg, 29, 4)
    st = eg._prop_cov_update(eg.init_state(seed=29))
    for i in range(3):
        st = eg._sweep(st, eg._draw(keys, sw[i], st), sweep=i)
    dr = eg._draw(keys, sw[3], st)
    st_c = type(st)(*map(to_cpu, st))
    sep = {}
    for name, field in (("white_mh_grouped", "logu_w"),
                        ("hyper_mh_grouped", "logu_h")):
        dr_c = type(dr)(*map(to_cpu, dr))
        (g,) = capture([name], lambda: eg._sweep(st, dr, 3)).values()
        (c,) = capture([name], lambda: ec._sweep(st_c, dr_c, 3)).values()
        info = sep[name] = {}
        lu = grouped_sep(name, g, others=(
            grouped_ll(name, c, torch.float32),), info=info)
        info["moved"] = int((lu != getattr(dr, field)).sum())
        dr = dr._replace(**{field: lu})
    cmp = ens_rep["sweep_card_vs_cpu"] = card_vs_cpu(eg, ec, st, dr, 3)
    cmp["separation"] = sep
    print(f"# ensemble sweep card-vs-cpu ({ENS_CPU_PULSARS} x "
          f"{ENS_CPU_CHAINS} chains): {json.dumps(cmp)}", flush=True)
    # tolerance as phase 4, on draws clear of every float32 tie
    if (cmp["chains_acc_mismatch"] > 0 or cmp["x"][1] > 1e-4
            or cmp["b"][1] > 1e-3):
        fail("one ensemble sweep on the card disagrees with the CPU")
    del eg, ec

    # 10c. the ens32 run: adapt 100 sweeps, then 200 timed
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ens.sample(niter=ADAPT, seed=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = ens.sample(niter=MORE, seed=1, state=ens.last_state,
                     start_sweep=ADAPT)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check_launches("ens32", ADAPT + MORE, chunks_of(ens, ADAPT, MORE))
    st = ens.last_state
    P_, C_ = ENS_PULSARS, ENS_CHAINS
    finite = torch.ones((P_, C_), dtype=torch.bool, device=dev)
    for f in ("x", "b", "z", "alpha", "theta", "df"):
        finite &= torch.isfinite(getattr(st, f).reshape(P_, C_, -1)).all(-1)
    pad = ~ens._mask                                     # (P, 1, n)
    pinned = bool((st.z.masked_select(pad) == 0).all()
                  and (st.alpha.masked_select(pad) == 1).all())
    ia_e = [i for i, nm in enumerate(ens._ma.param_names)
            if "log10_A" in nm][0]
    wall = t2 - t1
    ess_e = np.array([effective_sample_size(res.chain[:, p, :, ia_e])
                      for p in range(P_)])
    erun = ens_rep["run"] = {
        "sweeps": ADAPT + MORE, "adapt_wall_s": t1 - t0,
        "timed_sweeps": MORE, "timed_wall_s": wall,
        "ms_per_sweep": 1e3 * wall / MORE,
        "pulsar_chain_sweeps_per_s": P_ * C_ * MORE / wall,
        "ess_log10A_per_s_median": float(np.median(ess_e) / wall),
        "ess_log10A_per_s_min": float(ess_e.min() / wall),
        "ess_log10A_per_s_by_pulsar": (ess_e / wall).tolist(),
        "acc_white": float(res.stats["acc_white"].mean()),
        "acc_hyper": float(res.stats["acc_hyper"].mean()),
        "share_finite": float(finite.float().mean()),
        "padded_rows_pinned": pinned,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches_by_path["ens32"]}
    print(f"# ens32 run: {json.dumps(erun)}", flush=True)
    print(f"# ens32: {P_ * C_ * MORE / wall:.1f} pulsar-chain-sweeps/s, "
          f"{1e3 * wall / MORE:.4f} ms/sweep, ESS(log10_A)/s median "
          f"{erun['ess_log10A_per_s_median']:.1f} min "
          f"{erun['ess_log10A_per_s_min']:.1f} | {card}", flush=True)
    if (erun["share_finite"] != 1.0 or not pinned
            or res.chain.shape != (MORE, P_, C_, ens._ma.nparam)
            or not np.isfinite(res.chain).all() or res.bchain.size):
        fail("the ens32 run's chains are not finite light records with "
             "their padded rows pinned")

    # 10d. the MTM arm: 8 pulsars, the white block under MTM
    cfg_em = GibbsConfig(
        model="mixture", vary_df=True, theta_prior="beta").with_adapt(
        ENS_MTM_SWEEPS, adapt_cov=True).with_mtm(MTM_TRIES, blocks=("white",))
    ensm = EnsembleGibbs(ens_pulsars(ENS_MTM_PULSARS), cfg_em,
                         nchains=ENS_MTM_CHAINS, device=dev, record="light")
    captured_em = capture(["white_mtm_grouped"], run_capture(ensm, 19, 2))
    (margs,) = captured_em.values()
    gs, ls = grouped_mtm_sep(margs)
    grouped_parity("white_mtm_grouped", margs, margs[:5] + (gs, ls)
                   + margs[7:])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ensm.sample(niter=ENS_MTM_SWEEPS, seed=1)
    res = ensm.sample(niter=ENS_MTM_SWEEPS, seed=1, state=ensm.last_state,
                      start_sweep=ENS_MTM_SWEEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    check_launches("ens_mtm", 2 * ENS_MTM_SWEEPS,
                   chunks_of(ensm, ENS_MTM_SWEEPS, ENS_MTM_SWEEPS))
    st = ensm.last_state
    mfinite = all(bool(torch.isfinite(getattr(st, f)).all())
                  for f in ("x", "b", "z", "alpha", "theta", "df"))
    mrun = ens_rep["mtm_run"] = {
        "pulsars": ENS_MTM_PULSARS, "chains": ENS_MTM_CHAINS,
        "tries": MTM_TRIES, "sweeps": 2 * ENS_MTM_SWEEPS,
        "wall_s": t1 - t0,
        "acc_white": float(res.stats["acc_white"].mean()),
        "state_finite": mfinite, "launches": launches_by_path["ens_mtm"]}
    print(f"# ens MTM run: {json.dumps(mrun)}", flush=True)
    if not mfinite or not np.isfinite(res.chain).all():
        fail("the ensemble MTM run's chains are not finite")
    del ensm

    # 10e. timings at the ensemble's shapes and a profile of ens32 sweeps
    time_captured(captured_e, "ens32")
    time_captured(captured_em, "ens_mtm")
    for name in GROUPED:
        for r in timing[name]:
            print(f"# {name} {r['shape']} ({r['path']}): {r['ms']:.4f} ms, "
                  f"ungrouped on as many chains {r['ungrouped_ms']:.4f} ms "
                  f"(grouped / ungrouped {r['ms'] / r['ungrouped_ms']:.3f}),"
                  f" {r['ms'] / r['bound_ms']:.1f}x its bound", flush=True)
    ens_rep["profile"] = profile("ens32", ens, 20, erun["ms_per_sweep"])
    # the ens32 sampler stays for phase 14's draw costs
    del captured_e, captured_em

    # --- 11. the serving slot pool (pool1024) --------------------------------
    from gibbs_student_t_tpu_torch.data.demo import (
        make_contaminated_pulsar,
        make_reference_pta,
    )
    from gibbs_student_t_tpu_torch.ops.lanes import LANES_GROUP
    from gibbs_student_t_tpu_torch.serve import (
        ChainServer,
        SlotPool,
        TenantRequest,
        TenantSlot,
    )

    def pool_model(seed):
        """The serving bench's model (tools/serve_bench.py:242-251): a
        contaminated demo pulsar of 130 TOAs, 30 Fourier components."""
        psr, _ = make_contaminated_pulsar(n=130, components=30, theta=0.02,
                                          sigma_out=1e-5, seed=seed)
        return make_reference_pta(psr, 30).frozen(0)

    def lanes_flat(t):
        """A pool tensor's (G, 16, ...) lanes as (B, ...)."""
        return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])

    def lanes_grouped(name, a):
        """A lanes MH block's operands in the grouped block's form: the
        per-lane operands as the pool's (G, 16, ...) tiles, the constants
        of each tile's first lane, the gid dropped."""
        if name.startswith("white"):
            return a[:5] + (a[5][:, 0], a[6][:, 0], a[8])
        return a[:7] + (a[7][:, 0], a[8][:, 0], a[9][:, 0]) + a[11:]

    def ensemble_form(name, a):
        """The same chains as the ensemble's grouped launch takes them:
        POOL_LANES / POOL_CHAINS groups of 256 chains, one set of
        constants each (that of the group's first tile)."""
        g = lanes_grouped(name, a)
        k, nc = (5, 2) if name.startswith("white") else (7, 3)
        P = POOL_LANES // POOL_CHAINS
        step = POOL_CHAINS // LANES_GROUP
        return (tuple(t.reshape(P, -1, *t.shape[2:]) for t in g[:k])
                + tuple(t[::step].contiguous() for t in g[k:k + nc])
                + g[k + nc:])

    t0 = time.perf_counter()
    cfg_p = GibbsConfig(model="mixture")
    template = pool_model(42)
    tenant_mas = [pool_model(100 + i) for i in range(POOL_TENANTS + 1)]
    rng_b = np.random.default_rng(0)
    budgets = [int(rng_b.integers(4, 8)) * POOL_QUANTUM
               for _ in range(POOL_TENANTS)]
    # the serial executor: 11d checks every quantum it runs
    srv = ChainServer(template, cfg_p, nlanes=POOL_LANES,
                      quantum=POOL_QUANTUM, record="light", device=dev,
                      pipeline=False)
    pool = srv.pool
    pool_rep = report["pool1024"] = {
        "build_s": time.perf_counter() - t0, "nlanes": POOL_LANES,
        "quantum": POOL_QUANTUM, "n": pool.n_pool, "m": template.m,
        "p": template.nparam,
        "schur": [len(i) for i in pool.sampler._schur],
        "tenants": [[POOL_CHAINS, b] for b in budgets]
        + [[POOL_PAD_CHAINS, POOL_PAD_SWEEPS]]}
    print(f"# pool1024: {json.dumps(pool_rep)}", flush=True)
    if pool_rep["schur"] != [14, 60] or pool.n_pool != 130:
        fail("the pool1024 template is not the serving bench's shape")

    # 11a. the lanes kernels against their plain versions, on inputs
    # captured from a sweep of a full pool (4 tenants of 256 chains)
    pool_names = ["tnt_lanes", "white_mh_lanes", "hyper_mh_lanes",
                  "chol_fused", "tri_solve_T"]
    # (telemetry off: its quantum-end log-posterior would add a Gram and
    # a factor call that are not the sweep's)
    cap = ChainServer(template, cfg_p, nlanes=POOL_LANES, quantum=1,
                      record="full", device=dev, telemetry=False)
    for i in range(POOL_LANES // POOL_CHAINS):
        cap.submit(TenantRequest(ma=tenant_mas[i], niter=2,
                                 nchains=POOL_CHAINS, seed=200 + i))
    cap.step()
    captured_p = split_draws(capture(pool_names + [DRAWS], cap.step),
                             "pool")
    if sorted({k[0] for k in captured_p}) != sorted(pool_names):
        fail(f"the pool sweep reached {sorted(captured_p)}")
    del cap
    for name in ("white_mh_lanes", "hyper_mh_lanes"):
        ((shape, args),) = ((k[1], a) for k, a in captured_p.items()
                            if k[0] == name)
        gname = name.replace("lanes", "grouped")
        i_lu = 4 if name.startswith("white") else 6
        lu = grouped_sep(gname, lanes_grouped(name, args))
        grouped_parity(name, args, args[:i_lu] + (lu,) + args[i_lu + 1:])
    # B5-L against float64, as a fraction of the same sums over absolute
    # values (phase 8's measure)
    (targs,) = (a for k, a in captured_p.items() if k[0] == "tnt_lanes")
    T_l, y_l, nv_l = targs[:3]
    n_p = nv_l.shape[-1]
    Tg64, yg64, nv64 = (T_l[:, 0, :n_p].double(),
                        y_l[:, 0, None, :n_p].double(), nv_l.double())
    out_64 = tnt.tnt_products(Tg64, yg64, nv64)
    M, Md, _ = tnt.tnt_products(Tg64.abs(), yg64.abs(), nv64)
    Mc = 0.5 * (torch.log(nv64).abs().sum(-1) + (yg64 * yg64 / nv64).sum(-1))
    out_k = tnt.tnt_lanes(*targs)
    out_p = tnt.tnt_lanes_plain(*targs)

    def over_m(out):
        return max(float(((a.double() - b) / s_).abs().max())
                   for a, b, s_ in zip(out, out_64, (M, Md, Mc)))

    rec = {"shape": list(nv_l.shape), "m": int(T_l.shape[-1]),
           "basis_rows": int(T_l.shape[-2]),
           "max_abs_err": max(rel_err(a, b)[0] for a, b in zip(out_k, out_p)),
           "kernel_err_over_M": over_m(out_k),
           "plain_err_over_M": over_m(out_p),
           "symmetric": bool(torch.equal(out_k[0],
                                         out_k[0].transpose(-1, -2)))}
    # tolerance: 1e-4 of M on every output, as phase 8 holds B5
    rec["ok"] = (rec["kernel_err_over_M"] <= 1e-4
                 and rec["plain_err_over_M"] <= 1e-4 and rec["symmetric"])
    parity["tnt_lanes"] = [rec]
    print(f"# parity tnt_lanes {rec['shape']}: {json.dumps(rec)}",
          flush=True)
    if not rec["ok"]:
        fail("tnt_lanes disagrees with float64 at the pool's shape")
    del out_64, M, Md, Mc, Tg64, yg64, nv64
    # the factor and back-solve lanes entries on the pool's operands (the
    # stacked jitter levels of the b draw are 4 x 1024 lanes): against
    # their plain versions, and bit for bit the plain entries' launches
    captured_lc = {}
    for (name, shape), args in sorted(captured_p.items()):
        if name not in ("chol_fused", "tri_solve_T"):
            continue
        lname = name + "_lanes"
        m_ = args[0].shape[-1]
        mats, rhs = args[0].reshape(-1, m_, m_), args[1].reshape(-1, m_)
        gid = torch.arange(mats.shape[0] // LANES_GROUP, dtype=torch.int32,
                           device=dev).repeat_interleave(LANES_GROUP)
        largs = (mats, rhs, gid)
        captured_lc[(lname, tuple(mats.shape))] = largs
        out_k = wrappers[lname][2](*largs)
        out_p = plains[lname](*largs)
        out_r = wrappers[name][2](mats, rhs)
        torch.cuda.synchronize()
        if torch.is_tensor(out_k):
            out_k, out_p, out_r = (out_k,), (out_p,), (out_r,)
        errs = [rel_err(a, b) for a, b in zip(out_k, out_p)]
        rec = {"shape": list(mats.shape), "path": "pool",
               "max_abs_err": max(e[0] for e in errs),
               "max_rel_err": max(e[1] for e in errs),
               "nonfinite_mismatch": sum(e[2] for e in errs),
               "bitwise_plain_entry": all(torch.equal(a, b)
                                          for a, b in zip(out_k, out_r))}
        # tolerance as in phase 3
        rec["ok"] = bool(rec["max_rel_err"] <= 1e-3
                         and rec["nonfinite_mismatch"] == 0
                         and rec["bitwise_plain_entry"])
        parity.setdefault(lname, []).append(rec)
        print(f"# parity {lname} {rec['shape']}: {json.dumps(rec)}",
              flush=True)
        if not rec["ok"]:
            fail(f"{lname} disagrees at {rec['shape']}")

    # 11b. one pool sweep on the card against the same sweep on the CPU, 64
    # lanes (two tenants of 32 chains), ties separated as in 10b
    def small_pool(device):
        return SlotPool(template, cfg_p, nlanes=POOL_CPU_LANES, quantum=1,
                        record="full", device=device)

    pg, pc = small_pool(dev), small_pool("cpu")
    C2 = POOL_CPU_CHAINS
    for i in range(POOL_CPU_LANES // C2):
        ma_i = tenant_mas[i]
        be_g = tb.TorchGibbs(ma_i, cfg_p, nchains=C2, device=dev,
                             tnt_block_size=None)
        be_c = tb.TorchGibbs(ma_i, cfg_p, nchains=C2, device="cpu",
                             tnt_block_size=None)
        st_i = be_g.init_state(seed=300 + i)
        lanes = np.arange(i * C2, (i + 1) * C2)
        pg.write_tenant(TenantSlot(i, lanes, C2, 3, 0, 300 + i), be_g,
                        st_i)
        pc.write_tenant(TenantSlot(i, lanes, C2, 3, 0, 300 + i), be_c,
                        type(st_i)(*map(to_cpu, st_i)))
    for _ in range(2):
        pg.run_quantum()
    for pl in (pg, pc):
        pl._upload()
    st = pg.state
    dr = pg._lane_draws(st, pg._lane_sweep)
    dr = type(dr)(*(t.clone() for t in dr))
    st_c = type(st)(*map(to_cpu, st))
    sep = {}
    for name, field in (("white_mh_lanes", "logu_w"),
                        ("hyper_mh_lanes", "logu_h")):
        dr_c = type(dr)(*map(to_cpu, dr))
        (g,) = capture([name], lambda: pg.sampler._sweep(st, dr, 0)).values()
        (c,) = capture([name], lambda: pc.sampler._sweep(st_c, dr_c, 0)
                       ).values()
        gname = name.replace("lanes", "grouped")
        ga, ca = lanes_grouped(name, g), lanes_grouped(name, c)
        info = sep[name] = {}
        lu = grouped_sep(gname, ga, others=(
            grouped_ll(gname, ca, torch.float32),), info=info)
        info["moved"] = int((lu != getattr(dr, field)).sum())
        dr = dr._replace(**{field: lu})
    cmp = pool_rep["sweep_card_vs_cpu"] = card_vs_cpu(pg.sampler, pc.sampler,
                                                      st, dr, 0)
    cmp["separation"] = sep
    # the float32 b draw's own spread on these models: the same CPU sweep
    # with each group's TOA sums taken in blocks of 32 over its basis padded
    # with zero rows (unit nvec on the padded TOAs) instead of in one product
    smp_c = pc.sampler
    dr_c = type(dr)(*map(to_cpu, dr))

    def tnt_blocks(nvec):
        G_, C_, n_ = nvec.shape
        pad = -n_ % 32
        nv = torch.cat([nvec, nvec.new_ones(G_, C_, pad)], -1)
        Tp = torch.cat([smp_c._T, smp_c._T.new_zeros(
            G_, pad, smp_c._T.shape[-1])], 1)
        yp = torch.cat([smp_c._y, smp_c._y.new_zeros(G_, 1, pad)], -1)
        outs = [tnt.tnt_products(Tp[g], yp[g, 0], nv[g], 32)
                for g in range(G_)]
        return tuple(torch.stack(o) for o in zip(*outs))

    b_one = smp_c._sweep(st_c, dr_c, 0).b
    smp_c._tnt = tnt_blocks
    b_blocks = smp_c._sweep(st_c, dr_c, 0).b
    del smp_c._tnt
    cmp["b_cpu_blocks_32_vs_one"] = rel_err(b_blocks, b_one)[:2]
    print(f"# pool sweep card-vs-cpu ({POOL_CPU_LANES} lanes): "
          f"{json.dumps(cmp)}", flush=True)
    # tolerance: every chain's accept counts equal, on draws clear of every
    # float32 tie, and x to 1e-4 relative, as phase 4. b is reported, not
    # held, beside the spread of the float32 b draw between two summation
    # orders of the same TOA sums on the CPU (b_cpu_blocks_32_vs_one): on
    # these models (10 us outliers) that spread reaches 1e-2 relative
    if cmp["chains_acc_mismatch"] > 0 or cmp["x"][1] > 1e-4:
        fail("one pool sweep on the card disagrees with the CPU")
    del pg, pc, smp_c

    # 11c. a tenant of 256 chains against the solo sampler on the card: the
    # same state and the same draws (the pool draws them itself, from its
    # lanes' keys and sweeps), one deterministic sweep, ties separated
    solo = tb.TorchGibbs(tenant_mas[0], cfg_p, nchains=POOL_CHAINS,
                         device=dev, tnt_block_size=None)
    other = tb.TorchGibbs(tenant_mas[1], cfg_p, nchains=POOL_CHAINS,
                          device=dev, tnt_block_size=None)
    ps = SlotPool(template, cfg_p, nlanes=2 * POOL_CHAINS, quantum=1,
                  record="full", device=dev)
    seed_s, i_s = 400, 3
    keys, sw = keyed(solo, seed_s, i_s + 1)
    st = solo.init_state(seed=seed_s)
    for i in range(i_s):
        st = solo._sweep(st, solo._draw(keys, sw[i], st), sweep=i)
    ps.write_tenant(TenantSlot(0, np.arange(POOL_CHAINS), POOL_CHAINS, 1, 0,
                               401), other, other.init_state(seed=401))
    ps.write_tenant(TenantSlot(1, np.arange(POOL_CHAINS, 2 * POOL_CHAINS),
                               POOL_CHAINS, 1, i_s, seed_s), solo, st)
    ps._upload()
    pdr = ps._lane_draws(ps.state, ps._lane_sweep)
    dr = solo._draw(keys, sw[i_s], st)
    mine = slice(POOL_CHAINS, 2 * POOL_CHAINS)
    draws_equal = all(torch.equal(lanes_flat(b)[mine], d)
                      for b, d in zip(pdr, dr))
    sep = {}
    gt = POOL_CHAINS // LANES_GROUP
    for name, lname, ev, ix, field in (
            ("white_mh", "white_mh_lanes", white_f, (3, 4), "logu_w"),
            ("hyper_mh", "hyper_mh_lanes", hyper_f, (5, 6), "logu_h")):
        (a_s,) = capture([name], lambda: solo._sweep(st, dr, i_s)).values()
        (a_p,) = capture([lname], lambda: ps.sampler._sweep(
            ps.state, pdr, 0)).values()
        gname = lname.replace("lanes", "grouped")
        a_t = tuple(t[gt:] if torch.is_tensor(t) else t
                    for t in lanes_grouped(lname, a_p))
        info = sep[name] = {}
        lu = separate_ties(
            ev(a_s, torch.float64), a_s[0], a_s[ix[0]], a_s[ix[1]],
            others=(ev(a_s, torch.float32),
                    grouped_ll(gname, a_t, torch.float32)), info=info)
        info["moved"] = int((lu != getattr(dr, field)).sum())
        dr = dr._replace(**{field: lu})
        lanes_flat(getattr(pdr, field))[mine] = lu
    out_s = solo._sweep(st, dr, i_s)
    out_p = ps.sampler._sweep(ps.state, pdr, 0)
    nw, nh = cfg_p.mh.n_white_steps, cfg_p.mh.n_hyper_steps
    agree = ((torch.round(lanes_flat(out_p.acc_white)[mine] * nw)
              == torch.round(out_s.acc_white * nw))
             & (torch.round(lanes_flat(out_p.acc_hyper)[mine] * nh)
                == torch.round(out_s.acc_hyper * nh)))
    cmp = pool_rep["solo_tenant_vs_torch_gibbs"] = {
        "chains": POOL_CHAINS, "draws_bitwise": bool(draws_equal),
        "chains_acc_mismatch": int((~agree).sum()),
        **{f: rel_err(lanes_flat(getattr(out_p, f))[mine],
                      getattr(out_s, f))[:2] for f in ("x", "b")},
        "separation": sep}
    print(f"# pool solo tenant vs TorchGibbs ({POOL_CHAINS} chains): "
          f"{json.dumps(cmp)}", flush=True)
    # tolerance: the tenant's draws are the solo sampler's bit for bit, its
    # accept counts equal and x to 1e-4 relative; b is reported as in 11b
    # (B5-L and the solo's dense product are two summation orders)
    if (not draws_equal or cmp["chains_acc_mismatch"] > 0
            or cmp["x"][1] > 1e-4):
        fail("a pool tenant disagrees with the solo sampler on the card")
    del ps, solo, other

    # 11d. the pool1024 run through ChainServer.run(): 8 tenants of 256
    # chains and the 40-chain tenant, which backfills. Inactive lanes (pad
    # lanes, free groups) are checked frozen at every quantum, and the
    # dense TNT product is counted (the pool must not call it)
    handles = [srv.submit(TenantRequest(
        ma=tenant_mas[i], niter=budgets[i], nchains=POOL_CHAINS,
        seed=100 + i)) for i in range(POOL_TENANTS)]
    handles.append(srv.submit(TenantRequest(
        ma=tenant_mas[-1], niter=POOL_PAD_SWEEPS, nchains=POOL_PAD_CHAINS,
        seed=100 + POOL_TENANTS)))
    frozen = {"quanta_checked": 0, "max_idle_lanes": 0, "ok": True}
    dense = [0]
    run_quantum, tnt_products = pool.run_quantum, tb.tnt_products

    def checked_quantum():
        idle = torch.from_numpy(np.flatnonzero(~pool._active_np)).to(dev)
        before = [lanes_flat(f).index_select(0, idle) for f in pool.state]
        recs = run_quantum()
        frozen["ok"] &= all(
            torch.equal(lanes_flat(f).index_select(0, idle), b)
            for f, b in zip(pool.state, before))
        frozen["quanta_checked"] += 1
        frozen["max_idle_lanes"] = max(frozen["max_idle_lanes"], len(idle))
        return recs

    def counted_products(*a, **k):
        dense[0] += 1
        return tnt_products(*a, **k)

    pool.run_quantum, tb.tnt_products = checked_quantum, counted_products
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        srv.run()
        torch.cuda.synchronize()
    finally:
        del pool.run_quantum
        tb.tnt_products = tnt_products
    wall = time.perf_counter() - t0
    sweeps = srv.quanta * POOL_QUANTUM
    check_launches("pool", sweeps, srv.quanta)
    summ = srv.summary()
    want_busy = (sum(budgets) * POOL_CHAINS
                 + POOL_PAD_SWEEPS * POOL_PAD_CHAINS)
    results_ok = True
    for h, (c_, n_) in zip(handles, pool_rep["tenants"]):
        res = h.result()
        results_ok &= (res.chain.shape == (n_, c_, template.nparam)
                       and res.thetachain.shape == (n_, c_)
                       and bool(np.isfinite(res.chain).all()
                                and np.isfinite(res.thetachain).all()
                                and np.isfinite(res.dfchain).all())
                       and res.bchain.size == 0)
    prun = pool_rep["run"] = {
        "quanta": srv.quanta, "sweeps": sweeps, "wall_s": wall,
        "ms_per_sweep": 1e3 * wall / sweeps,
        "busy_chain_sweeps": summ["busy_chain_sweeps"],
        "busy_chain_sweeps_per_s": summ["busy_chain_sweeps"] / wall,
        "occupancy": summ["occupancy"], "results_ok": bool(results_ok),
        "frozen": frozen, "dense_tnt_calls": dense[0],
        "groups_free": len(srv._free_groups),
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches_by_path["pool"],
        "launches_per_sweep": {k: v / sweeps for k, v in
                               launches_by_path["pool"].items() if v}}
    print(f"# pool1024 run: {json.dumps(prun)}", flush=True)
    if (not results_ok or not frozen["ok"] or dense[0]
            or summ["busy_chain_sweeps"] != want_busy
            or len(srv._free_groups) != POOL_LANES // LANES_GROUP
            or pool._active_np.any()):
        fail("the pool1024 run's results, frozen lanes, launches or "
             "bookkeeping are wrong")

    legacy_gen = torch.Generator(device=dev)
    legacy_bufs = {}

    def legacy_pool_draws(pl):
        """The pool's draws as the parent made them: for each resident
        tenant, the generator re-seeded, its chains' draws made at its
        chain count from its lanes' state (a view: its lanes are
        consecutive here) and copied into its lanes of buffers allocated
        once."""
        flat = [lanes_flat(getattr(pl.state, f))
                for f in ("z", "df", "mh_log_scale", "mh_cov_chol")]
        for tid, slot in pl._slots.items():
            lo = int(slot.chain_lanes[0])
            rows = slice(lo, lo + slot.nchains)
            st_t = tb.ChainState(
                x=None, b=None, z=flat[0][rows], alpha=None, theta=None,
                df=flat[1][rows], pout=None, acc_white=None, acc_hyper=None,
                mh_log_scale=flat[2][rows], mh_cov_chol=flat[3][rows])
            dr = legacy_draw(torch, pl.drawer,
                             legacy_gen.manual_seed(1000 + tid), st_t)
            vals = [t for d in dr
                    for t in (d if isinstance(d, tuple) else (d,))]
            if id(pl) not in legacy_bufs:
                legacy_bufs[id(pl)] = [
                    torch.empty((pl.nlanes, *t.shape[1:]), dtype=t.dtype,
                                device=dev) for t in vals]
            for buf, val in zip(legacy_bufs[id(pl)], vals):
                buf[rows].copy_(val)

    # the profiled window: 4 tenants of 256 chains fill the pool; a quantum
    # to warm up, 4 timed, then 4 under the profiler; and the draws of one
    # sweep (every lane's) profiled alone, beside the parent's draws
    q_prof = POOL_PROFILE_QUANTA
    psrv = ChainServer(template, cfg_p, nlanes=POOL_LANES,
                       quantum=POOL_QUANTUM, record="light", device=dev)
    for i in range(POOL_LANES // POOL_CHAINS):
        psrv.submit(TenantRequest(ma=tenant_mas[i],
                                  niter=(1 + 2 * q_prof) * POOL_QUANTUM,
                                  nchains=POOL_CHAINS, seed=500 + i))
    psrv.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(q_prof):
        psrv.step()
    torch.cuda.synchronize()
    wall_q = 1e3 * (time.perf_counter() - t0) / q_prof
    try:
        # the draws first, while the tenants are resident (they leave with
        # the last profiled quantum): one draw-kernel call for every lane,
        # and the parent's generator draws, a set for each tenant written
        # into its lanes (phase 14d)
        ppl = psrv.pool
        prof_d = profile_calls(
            torch, lambda: ppl._lane_draws(ppl.state, ppl._lane_sweep),
            DRAW_PROFILE_CALLS)
        prof_l = profile_calls(torch, lambda: legacy_pool_draws(ppl),
                               DRAW_PROFILE_CALLS)
        # and their times (events, behind the stream hold), for phase 14
        pool_draw_ms = {
            "ms": timed(lambda: ppl._lane_draws(ppl.state, ppl._lane_sweep),
                        (), 20),
            "legacy_ms": timed(lambda: legacy_pool_draws(ppl), (), 20)}
        prof = profile_calls(torch, psrv.step, q_prof)
    except Exception as exc:  # noqa: BLE001
        fail(f"the profiler did not trace the pool: {exc!r}")
    if prof["device_ms_per_sweep"] <= 0 or prof_d["launches_per_sweep"] <= 0:
        fail("the profiler saw no device time in the pool's quanta")
    pprof = pool_rep["profile"] = {
        "quanta": q_prof, "tenants": POOL_LANES // POOL_CHAINS,
        "wall_ms_per_sweep": wall_q / POOL_QUANTUM,
        "device_ms_per_sweep": prof["device_ms_per_sweep"] / POOL_QUANTUM,
        "launches_per_sweep": prof["launches_per_sweep"] / POOL_QUANTUM,
        "idle_share": max(0.0, 1.0 - prof["device_ms_per_sweep"] / wall_q),
        "draw_launches_per_sweep": prof_d["launches_per_sweep"],
        "draw_device_ms_per_sweep": prof_d["device_ms_per_sweep"],
        "legacy_draw_launches_per_sweep": prof_l["launches_per_sweep"],
        "legacy_draw_device_ms_per_sweep": prof_l["device_ms_per_sweep"],
        "top": [dict(r, ms_per_sweep=r["ms_per_sweep"] / POOL_QUANTUM,
                     calls_per_sweep=r["calls_per_sweep"] / POOL_QUANTUM)
                for r in prof["top"]]}
    print(f"# profile pool1024 ({q_prof} quanta, 4 x {POOL_CHAINS} chains): "
          f"device busy {pprof['device_ms_per_sweep']:.4f} ms/sweep, "
          f"{pprof['launches_per_sweep']:.1f} launches/sweep of which "
          f"{pprof['draw_launches_per_sweep']:.1f} draw the lanes' "
          f"numbers (the generator draws a tenant at a time: "
          f"{pprof['legacy_draw_launches_per_sweep']:.1f}); wall "
          f"{pprof['wall_ms_per_sweep']:.4f} ms/sweep "
          f"unprofiled; idle share {pprof['idle_share']:.4f}")
    for row in pprof["top"]:
        print(f"#   {row['ms_per_sweep']:8.4f} ms/sweep "
              f"{row['calls_per_sweep']:6.1f} calls  {row['name'][:90]}")
    print(f"# pool1024: {prun['busy_chain_sweeps_per_s']:.1f} busy "
          f"chain-sweeps/s, occupancy {prun['occupancy']:.4f}, "
          f"{prun['ms_per_sweep']:.4f} ms/sweep, "
          f"{pprof['draw_launches_per_sweep']:.1f} draw launches/sweep | "
          f"{card}", flush=True)
    del psrv, srv

    # 11e. the lanes kernels' timings at the pool's shapes; B3-L and B4-L
    # also beside the ensemble's grouped launch on the same 1,024 chains
    time_captured({k: a for k, a in captured_p.items()
                   if k[0].endswith("_lanes")}, "pool")
    time_captured(captured_lc, "pool")
    for name in LANES:
        for r in timing[name]:
            print(f"# {name} {r['shape']}: {r['ms']:.4f} ms, ensemble form "
                  f"on the same chains {r['ensemble_form_ms']:.4f} ms "
                  f"(lanes / ensemble {r['ms'] / r['ensemble_form_ms']:.3f})"
                  f", {r['ms'] / r['bound_ms']:.1f}x its bound", flush=True)
    del captured_p, captured_lc

    # --- 12. the sampling surface on the card (flagship, 1024 chains) -------
    from gibbs_student_t_tpu_torch.obs.telemetry import (
        telemetry_init,
        telemetry_update,
    )
    from gibbs_student_t_tpu_torch.parallel.diagnostics import ess_per_param

    srep = report["sample"] = {}
    st0 = sampler.last_state            # after phase 5's ADAPT + MORE sweeps
    s0 = ADAPT + MORE                   # past adapt_until: factors frozen

    # 12a. B1 at (1024, 74), as the telemetry's chunk-end log-posterior
    # launches it: the warp form with three rows a lane, against its plain
    # version (phase 3's tolerance); the same operands with two matrices
    # negated, whose two alone may turn NaN; the kernel timed in turns
    # beside its block form (per_block = 0) and cholesky_ex; the same at
    # (1, 74), lnlikelihood's factor; then lnlikelihood on the card
    # against the same call on the CPU at 8 points
    form74 = chol.launch_form(NCHAINS, ma.m)
    if form74[0] != "warp":
        fail(f"B1 at ({NCHAINS}, {ma.m}) takes the {form74} form")
    captured_lp = capture(["chol_fused"],
                          lambda: sampler._logpost_chain(st0))
    key74 = ("chol_fused", (NCHAINS, ma.m, ma.m))
    if list(captured_lp) != [key74]:
        fail(f"the log-posterior launched {sorted(captured_lp)}")
    pt0 = [getattr(st0, f)[0].cpu().numpy() for f in ("x", "z", "alpha")]
    captured_l1 = capture(["chol_fused"],
                          lambda: sampler.lnlikelihood(*pt0))
    key1 = ("chol_fused", (1, ma.m, ma.m))
    if list(captured_l1) != [key1]:
        fail(f"lnlikelihood launched {sorted(captured_l1)}")
    for key, capt, what in ((key74, captured_lp, "log-posterior"),
                            (key1, captured_l1, "lnlikelihood")):
        args_ = capt[key]
        form_ = chol.launch_form(key[1][0], ma.m)
        if form_[0] != "warp":
            fail(f"B1 at {key[1]} takes the {form_} form")
        out_k = chol.chol_fused(*args_)
        out_p = chol.chol_fused_plain(*args_)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(out_k, out_p)]
        rec = {"shape": list(key[1]), "form": list(form_),
               "max_abs_err": max(e[0] for e in errs),
               "max_rel_err": max(e[1] for e in errs),
               "nonfinite_mismatch": sum(e[2] for e in errs)}
        # tolerance: 1e-3 relative on every output, the non-finite pattern
        # identical (phase 3)
        rec["ok"] = bool(rec["max_rel_err"] <= 1e-3
                         and rec["nonfinite_mismatch"] == 0)
        parity["chol_fused"].append(rec)
        print(f"# parity chol_fused {rec['shape']} ({what}): "
              f"{json.dumps(rec)}", flush=True)
        if not rec["ok"]:
            fail(f"chol_fused disagrees with its plain version at {key[1]}")
    # two matrices negated (a negative first pivot): their logdet turns NaN,
    # on the card and in the plain version; no other matrix's does, and
    # every other matrix comes out bit for bit as without the negation
    args74 = captured_lp[key74]
    neg = [3, NCHAINS - 300]
    S_neg = args74[0].clone()
    S_neg[neg] = -S_neg[neg]
    out_n = chol.chol_fused(S_neg, args74[1])
    out_k = chol.chol_fused(*args74)
    out_np = chol.chol_fused_plain(S_neg, args74[1])
    out_p = chol.chol_fused_plain(*args74)
    torch.cuda.synchronize()
    keep = torch.ones(NCHAINS, dtype=torch.bool, device=dev)
    keep[neg] = False

    def nan_at(ld):
        return [int(i) for i in torch.nonzero(torch.isnan(ld)).flatten()]

    nan_rec = {"shape": list(key74[1]), "negated": neg,
               "nan_logdet": nan_at(out_n[1]),
               "nan_logdet_before": nan_at(out_k[1]),
               "plain_nan_logdet": nan_at(out_np[1]),
               "plain_nan_logdet_before": nan_at(out_p[1]),
               "others_bitwise_equal": bool(all(
                   torch.equal(a[keep].view(torch.int32),
                               b[keep].view(torch.int32))
                   for a, b in zip(out_n, out_k)))}
    nan_rec["ok"] = bool(
        set(nan_rec["nan_logdet"])
        == set(neg) | set(nan_rec["nan_logdet_before"])
        and set(nan_rec["plain_nan_logdet"])
        == set(neg) | set(nan_rec["plain_nan_logdet_before"])
        and nan_rec["others_bitwise_equal"])
    srep["negated_factors"] = nan_rec
    print(f"# chol_fused {list(key74[1])} with two matrices negated: "
          f"{json.dumps(nan_rec)}", flush=True)
    if not nan_rec["ok"]:
        fail("a negated matrix at (1024, 74) leaked out of its own matrix")
    del S_neg, out_n, out_np, out_p
    time_captured(captured_lp, "sample")
    time_captured(captured_l1, "lnlikelihood")
    # the kernel beside its block form and the library call, in turns
    turns74 = srep["chol74_turns"] = {}
    for key, capt in ((key74, captured_lp), (key1, captured_l1)):
        a_ = capt[key]
        arms = {"kernel": (chol.chol_fused, a_),
                "block form": (lambda S, r: chol.chol_fused(S, r,
                                                            per_block=0), a_),
                "cholesky_ex": (lambda S, r: torch.linalg.cholesky_ex(S),
                                a_)}
        t_ = {arm: [] for arm in arms}
        for arm in ("kernel", "block form", "cholesky_ex", "cholesky_ex",
                    "block form", "kernel"):
            t_[arm].append(timed(arms[arm][0], arms[arm][1], 50))
        turns74[str(list(key[1]))] = t_
        print(f"# chol_fused {list(key[1])} in turns: " + ", ".join(
            f"{arm} {' / '.join(f'{v:.5f}' for v in ms)} ms"
            for arm, ms in t_.items()) + f" | {card}", flush=True)
    del captured_lp, captured_l1, args74, out_k
    lnl_cpu = tb.TorchGibbs(ma, cfg, nchains=8, device="cpu")
    lnl = []
    for c in range(8):
        pt = [getattr(st0, f)[c].cpu().numpy() for f in ("x", "z", "alpha")]
        lnl.append((sampler.lnlikelihood(*pt), lnl_cpu.lnlikelihood(*pt)))
    lnl = np.asarray(lnl)
    lnl_rel = float(np.max(np.abs(lnl[:, 0] - lnl[:, 1])
                           / np.abs(lnl[:, 1])))
    srep["lnlikelihood"] = {"card_cpu": lnl.tolist(), "max_rel": lnl_rel}
    print(f"# lnlikelihood card vs cpu (8 points): max rel {lnl_rel:.3e}",
          flush=True)
    # tolerance: float32 roundoff, rtol 1e-5
    if not np.isfinite(lnl).all() or lnl_rel > 1e-5:
        fail("lnlikelihood on the card disagrees with the CPU")

    # what the telemetry adds: its per-sweep update and its per-chunk
    # log-posterior, profiled here (outside the counted runs below)
    tl0 = telemetry_init(sampler._batch, dev)
    up = profile_calls(torch, lambda: telemetry_update(tl0, st0), 20)
    lp = profile_calls(torch, lambda: sampler._logpost_chain(st0), 3)

    # the runs of 12b-f: one seed, from the phase-5 state, counted as the
    # "sample" path (sweeps, and chunks of telemetry-on runs)
    reset_counts()
    tally = {"sweeps": 0, "chunks": 0}

    def run_from(niter, record="full", seed=5, state=st0, start=s0,
                 **kw):
        """``(sampler, result, wall s)`` of one ``sample`` call of a fresh
        flagship sampler."""
        smp = tb.TorchGibbs(ma, cfg, nchains=NCHAINS, device=dev,
                            record=record, **{k: v for k, v in kw.items()
                                              if k != "reinit_diverged"})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = smp.sample(niter=niter, seed=seed, state=state,
                         start_sweep=start,
                         reinit_diverged=kw.get("reinit_diverged", False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tally["sweeps"] += niter
        tally["chunks"] += chunks_of(smp, niter) if smp.telemetry else 0
        return smp, res, wall

    # 12b. the record tiers: the exact fields bitwise equal, the cast ones
    # within their wire precision; run in turns (walls of both turns),
    # and the host's time to turn one chunk's pulled records back into
    # float32 arrays
    tiers = {}
    for record in ("compact8", "compact", "full", "full", "compact",
                   "compact8"):
        smp, res, wall = run_from(TIER_SWEEPS, record)
        tiers[record] = (smp, res)
        rep = srep.setdefault(f"tier_{record}", {"ms_per_sweep": []})
        rep["ms_per_sweep"].append(1e3 * wall / TIER_SWEEPS)
    for record, (smp, _) in tiers.items():
        one = tb.record_tuple(st0, smp._record_fields, smp._record_casts)
        pulled = tb._HostCopy(
            [t.expand(smp.chunk_size, *t.shape).contiguous() for t in one],
            torch.cuda.Stream(dev)).wait()
        t0 = time.perf_counter()
        smp._materialize(pulled)
        per_row = sum(t.numel() * t.element_size() for t in one)
        srep[f"tier_{record}"].update(
            bytes_per_row=per_row, bytes_per_chunk=per_row * smp.chunk_size,
            host_materialize_ms_per_chunk=1e3 * (time.perf_counter() - t0))
    f_res = tiers["full"][1]
    exact = ("chain", "thetachain", "dfchain", "zchain")
    for record in ("compact8", "compact"):
        c_res = tiers[record][1]
        same = all(np.array_equal(getattr(c_res, k), getattr(f_res, k))
                   for k in exact) and all(
            np.array_equal(c_res.stats[k], f_res.stats[k])
            for k in ("acc_white", "acc_hyper"))
        # one bfloat16 step: 2^-7 of the magnitude; pout: half a uint8
        # level (1/510) or one float16 step (2^-10 of the magnitude, 2^-24
        # below the normal range)
        bf = max(float(np.max(np.abs(getattr(c_res, k) - getattr(f_res, k))
                              / np.maximum(np.abs(getattr(f_res, k)),
                                           1e-30)))
                 for k in ("bchain", "alphachain"))
        dp = np.abs(c_res.poutchain - f_res.poutchain)
        pout_ok = bool((dp <= (1.0 / 510 + 1e-7 if record == "compact8"
                               else np.abs(f_res.poutchain) * 2.0 ** -10
                               + 2.0 ** -24)).all())
        srep[f"tier_{record}"].update(
            exact_fields_bitwise=same, b_alpha_max_rel=bf,
            pout_max_abs=float(dp.max()), pout_ok=pout_ok)
        if not (same and bf <= 2.0 ** -7 and pout_ok):
            fail(f"record={record!r} departs from record='full' beyond its "
                 "wire precision")
    tier_lines = [
        f"{r} {np.round(t['ms_per_sweep'], 4).tolist()} ms/sweep "
        f"{t['bytes_per_chunk'] / 1e6:.2f} MB/chunk, host materialize "
        f"{t['host_materialize_ms_per_chunk']:.1f} ms/chunk"
        for r, t in ((r, srep[f"tier_{r}"])
                     for r in ("compact8", "compact", "full"))]
    print("# record tiers (200 sweeps from one state, two turns): "
          + "; ".join(tier_lines) + f" | {card}", flush=True)

    # 12c. thinning: row k of record_thin=5 is row 5k, bitwise
    _, t_res, _ = run_from(TIER_SWEEPS, record_thin=5)
    thin_ok = t_res.chain.shape[0] == TIER_SWEEPS // 5 and all(
        np.array_equal(getattr(t_res, k), getattr(f_res, k)[::5])
        for k in ("chain", "bchain", "zchain", "alphachain", "poutchain",
                  "thetachain", "dfchain"))
    srep["thin_rows_bitwise"] = bool(thin_ok)
    if not thin_ok:
        fail("record_thin=5 rows are not rows 5k of the unthinned run")

    # 12d. telemetry: chains bitwise with it off; accept sums against the
    # records (rows hold the PRE-sweep state: shifted by one, plus the
    # final state); the launches it adds; the wall with it on and off
    f_smp = tiers["full"][0]
    walls = {"on": [], "off": []}
    for rep in range(2):
        for key, tele in (("off", False), ("on", True)):
            smp, res, wall = run_from(TIER_SWEEPS, telemetry=tele)
            walls[key].append(1e3 * wall / TIER_SWEEPS)
            if key == "off" and rep == 0:
                off_res = res
    tele_bitwise = all(np.array_equal(getattr(off_res, k), getattr(f_res, k))
                       for k in ("chain", "bchain", "zchain", "alphachain",
                                 "poutchain", "thetachain", "dfchain"))
    acc_rel = 0.0
    for blk in ("white", "hyper"):
        rec_acc = f_res.stats[f"acc_{blk}"].astype(np.float64)
        want = (rec_acc[1:].sum(0) + getattr(
            f_smp.last_state, f"acc_{blk}").cpu().numpy()) / TIER_SWEEPS
        got = f_res.stats[f"tele_accept_{blk}"]
        acc_rel = max(acc_rel, float(np.max(np.abs(got - want)
                                            / np.maximum(want, 1e-30))))
    lp_finite = bool(np.isfinite(f_res.stats["tele_logpost"]).all())
    srep["telemetry"] = {
        "chains_bitwise_on_off": tele_bitwise,
        "accept_max_rel_vs_records": acc_rel,
        "logpost_finite": lp_finite,
        "launches_per_sweep": up["launches_per_sweep"],
        "device_ms_per_sweep": up["device_ms_per_sweep"],
        "launches_per_chunk": lp["launches_per_sweep"],
        "device_ms_per_chunk": lp["device_ms_per_sweep"],
        "ms_per_sweep_on": walls["on"], "ms_per_sweep_off": walls["off"]}
    print(f"# telemetry: +{up['launches_per_sweep']:.1f} launches/sweep "
          f"({up['device_ms_per_sweep']:.4f} ms device), "
          f"+{lp['launches_per_sweep']:.1f} launches/chunk "
          f"({lp['device_ms_per_sweep']:.4f} ms device); wall on "
          f"{walls['on']} off {walls['off']} ms/sweep | {card}", flush=True)
    # tolerance: the accept sums to float32 roundoff (1e-5 relative)
    if not (tele_bitwise and acc_rel <= 1e-5 and lp_finite):
        fail("telemetry changed the chains, or its sums or log-posterior "
             "are wrong")

    # 12e. recovery: NaN in x and b of 5 chains, alpha = 0 on every TOA of
    # 2 more (a lone alpha = 0 heals in its first sweep: the alpha draw
    # replaces it); exactly those 7 are flagged and re-drawn at the first
    # chunk boundary, every other chain runs bitwise as without them
    dead_xb, dead_a = [3, 100, 511, 777, 1000], [42, 900]
    x_i, b_i, a_i = st0.x.clone(), st0.b.clone(), st0.alpha.clone()
    x_i[dead_xb] = float("nan")
    b_i[dead_xb] = float("nan")
    a_i[dead_a] = 0.0
    injected = st0._replace(x=x_i, b=b_i, alpha=a_i)
    flagged = np.flatnonzero(sampler.diverged_mask(injected))
    want_dead = sorted(dead_xb + dead_a)
    kw = dict(seed=9, chunk_size=RECOVERY_CHUNK, reinit_diverged=True)
    smp_i, r_inj, _ = run_from(2 * RECOVERY_CHUNK, state=injected, **kw)
    smp_c, r_cln, _ = run_from(2 * RECOVERY_CHUNK, **kw)
    keep = np.setdiff1d(np.arange(NCHAINS), want_dead)
    keep_t = torch.as_tensor(keep, device=dev)
    healthy_bitwise = all(
        np.array_equal(getattr(r_inj, k)[:, keep], getattr(r_cln, k)[:, keep])
        for k in ("chain", "bchain", "zchain", "alphachain", "poutchain",
                  "thetachain", "dfchain")) and all(
        torch.equal(a[keep_t], b[keep_t])
        for a, b in zip(smp_i.last_state, smp_c.last_state))
    end_finite = not smp_i.diverged_mask(smp_i.last_state).any()
    srep["recovery"] = {
        "flagged": flagged.tolist(),
        "n_reinits": int(r_inj.stats["n_reinits"]),
        "n_reinits_clean": int(r_cln.stats["n_reinits"]),
        "healthy_bitwise": healthy_bitwise, "all_finite_at_end": end_finite}
    print(f"# recovery: {json.dumps(srep['recovery'])}", flush=True)
    if (flagged.tolist() != want_dead or srep["recovery"]["n_reinits"] != 7
            or srep["recovery"]["n_reinits_clean"] != 0
            or not healthy_bitwise or not end_finite):
        fail("divergence recovery did not re-draw exactly the injected "
             "chains, or touched the healthy ones")

    # 12f. sample_until at the flagship (its first ADAPT sweeps adapt),
    # checks every UNTIL_CHECK sweeps; its first rows are a plain
    # sample's of the same length
    smp_u = tb.TorchGibbs(ma, cfg, nchains=NCHAINS, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_u = smp_u.sample_until(rhat_target=1.01, max_sweeps=UNTIL_MAX,
                             check_every=UNTIL_CHECK, seed=13)
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t0
    n_u = r_u.chain.shape[0]
    tally["sweeps"] += n_u
    tally["chunks"] += sum(chunks_of(smp_u, UNTIL_CHECK)
                           for _ in range(n_u // UNTIL_CHECK))
    _, r_p, _ = run_from(UNTIL_CHECK, record="compact8", seed=13,
                         state=None, start=0)
    first_bitwise = all(
        np.array_equal(getattr(r_u, k)[:UNTIL_CHECK], getattr(r_p, k))
        for k in ("chain", "bchain", "zchain", "alphachain", "poutchain",
                  "thetachain", "dfchain"))
    window = r_u.chain[n_u // 2:]
    ess_u = ess_per_param(window)
    srep["sample_until"] = {
        "sweeps": n_u, "wall_s": wall_u,
        "converged": bool(r_u.stats["converged"]),
        "rhat": r_u.stats["rhat"].tolist(),
        "ess_window": ess_u.tolist(),
        "ess_log10A_per_s": float(ess_u[ia] / wall_u),
        "first_rows_bitwise": first_bitwise}
    print(f"# sample_until (check every {UNTIL_CHECK}, max {UNTIL_MAX}): "
          f"{n_u} sweeps in {wall_u:.2f} s, converged "
          f"{srep['sample_until']['converged']}, split-R-hat "
          f"{np.round(r_u.stats['rhat'], 4).tolist()}, ESS(log10_A)/s "
          f"{srep['sample_until']['ess_log10A_per_s']:.1f} | {card}",
          flush=True)
    if not first_bitwise or r_u.stats["rhat_history"].shape[0] != (
            n_u // UNTIL_CHECK):
        fail("sample_until's rows are not a plain sample's")
    check_launches("sample", tally["sweeps"], tally["chunks"])

    # the ensemble's sample_until: 4 pulsars x 32 chains, compact8
    ens_u = EnsembleGibbs(ens_pulsars(4), cfg_e, nchains=32, device=dev)
    r_e = ens_u.sample_until(rhat_target=1.05, max_sweeps=4 * UNTIL_CHECK,
                             check_every=UNTIL_CHECK, seed=3)
    ens_ok = (int(r_e.stats["tele_sweeps"]) == r_e.chain.shape[0]
              and r_e.stats["tele_logpost"].shape == (4, 32)
              and np.isfinite(r_e.stats["tele_logpost"]).all()
              and not r_e.stats["tele_diverged"].any()
              and np.array_equal(r_e.stats["n_toa"], ens_u.n_toa)
              and r_e.stats["rhat"].shape == (4, ma.nparam)
              and str(r_e.stats["record_mode"]) == "compact8"
              and np.isfinite(r_e.chain).all())
    srep["ensemble_sample_until"] = {
        "sweeps": r_e.chain.shape[0],
        "converged": bool(r_e.stats["converged"]),
        "rhat_max": float(r_e.stats["rhat"].max()),
        "n_toa": r_e.stats["n_toa"].tolist(), "ok": bool(ens_ok)}
    print(f"# ensemble sample_until: "
          f"{json.dumps(srep['ensemble_sample_until'])}", flush=True)
    if not ens_ok:
        fail("the ensemble's sample_until result is malformed")

    # --- 13. resumable runs and the drivers ------------------------------
    import contextlib
    import io
    import shutil
    import tempfile

    from gibbs_student_t_tpu_torch.drivers import run_sims as drv_run
    from gibbs_student_t_tpu_torch.drivers import simulate_data as drv_sim
    from gibbs_student_t_tpu_torch.obs.ledger import read_ledger
    from gibbs_student_t_tpu_torch.obs.metrics import read_events
    from gibbs_student_t_tpu_torch.utils import spool as spool_mod
    from gibbs_student_t_tpu_torch.utils.spoolfile import spool_info

    t13 = time.perf_counter()
    rrep = report["resume"] = {}
    tmp = tempfile.mkdtemp(prefix="gst_chip_smoke_")
    chains = ("chain", "bchain", "zchain", "alphachain", "poutchain",
              "thetachain", "dfchain")

    def eq(u, v):
        """Bitwise equal arrays (a NaN of a dead chain equal to itself)."""
        u, v = np.asarray(u), np.asarray(v)
        return np.array_equal(u, v, equal_nan=u.dtype.kind == "f")

    def same(a, b):
        """Every recorded field and every stat bitwise equal."""
        return (all(eq(getattr(a, f), getattr(b, f)) for f in chains)
                and sorted(a.stats) == sorted(b.stats)
                and all(eq(a.stats[k], b.stats[k]) for k in a.stats))

    def same_rows(a, b):
        """Every recorded field and the accept rates bitwise equal."""
        return all(eq(getattr(a, f), getattr(b, f)) for f in chains) and all(
            eq(a.stats[k], b.stats[k]) for k in ("acc_white", "acc_hyper"))

    def same_state(s1, s2):
        return all(torch.equal(u, v.to(u.device)) for u, v in zip(s1, s2))

    def append_orphans(d, rows):
        """A kill after a chunk's rows were written and before its
        checkpoint: ``rows`` orphan rows and a torn partial row on every
        spool file of ``d``."""
        for name in os.listdir(d):
            if name.endswith(".spool"):
                path = os.path.join(d, name)
                dtype, shape, _, _ = spool_info(path)
                with open(path, "ab") as fh:
                    fh.write(np.full((rows,) + shape, 7.0, dtype).tobytes())
                    fh.write(b"\x00\x01\x02")

    # the spool's host cost: seconds in ChainSpool.append (rows and
    # checkpoint written) and the bytes of the rows
    spool_io = {"s": 0.0, "bytes": 0, "appends": 0}
    plain_append = spool_mod.ChainSpool.append

    def timed_append(self, records, *args, **kw):
        t0 = time.perf_counter()
        plain_append(self, records, *args, **kw)
        spool_io["s"] += time.perf_counter() - t0
        spool_io["bytes"] += sum(a.nbytes for a in records.values())
        spool_io["appends"] += 1

    spool_mod.ChainSpool.append = timed_append
    try:
        # 13a. the solo spool at the flagship: 1024 chains, adapt 100 with
        # population-covariance proposals, chunk 100, compact8
        reset_counts()
        tally = {"sweeps": 0, "chunks": 0}

        def solo(**kw):
            return tb.TorchGibbs(ma, cfg, nchains=NCHAINS, device=dev,
                                 chunk_size=SPOOL_CHUNK, **kw)

        def run(smp, niter, **kw):
            """``(result, wall s)`` of one ``sample`` call."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = smp.sample(niter=niter, seed=21, **kw)
            torch.cuda.synchronize()
            tally["sweeps"] += niter
            tally["chunks"] += chunks_of(smp, niter)
            return res, time.perf_counter() - t0

        walls = {"memory": [], "spool": []}
        spooled, in_memory = [], []
        for turn, kind in enumerate(("memory", "spool")):
            smp = solo()
            d = os.path.join(tmp, f"solo_{turn}")
            res, wall = run(smp, SPOOL_SWEEPS,
                            spool_dir=d if kind == "spool" else None)
            walls[kind].append(1e3 * wall / SPOOL_SWEEPS)
            (spooled if kind == "spool" else in_memory).append(
                (smp, res, d))
        io_runs = dict(spool_io)
        m_smp, m_res, _ = in_memory[0]
        s_smp, s_res, s_dir = spooled[0]
        ck_state, ck_sweep, ck_seed = spool_mod.load_spool_state(s_dir)
        solo_ok = {
            "spooled_equals_in_memory": same(s_res, m_res),
            "last_state_equal": same_state(s_smp.last_state,
                                           m_smp.last_state),
            "checkpoint_is_last_state": (
                same_state(ck_state, m_smp.last_state)
                and (ck_sweep, ck_seed) == (SPOOL_SWEEPS, 21))}

        # killed: 200 sweeps spooled, then a torn row and one whole orphan
        # chunk on every file; resumed from its checkpoint for 100 more
        k_dir = os.path.join(tmp, "killed")
        run(solo(), SPOOL_SWEEPS - SPOOL_CHUNK, spool_dir=k_dir)
        append_orphans(k_dir, SPOOL_CHUNK)
        st_k, sw_k, sd_k = spool_mod.load_spool_state(k_dir)
        k_smp = solo()
        k_res, _ = run(k_smp, SPOOL_CHUNK, state=st_k, start_sweep=sw_k,
                       spool_dir=k_dir)
        solo_ok["killed_resumes_to_unbroken"] = bool(
            sw_k == SPOOL_SWEEPS - SPOOL_CHUNK and sd_k == 21
            and same_rows(k_res, s_res)
            and same_state(k_smp.last_state, s_smp.last_state))

        # record_thin=5: a chunk spooled, then a whole orphan chunk of
        # thinned rows and a torn row, a chunk more: rows 5k of the
        # unthinned run. The kill falls on the unbroken run's chunk
        # boundary: inside the adaptation window the proposal covariance
        # is re-estimated at chunk boundaries, so a resume mid-chunk would
        # continue another chain
        t_dir = os.path.join(tmp, "thin")
        run(solo(record_thin=5), SPOOL_CHUNK, spool_dir=t_dir)
        append_orphans(t_dir, SPOOL_CHUNK // 5)
        st_t, sw_t, _ = spool_mod.load_spool_state(t_dir)
        t_res, _ = run(solo(record_thin=5), SPOOL_CHUNK, state=st_t,
                       start_sweep=sw_t, spool_dir=t_dir)
        solo_ok["thinned_rows_bitwise"] = bool(
            t_res.chain.shape[0] == 2 * SPOOL_CHUNK // 5 and all(
                np.array_equal(getattr(t_res, f),
                               getattr(m_res, f)[:2 * SPOOL_CHUNK:5])
                for f in chains) and int(t_res.stats["record_thin"]) == 5)

        # a resume that changes the recording is refused (before any row
        # is written: the spool stays as it was)
        refused = []
        for kw in ({"record": "full"}, {"record_thin": 5}):
            try:
                run(solo(**kw), 5, state=st_k, start_sweep=sw_k,
                    spool_dir=k_dir)
            except ValueError as exc:
                # raised by the chunk's flush: its sweeps were launched
                tally["sweeps"] += 5
                tally["chunks"] += 1
                refused.append(str(exc)[:80])
        solo_ok["mismatched_resume_refused"] = len(refused) == 2 and same_rows(
            spool_mod.load_spool(k_dir), s_res)

        # n_reinits: 3 dead chains at sweep 300, two chunks of 10 sweeps
        # with reinit_diverged, in memory and spooled, and spooled killed
        # after the first chunk and resumed
        st300 = m_smp.last_state
        x_d, a_d = st300.x.clone(), st300.alpha.clone()
        x_d[[1, NCHAINS // 2]] = float("nan")
        a_d[NCHAINS - 1] = 0.0                  # every TOA of the chain
        dead = st300._replace(x=x_d, alpha=a_d)
        rkw = dict(state=dead, start_sweep=SPOOL_SWEEPS, reinit_diverged=True)
        rs = {}
        for kind in ("memory", "spool"):
            smp = tb.TorchGibbs(ma, cfg, nchains=NCHAINS, device=dev,
                                chunk_size=RECOVERY_CHUNK)
            d = os.path.join(tmp, "reinit") if kind == "spool" else None
            rs[kind] = (smp, run(smp, 2 * RECOVERY_CHUNK, spool_dir=d,
                                 **rkw)[0])
        ck_r, _, _ = spool_mod.load_spool_state(os.path.join(tmp, "reinit"))
        d2 = os.path.join(tmp, "reinit_killed")
        run(tb.TorchGibbs(ma, cfg, nchains=NCHAINS, device=dev,
                          chunk_size=RECOVERY_CHUNK), RECOVERY_CHUNK,
            spool_dir=d2, **rkw)
        st_r, sw_r, _ = spool_mod.load_spool_state(d2)
        rk_res, _ = run(tb.TorchGibbs(ma, cfg, nchains=NCHAINS, device=dev,
                                      chunk_size=RECOVERY_CHUNK),
                        RECOVERY_CHUNK, state=st_r, start_sweep=sw_r,
                        spool_dir=d2, reinit_diverged=True)
        n_re = int(rs["memory"][1].stats["n_reinits"])
        solo_ok["reinit_spooled_equals_in_memory"] = bool(
            n_re == 3 and same(rs["spool"][1], rs["memory"][1])
            and same_state(ck_r, rs["memory"][0].last_state))
        solo_ok["reinit_count_carried_over_resume"] = bool(
            int(rk_res.stats["n_reinits"]) == n_re
            and same_rows(rk_res, rs["memory"][1]))

        # 13e. a spooled run of two 10-sweep chunks from the state at sweep
        # 300, unprofiled, profiled, unprofiled: the idle share is taken
        # against the unprofiled wall, as every other profile's
        p_smp = tb.TorchGibbs(ma, cfg, nchains=NCHAINS, device=dev,
                              chunk_size=PROFILE_CHUNK)
        p_runs = iter(range(3))

        def p_call():
            p_smp.sample(niter=2 * PROFILE_CHUNK, seed=21, state=st300,
                         start_sweep=SPOOL_SWEEPS,
                         spool_dir=os.path.join(tmp, f"prof_{next(p_runs)}"))

        p_walls = []
        for i in range(3):
            if i == 1:
                prof = profile_calls(torch, p_call, 1)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p_call()
                torch.cuda.synchronize()
                p_walls.append(1e3 * (time.perf_counter() - t0))
            tally["sweeps"] += 2 * PROFILE_CHUNK
            tally["chunks"] += 2
        check_launches("spool", tally["sweeps"], tally["chunks"])
        rrep["solo"] = solo_ok
        print(f"# spool, solo (flagship, {NCHAINS} chains, chunk "
              f"{SPOOL_CHUNK}): {json.dumps(solo_ok)}; refused: {refused}",
              flush=True)
        if not all(solo_ok.values()):
            fail("a spooled or resumed solo run departs from the in-memory "
                 "run")
        row_bytes = io_runs["bytes"] / SPOOL_SWEEPS
        p_wall = sum(p_walls) / len(p_walls)
        prof_idle = 1.0 - prof["device_ms_per_sweep"] / p_wall
        cost = rrep["cost"] = {
            "ms_per_sweep_memory": walls["memory"],
            "ms_per_sweep_spool": walls["spool"],
            "row_bytes": row_bytes,
            "spool_mb": io_runs["bytes"] / 1e6,
            "spool_append_s": io_runs["s"],
            "spool_mb_per_s": io_runs["bytes"] / 1e6 / io_runs["s"],
            "append_ms_per_chunk": 1e3 * io_runs["s"] / io_runs["appends"],
            "profile_ms_per_sweep_wall": p_wall / (2 * PROFILE_CHUNK),
            "profile_ms_per_sweep_walls": [w / (2 * PROFILE_CHUNK)
                                           for w in p_walls],
            "profile_ms_per_sweep_profiled": (prof["wall_ms_per_sweep"]
                                              / (2 * PROFILE_CHUNK)),
            "profile_ms_per_sweep_device": (prof["device_ms_per_sweep"]
                                            / (2 * PROFILE_CHUNK)),
            "profile_idle": prof_idle}

        rrep["solo_s"] = time.perf_counter() - t13
        t13b = time.perf_counter()

        # 13b. the ensemble's spool: ens32's pulsars, 256 chains each,
        # light records, chunk 10; killed at sweep 20 and resumed
        reset_counts()
        tally = {"sweeps": 0, "chunks": 0}

        def ens_run(e, niter, **kw):
            res = e.sample(niter=niter, seed=7, **kw)
            tally["sweeps"] += niter
            tally["chunks"] += chunks_of(e, niter)
            return res

        # one sampler for the three runs: a run reads nothing of the
        # sampler's earlier runs
        e_smp = EnsembleGibbs(ens_pulsars(ENS_PULSARS), cfg_e,
                              nchains=ENS_CHAINS, device=dev, record="light",
                              chunk_size=RECOVERY_CHUNK)
        e_ref = ens_run(e_smp, 4 * RECOVERY_CHUNK)
        e_dir = os.path.join(tmp, "ens32")
        ens_run(e_smp, 2 * RECOVERY_CHUNK, spool_dir=e_dir)
        append_orphans(e_dir, RECOVERY_CHUNK)
        st_e, sw_e, _ = spool_mod.load_spool_state(e_dir)
        e_res = ens_run(e_smp, 2 * RECOVERY_CHUNK, state=st_e,
                        start_sweep=sw_e, spool_dir=e_dir)
        n_toa = e_smp.n_toa
        ens_ok = {
            "killed_resumes_to_unbroken": bool(
                sw_e == 2 * RECOVERY_CHUNK and same_rows(e_res, e_ref)
                and e_res.chain.shape == (4 * RECOVERY_CHUNK, ENS_PULSARS,
                                          ENS_CHAINS, ma.nparam)),
            "select_pulsar_keeps_toas": bool(
                len(set(n_toa.tolist())) == 3 and all(
                    int(e_res.select_pulsar(i).stats["n_toa"]) == n_toa[i]
                    for i in range(ENS_PULSARS)))}

        # 13c. sample_until with a spool on 4 x 32 chains: the rows of the
        # in-memory sample_until above, once each
        ens_u2 = EnsembleGibbs(ens_pulsars(4), cfg_e, nchains=32, device=dev)
        u_dir = os.path.join(tmp, "until")
        r_us = ens_u2.sample_until(rhat_target=1.05,
                                   max_sweeps=4 * UNTIL_CHECK,
                                   check_every=UNTIL_CHECK, seed=3,
                                   spool_dir=u_dir)
        n_us = r_us.chain.shape[0]
        tally["sweeps"] += n_us
        tally["chunks"] += (n_us // UNTIL_CHECK) * chunks_of(ens_u2,
                                                            UNTIL_CHECK)
        ens_ok["until_rows_once"] = bool(
            spool_info(os.path.join(u_dir, "x.spool"))[3] == n_us
            and int(r_us.stats["tele_sweeps"]) == n_us
            and same_rows(r_us, r_e))
        check_launches("spool_ens", tally["sweeps"], tally["chunks"])
        rrep["ensemble"] = ens_ok
        print(f"# spool, ensemble (ens32's pulsars x {ENS_CHAINS} chains, "
              f"killed at sweep {sw_e}; sample_until 4 x 32, {n_us} "
              f"sweeps): {json.dumps(ens_ok)}", flush=True)
        if not all(ens_ok.values()):
            fail("a spooled or resumed ensemble run departs from the "
                 "in-memory run")
        del e_ref, e_res, e_smp
        rrep["ensemble_s"] = time.perf_counter() - t13b

        # 13d. the drivers on the card: simulate, then the five models on
        # both twins, then an 8-pulsar ensemble
        simd = os.path.join(tmp, "sim")
        tele_d = os.path.join(tmp, "tele")
        trace_d = os.path.join(tmp, "trace")
        ledger_p = os.path.join(tmp, "ledger.jsonl")
        common = ["--thetas", "0.1", "--seed", "5", "--simdir", simd,
                  "--niter", str(DRIVER_SWEEPS), "--burn",
                  str(DRIVER_BURN)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            drv_sim.main(["--theta", "0.1", "--seed", "5", "--outdir",
                          simd])
        sim_dirs = out.getvalue().split()
        reset_counts()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            drv_run.main(common + [
                "--device", "cuda", "--nchains", str(NCHAINS),
                "--outdirs", os.path.join(tmp, "o1"),
                os.path.join(tmp, "o2"),
                "--telemetry-dir", tele_d, "--ledger", ledger_p])
        drv_wall = time.perf_counter() - t0
        n_cfg = 5 * 2
        check_launches("drivers", n_cfg * DRIVER_SWEEPS,
                       n_cfg * -(-DRIVER_SWEEPS // 100))
        trees = out.getvalue().split()
        shapes_ok = len(trees) == n_cfg
        finite = True
        for tree in trees:
            for f in chains:
                a = np.load(os.path.join(tree, f + ".npy"))
                finite &= bool(np.isfinite(a).all())
                if f == "chain":
                    shapes_ok &= a.shape == (DRIVER_SWEEPS - DRIVER_BURN,
                                             NCHAINS, 3)
        events = read_events(tele_d)
        ledger_recs = read_ledger(ledger_p)
        drv = rrep["drivers"] = {
            "simulated": sim_dirs, "trees": len(trees),
            "chain_shapes_ok": bool(shapes_ok), "all_finite": finite,
            "chunk_events": sum(e["event"] == "chunk" for e in events),
            "ledger_records": len(ledger_recs),
            "ledger_platform": [r.get("platform") for r in ledger_recs],
            "wall_s": drv_wall,
            "ms_per_sweep": 1e3 * drv_wall / (n_cfg * DRIVER_SWEEPS)}
        # the trace: a torch.profiler capture of a whole config's sampling
        # (obs/tracing.py) costs ~6 s a 200-sweep config at the flagship
        # (the profiler's processing and export of ~460k events), so one
        # config, the ensemble's, is traced
        reset_counts()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            drv_run.main(common + [
                "--device", "cuda", "--ensemble", str(DRIVER_ENS),
                "--nchains", str(DRIVER_ENS_CHAINS), "--models", "beta",
                "--outdirs", os.path.join(tmp, "e1"),
                os.path.join(tmp, "e2"), "--trace-dir", trace_d,
                "--ledger", ""])
        drv["ensemble_wall_s"] = time.perf_counter() - t0
        check_launches("drivers_ens", DRIVER_SWEEPS,
                       -(-DRIVER_SWEEPS // 50))
        traces = [f for f in os.listdir(trace_d) if f.endswith(".json")]
        drv["traces"] = len(traces)
        drv["trace_mb"] = sum(os.path.getsize(os.path.join(trace_d, f))
                              for f in traces) / 1e6
        spans = 0
        for f in traces:
            with open(os.path.join(trace_d, f), "rb") as fh:
                spans += fh.read().count(b'"gibbs/hyper_mh"')
        drv["trace_hyper_spans"] = spans
        e_trees = out.getvalue().split()
        drv["ensemble_toas"] = [
            int(np.load(os.path.join(t, "zchain.npy")).shape[-1])
            for t in e_trees]
        drv["ensemble_ok"] = bool(
            len(e_trees) == DRIVER_ENS
            and drv["ensemble_toas"] == [130 - (i % 3) * 10
                                         for i in range(DRIVER_ENS)])
        print(f"# drivers: {json.dumps(drv)}", flush=True)
        if not (len(sim_dirs) == 2 and drv["trees"] == n_cfg and shapes_ok
                and finite and drv["chunk_events"] == n_cfg * -(
                    -DRIVER_SWEEPS // 100)
                and drv["traces"] == 1 and spans >= DRIVER_SWEEPS
                and drv["ledger_records"] == 1
                and drv["ledger_platform"] == ["cuda"]
                and drv["ensemble_ok"]):
            fail("the drivers' run on the card is malformed")
    finally:
        spool_mod.ChainSpool.append = plain_append
        shutil.rmtree(tmp, ignore_errors=True)

    # 13e. the spool's cost lines
    print(f"# spool cost (flagship, {NCHAINS} chains, compact8, chunk "
          f"{SPOOL_CHUNK}, {SPOOL_SWEEPS} sweeps, in turns memory/spool): "
          f"in memory "
          f"{np.round(cost['ms_per_sweep_memory'], 4).tolist()} ms/sweep, "
          f"spooled {np.round(cost['ms_per_sweep_spool'], 4).tolist()} "
          f"ms/sweep; {cost['row_bytes'] / 1e6:.3f} MB a row, "
          f"{cost['spool_mb']:.1f} MB written at "
          f"{cost['spool_mb_per_s']:.1f} MB/s "
          f"({cost['append_ms_per_chunk']:.1f} ms a chunk with the "
          f"checkpoint) | {card}", flush=True)
    print(f"# spool profile (2 spooled chunks of {PROFILE_CHUNK} sweeps): "
          f"wall {cost['profile_ms_per_sweep_wall']:.4f} ms/sweep unprofiled "
          f"(the mean of "
          f"{np.round(cost['profile_ms_per_sweep_walls'], 4).tolist()}; "
          f"{cost['profile_ms_per_sweep_profiled']:.4f} profiled), device "
          f"{cost['profile_ms_per_sweep_device']:.4f} ms/sweep, idle share "
          f"{cost['profile_idle']:.4f} | {card}", flush=True)
    rrep["seconds"] = time.perf_counter() - t13
    print(f"# phase 13: {rrep['seconds']:.1f} s (solo spool "
          f"{rrep['solo_s']:.1f} s, ensemble spool {rrep['ensemble_s']:.1f} "
          f"s, drivers {drv['wall_s']:.1f} s, the traced ensemble driver "
          f"{drv['ensemble_wall_s']:.1f} s with a {drv['trace_mb']:.1f} MB "
          f"trace)", flush=True)

    # --- 14. per-chain draws ----------------------------------------------
    t14 = time.perf_counter()
    drep = report["draws"] = {}

    def f32_ulps(a, b):
        """Per-element distance of two float32 tensors in ulps (the
        distance of their bit patterns; same-sign values)."""
        return (a.contiguous().view(torch.int32).long()
                - b.contiguous().view(torch.int32).long()).abs()

    def draw_cmp(table, va, vb):
        """Two sets of raw draws (``DrawTable.views``; ``vb`` the
        reference) field kind by kind: uniforms bitwise; for the other
        kinds the values that differ and the largest distance in ulps; a
        gamma more than one ulp away is counted as accepted at another
        Marsaglia-Tsang attempt (its value is then unrelated)."""
        rec = {"values": 0, "uniform_bitwise": True, "differ": 0,
               "max_ulps": 0, "gamma_other_attempt": 0,
               "nonfinite_mismatch": 0, "max_abs_err": 0.0}
        for f in table.fields:
            a, b = va[f.name].reshape(-1), vb[f.name].reshape(-1)
            fa, fb = torch.isfinite(a), torch.isfinite(b)
            rec["values"] += a.numel()
            rec["nonfinite_mismatch"] += int((fa != fb).sum())
            both = fa & fb
            a, b = a[both], b[both]
            if a.numel():
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         float((a - b).abs().max()))
            if f.kind == rng.UNIFORM:
                rec["uniform_bitwise"] &= bool(torch.equal(a, b))
                continue
            u = f32_ulps(a, b)
            if f.kind == rng.GAMMA:
                far = u > 1
                rec["gamma_other_attempt"] += int(far.sum())
                u = torch.where(far, torch.zeros_like(u), u)
            rec["differ"] += int((u > 0).sum())
            rec["max_ulps"] = max(rec["max_ulps"],
                                  int(u.max()) if u.numel() else 0)
        rec["share_differ"] = rec["differ"] / max(rec["values"], 1)
        # tolerance: uniforms bit for bit (exact arithmetic); the float64
        # transcendentals' float32 results equal but for at most 1e-4 of
        # them, one ulp apart, and no gamma accepted at another attempt
        rec["ok"] = bool(rec["uniform_bitwise"]
                         and rec["nonfinite_mismatch"] == 0
                         and rec["max_ulps"] <= 1
                         and rec["share_differ"] <= 1e-4
                         and rec["gamma_other_attempt"] == 0)
        return rec

    # 14a. the draw kernel against its plain version on every path's
    # operands (captured in phases 3, 8, 9, 10 and 11): the plain version
    # on the card, and on the CPU (the CPU tests' numbers; at stress on
    # the first DRAW_CPU_STRESS_CHAINS chains)
    drep["parity"] = []
    for path in ("flagship", "stress", "full_mtm", "ens32", "pool"):
        keys_d, sw_d, sh_d, tab_d = draw_args[path]
        bshape = tuple(keys_d.shape[:-1])
        B = math.prod(bshape)
        out_k = rng.sweep_draws(keys_d, sw_d, sh_d, tab_d)
        out_p = rng.sweep_draws_plain(keys_d, sw_d, sh_d, tab_d)
        torch.cuda.synchronize()
        vk = tab_d.views(out_k, (B,))
        rec = {"path": path, "shape": list(bshape), "width": tab_d.width,
               "fields": [f.name for f in tab_d.fields],
               "vs_plain": draw_cmp(tab_d, vk, tab_d.views(out_p, (B,)))}
        Bc = DRAW_CPU_STRESS_CHAINS if path == "stress" else B
        kc, shc = keys_d.reshape(B, 2)[:Bc], sh_d.reshape(B, -1)[:Bc]
        swc = sw_d.reshape(-1)[:Bc] if sw_d.numel() > 1 else sw_d
        vc = tab_d.views(rng.sweep_draws_plain(
            kc.cpu(), swc.cpu(), shc.cpu(), tab_d), (Bc,))
        rec["vs_cpu_plain"] = draw_cmp(
            tab_d, {k: v[:Bc].cpu() for k, v in vk.items()}, vc)
        rec["cpu_chains"] = Bc
        rec["max_abs_err"] = rec["vs_plain"]["max_abs_err"]
        rec["ok"] = rec["vs_plain"]["ok"] and rec["vs_cpu_plain"]["ok"]
        drep["parity"].append(rec)
        print(f"# parity {DRAWS} {path} {list(bshape)} x {tab_d.width}: "
              f"{json.dumps(rec)}", flush=True)
        if not rec["ok"]:
            fail(f"the draw kernel disagrees with its plain version on the "
                 f"{path} path")
    del out_k, out_p, vk, vc

    # the retry queue and its edges, in the flagship's table at 96 chains:
    # whole gamma tiles of the shapes that reject most (a = 1; a = 0.5,
    # boosted), then chains of the shapes 0, NaN, inf and -1 (NaN, no
    # attempt), 1e-30 (boosted: its boost underflows to 0), 3e38 (near the
    # float32 maximum), 1e20 and 1e30 (float64 rounding leaves the squeeze
    # test a coin toss: up to ~17 attempts) among good chains; at the
    # launch's tiles and at 1 and 16 gamma values a thread
    rs_e = np.random.default_rng(14)
    B_e = 96
    df_e = rs_e.integers(1, 31, B_e).astype(np.float32)
    sh_e = np.stack([rs_e.uniform(0.3, 60, B_e), rs_e.uniform(0.3, 60, B_e),
                     df_e / 2, (df_e + 1) / 2], -1).astype(np.float32)
    sh_e[:16, 2:] = 1.0
    sh_e[16:32, 2:] = 0.5
    odd = np.array([0.0, np.nan, np.inf, -1.0, 1e-30, 3e38, 1e20, 1e30],
                   np.float32)
    sh_e[32::2, 0] = odd[np.arange(32) % 8]
    sh_e[33::2, 2] = odd[np.arange(32) % 8]
    sh_e[40::4, 3] = odd[np.arange(14) % 8]
    bad_e = torch.from_numpy(~((sh_e > 0) & np.isfinite(sh_e))).to(dev)
    keys_e = rng.chain_keys(23, range(B_e), device=dev)
    sw_e = torch.tensor(11, device=dev)
    shd_e = torch.from_numpy(sh_e).to(dev)
    tab_e = sampler._table

    def bitwise(a, b):
        """Bit for bit, NaN where the other is NaN."""
        na, nb = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(na, nb) and torch.equal(a[~na], b[~nb]))

    plain_e = rng.sweep_draws_plain(keys_e, sw_e, shd_e, tab_e)
    outs_e = [rng.sweep_draws(keys_e, sw_e, shd_e, tab_e, elems=el)
              for el in (None, (8, 1), (8, 16))]
    torch.cuda.synchronize()
    ve = tab_e.views(outs_e[0], (B_e,))
    nan_at = {"g_theta": bad_e[:, :2], "g_alpha": bad_e[:, 2:, None]}
    good_e = torch.nonzero(~bad_e.any(-1)).reshape(-1)
    alone_e = tab_e.views(rng.sweep_draws(keys_e[good_e], sw_e,
                                          shd_e[good_e], tab_e),
                          (len(good_e),))
    ga = ve["g_alpha"]
    edges = drep["edges"] = {
        "chains": B_e, "good_chains": len(good_e),
        "bitwise_vs_plain": [bitwise(o, plain_e) for o in outs_e],
        "nan_exactly_at_bad_shapes": all(
            torch.equal(torch.isnan(v), nan_at.get(
                k, torch.zeros((), dtype=torch.bool, device=dev)).expand(
                    v.shape)) for k, v in ve.items()),
        "good_alone_bitwise": all(bitwise(ve[k][good_e], alone_e[k])
                                  for k in ve),
        "tiny_boosted_zero": bool((ga[shd_e[:, 2:] == 1e-30] == 0).all()),
        "near_max_finite": bool(torch.isfinite(
            ga[shd_e[:, 2:] == 3e38]).all()),
        "attempts": rng.gamma_attempts(keys_e, sw_e, shd_e, tab_e),
        "valid_gammas": int((~bad_e[:, :2]).sum()) + int(
            (~bad_e[:, 2:]).sum()) * tab_e.fields[-2].per}
    edges["vs_cpu_plain"] = draw_cmp(
        tab_e, {k: v.cpu() for k, v in ve.items()},
        tab_e.views(rng.sweep_draws_plain(keys_e.cpu(), sw_e.cpu(),
                                          shd_e.cpu(), tab_e), (B_e,)))
    edges["max_abs_err"] = edges["vs_cpu_plain"]["max_abs_err"]
    edges["ok"] = bool(all(edges["bitwise_vs_plain"])
                       and edges["nan_exactly_at_bad_shapes"]
                       and edges["good_alone_bitwise"]
                       and edges["tiny_boosted_zero"]
                       and edges["near_max_finite"]
                       and edges["vs_cpu_plain"]["ok"])
    print(f"# draws retry queue and edges: {json.dumps(edges)}", flush=True)
    # tolerance: bit for bit on the card at every tile length; against the
    # CPU as the paths above
    if not edges["ok"]:
        fail("the draw kernel's retries or bad shapes disagree with its "
             "plain version")
    drep["parity"].append({"path": "edges", "max_abs_err":
                           edges["max_abs_err"]})
    parity[DRAWS] = drep["parity"]
    del outs_e, plain_e, ve, alone_e, ga

    # 14b. a chain's draws depend only on (seed, chain, sweep) on the card:
    # the flagship's chains 0-15 drawn alone and the batch permuted give
    # the same raw draws bit for bit; the 16-chain sampler's SweepDraws
    # beside the 1024-chain sampler's rows (the covariance jumps go
    # through L @ xi, a batched product, and are reported)
    st_f = sampler.last_state
    keys_f = sampler._chain_keys(1)
    sw7 = torch.tensor(7, device=dev)
    tab_f = sampler._table
    a_f, b_f = sampler._theta_shapes(st_f.z)
    sh_f = torch.stack([a_f, b_f, st_f.df / 2.0, (st_f.df + 1.0) / 2.0], -1)
    raw_all = tab_f.views(rng.sweep_draws(keys_f, sw7, sh_f, tab_f),
                          (NCHAINS,))
    raw_16 = tab_f.views(rng.sweep_draws(keys_f[:16], sw7, sh_f[:16],
                                         tab_f), (16,))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(
        NCHAINS)).to(dev)
    raw_perm = tab_f.views(rng.sweep_draws(keys_f[perm], sw7, sh_f[perm],
                                           tab_f), (NCHAINS,))
    smp16 = tb.TorchGibbs(ma, cfg, nchains=16, device=dev)
    d_all = sampler._draw(keys_f, sw7, st_f)
    d_16 = smp16._draw(keys_f[:16], sw7,
                       type(st_f)(*(t[:16] for t in st_f)))
    ind = drep["independence"] = {
        "subset_bitwise": all(torch.equal(raw_all[k][:16], raw_16[k])
                              for k in raw_all),
        "permuted_bitwise": all(torch.equal(raw_all[k][perm], raw_perm[k])
                                for k in raw_all),
        "sweep_draws_fields_bitwise": {
            f: bool(torch.equal(a[:16], b))
            for f, a, b in zip(d_all._fields, d_all, d_16) if a.numel()},
        "sweep_draws_max_rel_err": max(
            rel_err(a[:16], b)[1] for a, b in zip(d_all, d_16)
            if a.numel())}
    del raw_all, raw_16, raw_perm, d_all, d_16, smp16

    # a pool tenant (32 chains) in the first two groups and, behind a
    # neighbour of 32 chains, in the last two: its records bit for bit
    def placed(first):
        srv2 = ChainServer(template, cfg_p, nlanes=POOL_CPU_LANES, quantum=5,
                           record="full", device=dev)
        reqs = [TenantRequest(ma=tenant_mas[2], niter=10, nchains=32,
                              seed=77),
                TenantRequest(ma=tenant_mas[3], niter=10, nchains=32,
                              seed=78)]
        hs = [srv2.submit(r) for r in (reqs if first else reqs[::-1])]
        srv2.run()
        return hs[0 if first else 1].result()

    r_a, r_b = placed(True), placed(False)
    exact = ("chain", "zchain", "thetachain", "dfchain")
    ind["pool_placements"] = {
        **{f: bool(np.array_equal(getattr(r_a, f), getattr(r_b, f)))
           for f in exact + ("bchain", "alphachain", "poutchain")},
        **{k: bool(np.array_equal(r_a.stats[k], r_b.stats[k]))
           for k in ("acc_white", "acc_hyper")}}
    print(f"# draws independence: {json.dumps(ind)}", flush=True)
    # tolerance: the raw draws bit for bit; the tenant's x, z, theta, df
    # and accept rates bit for bit at both placements (b, alpha and pout
    # reported)
    if not (ind["subset_bitwise"] and ind["permuted_bitwise"]
            and all(ind["pool_placements"][f] for f in exact
                    + ("acc_white", "acc_hyper"))):
        fail("a chain's draws depend on more than (seed, chain, sweep)")
    del r_a, r_b

    # 14c. card against CPU end to end: DRAW_SWEEPS flagship sweeps (64
    # chains) from one state, each side drawing its own numbers from the
    # same seed; each sweep of the card's trajectory is held as phase 4
    # holds one, from a state 3 sweeps in, as phase 4's (from the prior
    # draws of the initial state the b draw's factor amplifies float32
    # differences past 1e-3: C-3)
    keys_g, sw_g = keyed(small, 31, 3 + DRAW_SWEEPS)
    keys_c, sw_c = keyed(small_cpu, 31, 3 + DRAW_SWEEPS)
    st = small._prop_cov_update(small.init_state(seed=31))
    for i in range(3):
        st = small._sweep(st, small._draw(keys_g, sw_g[i], st), sweep=i)
    e2e = drep["card_vs_cpu"] = []
    for i in range(3, 3 + DRAW_SWEEPS):
        st_c = type(st)(*map(to_cpu, st))
        dr_g = small._draw(keys_g, sw_g[i], st)
        dr_c = small_cpu._draw(keys_c, sw_c[i], st_c)
        row = {"sweep": i, "draws_max_rel_err": {
            f: rel_err(to_cpu(a), b)[1]
            for f, a, b in zip(dr_g._fields, dr_g, dr_c) if a.numel()},
            "draws_bitwise": {
            f: bool(torch.equal(to_cpu(a), b))
            for f, a, b in zip(dr_g._fields, dr_g, dr_c) if a.numel()}}
        out_g = small._sweep(st, dr_g, sweep=i)
        out_c = small_cpu._sweep(st_c, dr_c, sweep=i)
        nw, nh = cfg.mh.n_white_steps, cfg.mh.n_hyper_steps
        agree = ((torch.round(to_cpu(out_g.acc_white) * nw)
                  == torch.round(out_c.acc_white * nw))
                 & (torch.round(to_cpu(out_g.acc_hyper) * nh)
                    == torch.round(out_c.acc_hyper * nh)))
        row["chains_acc_mismatch"] = int((~agree).sum())
        for f in ("x", "b"):
            row[f] = rel_err(to_cpu(getattr(out_g, f)), getattr(out_c, f))[:2]
        e2e.append(row)
        st = out_g
    print(f"# draws card-vs-cpu ({DRAW_SWEEPS} flagship sweeps, 64 chains): "
          f"{json.dumps(e2e)}", flush=True)
    # tolerance as phase 4, at every sweep
    if any(r["chains_acc_mismatch"] or r["x"][1] > 1e-4 or r["b"][1] > 1e-3
           for r in e2e):
        fail("the card's sweeps disagree with the CPU's on their own draws")

    # 14d. costs: the draws of one sweep (the kernel and its glue) against
    # the parent's generator draws of the same fields, launches and device
    # time profiled, and the kernel's time beside its bound, its plain
    # version and (as the yardstick) the parent's draws; the pool's were
    # measured with its tenants resident (phase 11d)
    # D1's instruction floor: each instruction class's count in the SASS
    # of its probe kernels (tools/torch_kernel_ab.py), the card's SMs and
    # top SM clock
    draw_ins = drep["instructions"] = draw_instructions(HERE)
    if draw_ins is None:
        fail("nvcc or cuobjdump is missing: D1's instructions cannot be "
             "counted")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])

    def draw_row(path, args, extra):
        """D1's time on a path's operands beside its first design's, its
        plain version's and its bounds: the bytes (keys, sweep indices
        and shapes read once, every value written once) over the memory
        rate, and the instruction floor of the values and attempts these
        operands need (``draw_floor``); the bound is the larger of the
        bytes' time and the float64 instructions' over the FP64 pipe, the
        floor the largest class's time, issue slots included."""
        keys_d, sw_d, sh_d, tab_d = args
        B = keys_d.numel() // 2
        byts = (8 * keys_d.numel() + 8 * sw_d.numel() + 4 * sh_d.numel()
                + 4 * B * tab_d.width)
        counts = draw_counts(rng, *args)
        fl = draw_floor(draw_ins, counts, sms, max_mhz)
        byte_ms = byts / HBM_BYTES_PER_S * 1e3
        fp64_ms = fl["ms_by_class"]["fp64"]
        return dict(
            path=path, shape=list(keys_d.shape[:-1]), width=tab_d.width,
            first_design_ms=FIRST_DESIGN_MS.get((DRAWS, B, tab_d.width)),
            ms=timed(rng.sweep_draws, args, 50),
            plain_ms=timed(rng.sweep_draws_plain, args, 3,
                           queue_ahead=False),
            bound_ms=max(byte_ms, fp64_ms),
            bound_by="bytes" if byte_ms >= fp64_ms else "operations",
            byte_bound_ms=byte_ms, floor_ms=fl["floor_ms"],
            floor_by=fl["by"], floor_ms_by_class=fl["ms_by_class"],
            work=counts, bytes=byts, **extra)

    costs = drep["costs"] = {}
    for path, smp, st_p, prof_total, wall_ms in (
            ("flagship", sampler, sampler.last_state, report["profile"],
             1e3 * report["run"]["timed_wall_s"] / MORE),
            ("stress", stress, stress.last_state, stress_rep["profile"],
             stress_rep["run"]["ms_per_sweep"]),
            ("ens32", ens, ens.last_state, ens_rep["profile"],
             ens_rep["run"]["ms_per_sweep"])):
        keys_p = smp._chain_keys(1)
        sw_p = torch.tensor(9, device=dev)
        gen_p = torch.Generator(device=dev).manual_seed(9)
        new = profile_calls(torch, lambda: smp._draw(keys_p, sw_p, st_p),
                            DRAW_PROFILE_CALLS)
        old = profile_calls(torch, lambda: legacy_draw(torch, smp, gen_p,
                                                       st_p),
                            DRAW_PROFILE_CALLS)
        extra = {"library_ms": timed(
            lambda: legacy_draw(torch, smp, gen_p, st_p), (), 20)}
        if path == "stress":
            # the parent's alpha gammas alone (the stress path's bulk)
            a_sh = (torch.stack([st_p.df, st_p.df + 1.0], -1) / 2.0)[
                ..., None].expand(*st_p.df.shape, 2, smp._n).contiguous()
            extra["standard_gamma_ms"] = timed(
                lambda: torch._standard_gamma(a_sh, generator=gen_p), (), 20)
            extra["alpha_gammas"] = a_sh.numel()
            del a_sh
        row = draw_row(path, draw_args[path], extra)
        timing.setdefault(DRAWS, []).append(row)
        costs[path] = {
            "draw_launches_per_sweep": new["launches_per_sweep"],
            "draw_device_ms_per_sweep": new["device_ms_per_sweep"],
            "legacy_draw_launches_per_sweep": old["launches_per_sweep"],
            "legacy_draw_device_ms_per_sweep": old["device_ms_per_sweep"],
            "sweep_launches_per_sweep": prof_total["launches_per_sweep"],
            "sweep_launches_before": prof_total["launches_per_sweep"]
            - new["launches_per_sweep"] + old["launches_per_sweep"],
            "sweep_device_ms_per_sweep": prof_total["device_ms_per_sweep"],
            "sweep_wall_ms_per_sweep": wall_ms}
        print(f"# time {DRAWS} {row['shape']} ({path}): {json.dumps(row)}",
              flush=True)
    pp = pool_rep["profile"]
    row = draw_row("pool", draw_args["pool"], {
        "library_ms": pool_draw_ms["legacy_ms"],
        "draws_ms": pool_draw_ms["ms"]})
    timing.setdefault(DRAWS, []).append(row)
    print(f"# time {DRAWS} {row['shape']} (pool): {json.dumps(row)}",
          flush=True)
    costs["pool"] = {
        "draw_launches_per_sweep": pp["draw_launches_per_sweep"],
        "draw_device_ms_per_sweep": pp["draw_device_ms_per_sweep"],
        "legacy_draw_launches_per_sweep":
            pp["legacy_draw_launches_per_sweep"],
        "legacy_draw_device_ms_per_sweep":
            pp["legacy_draw_device_ms_per_sweep"],
        "sweep_launches_per_sweep": pp["launches_per_sweep"],
        "sweep_launches_before": pp["launches_per_sweep"]
        - pp["draw_launches_per_sweep"]
        + pp["legacy_draw_launches_per_sweep"],
        "sweep_device_ms_per_sweep": pp["device_ms_per_sweep"],
        "sweep_wall_ms_per_sweep": pp["wall_ms_per_sweep"],
        "busy_chain_sweeps_per_s": prun["busy_chain_sweeps_per_s"],
        "run_ms_per_sweep": prun["ms_per_sweep"]}
    for path, c in costs.items():
        print(f"# draw cost {path}: {c['draw_launches_per_sweep']:.1f} "
              f"launches, {c['draw_device_ms_per_sweep']:.4f} device ms a "
              f"sweep (generator draws: "
              f"{c['legacy_draw_launches_per_sweep']:.1f} launches, "
              f"{c['legacy_draw_device_ms_per_sweep']:.4f} ms); the sweep "
              f"{c['sweep_launches_per_sweep']:.1f} launches (with the "
              f"generator draws {c['sweep_launches_before']:.1f}), device "
              f"{c['sweep_device_ms_per_sweep']:.4f} ms, wall "
              f"{c['sweep_wall_ms_per_sweep']:.4f} ms | {card}", flush=True)
    for r in timing[DRAWS]:
        first = r["first_design_ms"]
        print(f"# {DRAWS} {r['path']} {r['shape']} x {r['width']}: "
              f"{r['ms']:.5f} ms"
              + (f" (first design {first} ms, {first / r['ms']:.2f}x)"
                 if first else "")
              + f", {r['ms'] / r['byte_bound_ms']:.1f}x its byte bound "
              f"({r['byte_bound_ms']:.6f} ms), "
              f"{r['ms'] / r['floor_ms']:.2f}x its instruction floor "
              f"({r['floor_ms']:.5f} ms by {r['floor_by']}; FP64 "
              f"{r['floor_ms_by_class']['fp64']:.5f} ms), plain "
              f"{r['plain_ms']:.3f} ms, generator draws "
              f"{r['library_ms']:.4f} ms"
              + (f", _standard_gamma alone {r['standard_gamma_ms']:.4f} ms"
                 if "standard_gamma_ms" in r else "")
              + f" | {card}", flush=True)
    drep["seconds"] = time.perf_counter() - t14
    print(f"# phase 14: {drep['seconds']:.1f} s", flush=True)
    del stress, ens

    # --- 15. the scheduler and the pipelined executor (pool1024) ------------
    from gibbs_student_t_tpu_torch.serve import DeadlineExceeded

    t15 = time.perf_counter()
    srep = report["sched"] = {}
    tmp15 = tempfile.mkdtemp(prefix="gst_chip_smoke_sched_")
    served = [0, 0]         # pool sweeps and quanta of phase 15's servers
    WAIT_S = 600.0          # no result is waited for longer
    wd_states = []          # the watchdog's state after each driven run

    def pool_server(pipeline, **kw):
        return ChainServer(template, cfg_p, nlanes=POOL_LANES,
                           quantum=POOL_QUANTUM, record="light", device=dev,
                           pipeline=pipeline, **kw)

    def drive(s, on_quantum=None):
        """``s.run()`` to idle, timed behind a synchronize; the server is
        closed (every thread it started ends) whatever happens."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            s.run(on_quantum=on_quantum)
            torch.cuda.synchronize()
        finally:
            s.close(timeout=WAIT_S)
        wd_states.append(s.healthz()["watchdog"]["state"])
        served[0] += s.quanta * POOL_QUANTUM
        served[1] += s.quanta
        return time.perf_counter() - t0

    def tenant_set():
        """Phase 11d's tenants: 8 of 256 chains, then one of 40."""
        reqs = [TenantRequest(ma=tenant_mas[i], niter=budgets[i],
                              nchains=POOL_CHAINS, seed=100 + i)
                for i in range(POOL_TENANTS)]
        reqs.append(TenantRequest(
            ma=tenant_mas[-1], niter=POOL_PAD_SWEEPS,
            nchains=POOL_PAD_CHAINS, seed=100 + POOL_TENANTS))
        return reqs

    def finite_shaped(res, nchains, niter):
        return (res.chain.shape == (niter, nchains, template.nparam)
                and bool(np.isfinite(res.chain).all()
                         and np.isfinite(res.thetachain).all()
                         and np.isfinite(res.dfchain).all()))

    reset_counts()
    try:
        # 15a. phase 11's tenant set through each executor: every tenant
        # bitwise across the two; 15c's walls, throughput and host ms
        # in turns: serial, pipelined, pipelined, serial
        runs = {False: [], True: []}
        first = None
        bitwise = True
        for pipeline in (False, True, True, False):
            s = pool_server(pipeline)
            hs = [s.submit(r) for r in tenant_set()]
            wall = drive(s)
            res = [h.result(timeout=WAIT_S) for h in hs]
            if first is None:
                first = res
            bitwise &= all(same_rows(a, b) for a, b in zip(first, res))
            runs[pipeline].append((wall, s.summary()))
        shapes_ok = all(finite_shaped(r, c_, n_) for r, (c_, n_) in zip(
            first, pool_rep["tenants"]))
        t15b = time.perf_counter()
        # the device's busy time a quantum, from a profiled window of each
        # executor (4 tenants of 256 chains, 2 quanta)
        prof_q = 2
        device_ms = {}
        for pipeline in (True, False):
            s = pool_server(pipeline)
            for i in range(POOL_LANES // POOL_CHAINS):
                s.submit(TenantRequest(ma=tenant_mas[i],
                                       niter=prof_q * POOL_QUANTUM,
                                       nchains=POOL_CHAINS, seed=600 + i))
            prof = profile_calls(torch, lambda s=s: drive(s), 1)
            if prof["device_ms_per_sweep"] <= 0:
                fail("the profiler saw no device time in a scheduled run")
            # (the pipelined executor admits what its staging window holds,
            # so its quanta may be more)
            device_ms[pipeline] = prof["device_ms_per_sweep"] / s.quanta
        for pipeline in (False, True):
            walls = [w for w, _ in runs[pipeline]]
            summ = runs[pipeline][0][1]
            ms_q = float(np.mean([1e3 * w / sm["quanta"]
                                  for w, sm in runs[pipeline]]))

            def host(leg):
                return [sm["host_ms"][leg]["mean"] for _, sm in
                        runs[pipeline]]

            srep["serial" if not pipeline else "pipelined"] = {
                "quanta": [sm["quanta"] for _, sm in runs[pipeline]],
                "wall_s": walls,
                "ms_per_quantum": ms_q,
                "device_ms_per_quantum": device_ms[pipeline],
                "idle_share": max(0.0, 1.0 - device_ms[pipeline] / ms_q),
                "busy_chain_sweeps_per_s": [
                    summ["busy_chain_sweeps"] / w for w in walls],
                "occupancy": summ["occupancy"],
                "drain_host_ms_per_quantum": host("drain"),
                "dispatch_host_ms_per_quantum": host("dispatch"),
                "admission_host_ms_per_quantum": host("admission"),
                "dispatch_gap_ms": host("dispatch_gap"),
                "admission_ms_mean": [sm["admission_ms"]
                                      for _, sm in runs[pipeline]]}
        srep["tenant_set"] = {"bitwise": bool(bitwise),
                              "finite_shaped": bool(shapes_ok)}
        print(f"# sched 15a phase 11's tenant set, serial vs pipelined: "
              f"{json.dumps(srep['tenant_set'])}", flush=True)
        if not (bitwise and shapes_ok):
            fail("the pipelined executor's tenants differ from the serial "
                 "loop's, or are not finite and shaped")
        del runs

        # 15b. lossless preemption: two spooled batch tenants of 512
        # chains x 250 sweeps (10 quanta) fill the pool; an interactive
        # tenant of 1024 chains x 50 sweeps arrives after their second
        # quantum (the trigger reads server.quanta, which the dispatch
        # side sets)
        V_CHAINS, V_SWEEPS = POOL_LANES // 2, 10 * POOL_QUANTUM
        H_SWEEPS = 2 * POOL_QUANTUM

        def victims(extra=({}, {})):
            return [TenantRequest(ma=tenant_mas[4 + i], niter=V_SWEEPS,
                                  nchains=V_CHAINS, seed=300 + i,
                                  priority=2, **extra[i])
                    for i in range(2)]

        s = pool_server(False)
        ref_hs = [s.submit(r) for r in victims()]
        drive(s)
        refs = [h.result(timeout=WAIT_S) for h in ref_hs]

        def preempted_run(pipeline, at, tag, deadline=None):
            s = pool_server(pipeline, scheduler="priority")
            vh = [s.submit(r) for r in victims([
                dict(spool_dir=os.path.join(tmp15, f"{tag}{i}"),
                     deadline_sweeps=(deadline if i == 0 else None))
                for i in range(2)])]
            hi, seen = [], [dict(out=None, back=None) for _ in vh]

            def on_quantum(srv_):
                if srv_.quanta == at and not hi:
                    hi.append(srv_.submit(TenantRequest(
                        ma=tenant_mas[6], niter=H_SWEEPS, nchains=POOL_LANES,
                        seed=400, priority=0)))
                for h, st in zip(vh, seen):
                    inside = h.tenant_id in srv_._running
                    if not inside and st["out"] is None and hi:
                        st["out"] = srv_.quanta
                    if inside and st["out"] is not None \
                            and st["back"] is None:
                        st["back"] = srv_.quanta

            wall = drive(s, on_quantum)
            return s, vh, hi, seen, wall

        pre = {}
        srep["seconds_15a"] = t15b - t15
        srep["seconds_profiles"] = time.perf_counter() - t15b
        for pipeline in (False, True):
            s, vh, hi, seen, wall = preempted_run(pipeline, 2,
                                                  f"p{int(pipeline)}_")
            got = [h.result(timeout=WAIT_S) for h in vh]
            hres = hi[0].result(timeout=WAIT_S)
            pre[pipeline] = {
                "preemptions": s.summary()["sched"]["preemptions"],
                "victim_preemptions": [h.preemptions for h in vh],
                "frozen_at": [h.request.start_sweep for h in vh],
                "readmission_delay_quanta": [
                    None if st["back"] is None else st["back"] - st["out"] - 1
                    for st in seen],
                "quanta": s.quanta, "wall_s": wall,
                "drain_host_ms_per_quantum":
                    s.summary()["host_ms"]["drain"]["mean"],
                "dispatch_host_ms_per_quantum":
                    s.summary()["host_ms"]["dispatch"]["mean"],
                "victims_bitwise": [bool(same_rows(a, b))
                                    for a, b in zip(got, refs)],
                "interactive_ok": bool(finite_shaped(hres, POOL_LANES,
                                                     H_SWEEPS))}
        # a deadline-armed victim (deadline 2 quanta; the interactive
        # tenant arrives after the first quantum): DeadlineExceeded with
        # its spooled prefix, bitwise the uninterrupted run's first rows;
        # the other victim finishes bitwise
        s, vh, hi, seen, wall = preempted_run(True, 1, "d_",
                                              deadline=2 * POOL_QUANTUM)
        try:
            vh[0].result(timeout=WAIT_S)
            dl = {"raised": False}
        except DeadlineExceeded as e:
            n = e.partial.chain.shape[0]
            dl = {"raised": True, "deadline_sweep": e.deadline_sweep,
                  "served_sweeps": e.served_sweeps, "prefix_rows": n,
                  "prefix_bitwise": bool(
                      n == e.served_sweeps
                      and all(eq(getattr(e.partial, f),
                                 getattr(refs[0], f)[:n])
                              for f in ("chain", "thetachain", "dfchain"))
                      and all(eq(e.partial.stats[k], refs[0].stats[k][:n])
                              for k in ("acc_white", "acc_hyper")))}
        dl["other_bitwise"] = bool(same_rows(vh[1].result(timeout=WAIT_S),
                                             refs[1]))
        hi[0].result(timeout=WAIT_S)
        srep["preemption"] = {"serial": pre[False], "pipelined": pre[True],
                              "deadline": dl}
        for pipeline in (False, True):
            print(f"# sched 15b preemption "
                  f"{'pipelined' if pipeline else 'serial'}: "
                  f"{json.dumps(pre[pipeline])}", flush=True)
        print(f"# sched 15b deadline: {json.dumps(dl)}", flush=True)
        if not all(all(p["victims_bitwise"]) and p["interactive_ok"]
                   and p["preemptions"] >= 2
                   and min(p["victim_preemptions"]) >= 1
                   for p in pre.values()):
            fail("a preempted tenant is not bitwise its uninterrupted run, "
                 "or the preemption did not happen")
        if not (dl["raised"] and dl["served_sweeps"] >= 2 * POOL_QUANTUM
                and dl["prefix_bitwise"] and dl["other_bitwise"]):
            fail("the deadline-armed victim did not resolve with its "
                 "spooled prefix")
        counts15 = check_launches("pool_sched", served[0], served[1])
    finally:
        shutil.rmtree(tmp15, ignore_errors=True)

    # 15c. serial against pipelined
    for name in ("serial", "pipelined"):
        r = srep[name]

        def two(vals, f=".3f"):
            return " / ".join(format(v, f) for v in vals)

        print(f"# sched 15c pool1024 {name}: {r['ms_per_quantum']:.2f} ms "
              f"a quantum (mean of 2 runs of {two(r['quanta'], 'd')} "
              f"quanta), device "
              f"{r['device_ms_per_quantum']:.3f} ms a quantum, idle share "
              f"{r['idle_share']:.4f}, "
              f"{two(r['busy_chain_sweeps_per_s'], '.1f')} busy "
              f"chain-sweeps/s, drain host "
              f"{two(r['drain_host_ms_per_quantum'])} ms a quantum "
              f"(dispatch {two(r['dispatch_host_ms_per_quantum'])}, admission "
              f"{two(r['admission_host_ms_per_quantum'])}, dispatch gap "
              f"{two(r['dispatch_gap_ms'])}) | {card}", flush=True)
    for name, p in (("serial", pre[False]), ("pipelined", pre[True])):
        print(f"# sched 15c preemption {name}: {p['preemptions']} "
              f"preemptions, re-admission delay "
              f"{p['readmission_delay_quanta']} quanta, victims frozen at "
              f"sweep {p['frozen_at']}, {1e3 * p['wall_s'] / p['quanta']:.2f}"
              f" ms a quantum, drain host "
              f"{p['drain_host_ms_per_quantum']:.3f} ms a quantum "
              f"(dispatch {p['dispatch_host_ms_per_quantum']:.3f}) | {card}",
              flush=True)
    srep["launches"] = counts15
    srep["seconds"] = time.perf_counter() - t15
    print(f"# phase 15: {srep['seconds']:.1f} s", flush=True)

    # --- 16. fault containment and crash recovery (pool1024) ----------------
    from gibbs_student_t_tpu_torch.obs import schema as obs_schema
    from gibbs_student_t_tpu_torch.serve import TenantError, faults
    from gibbs_student_t_tpu_torch.serve.manifest import read_manifest

    schemas = obs_schema.load_schemas()
    t16 = time.perf_counter()
    frep = report["faults"] = {}
    tmp16 = tempfile.mkdtemp(prefix="gst_chip_smoke_faults_")
    set_refs = first        # 15a's fault-free results of the tenant set
    Q = POOL_QUANTUM
    run16 = [0, 0]          # pool sweeps, and quanta with telemetry on
    policies = {0: "fail", 1: "quarantine", 2: "reinit"}

    def cut_equal(a, b, rows=None, cols=None):
        """The recorded fields (light: the non-empty ones) and the accept
        rates of ``a`` bitwise ``b``'s, on their first ``rows`` rows and
        the chains ``cols``."""
        pairs = [(getattr(a, f), getattr(b, f)) for f in chains]
        pairs += [(a.stats[k], b.stats[k]) for k in ("acc_white",
                                                     "acc_hyper")]
        for u, v in pairs:
            u, v = np.asarray(u), np.asarray(v)
            if u.size == 0 and v.size == 0:
                continue
            if rows is not None:
                u, v = u[:rows], v[:rows]
            if cols is not None:
                u, v = u[:, cols], v[:, cols]
            if not eq(u, v):
                return False
        return True

    def fault_script(death):
        """lane_nan on t0, t1, t2 (after their first quantum; the fail,
        quarantine and reinit policies), a raising callback on t3 (its
        second quantum), a staging failure on t4 and, with ``death``, the
        drain thread's death in t5's entry of its second quantum."""
        specs = [faults.FaultSpec("lane_nan", tenant=f"t{i}", after=1)
                 for i in policies]
        specs += [faults.FaultSpec("callback", tenant="t3", after=1),
                  faults.FaultSpec("staging", tenant="t4")]
        if death:
            specs.append(faults.FaultSpec("drain_death", tenant="t5",
                                          after=1, action="die"))
        return specs

    def fault_set():
        reqs = tenant_set()
        for i, r in enumerate(reqs):
            r.name = f"t{i}"
            r.on_divergence = policies.get(i, "none")
        reqs[3].on_chunk = lambda h, sweep_end, records: None
        return reqs

    def outcome16(hs, death):
        """Each tenant's outcome against what the script does to it: the
        victims' prefixes (their healthy chains throughout) and every
        other tenant bitwise 15a's results."""
        out = {}
        for i, h in enumerate(hs):
            ref, name = set_refs[i], f"t{i}"
            healthy = list(range(1, h.request.nchains))
            rec = out[name] = {}
            if i == 4:
                rec["ok"] = (h.status == "rejected"
                             and "injected fault [staging]" in h.error)
                continue
            want = {0: ("divergence", 2 * Q), 3: ("drain", 2 * Q)}
            if death:
                want[5] = ("worker", Q)
            if i in want:
                try:
                    h.result(timeout=WAIT_S)
                    rec["ok"] = False
                    continue
                except TenantError as e:
                    rows = 0 if e.partial is None else e.partial.chain.shape[0]
                    rec.update(where=e.where, prefix_rows=rows)
                    rec["ok"] = ((e.where, rows) == want[i] and cut_equal(
                        e.partial, ref, rows=rows,
                        cols=healthy if i == 0 else None)
                        and cut_equal(e.partial, ref, rows=Q))
                continue
            res = h.result(timeout=WAIT_S)
            if i in (1, 2):
                hl = h.health
                rec.update(n_quarantined=hl["n_quarantined"],
                           quarantined_chains=hl["quarantined_chains"],
                           n_reinits=hl["n_reinits"],
                           status0=str(hl["status"][0]), n_ok=hl["n_ok"])
                rec["ok"] = (res.chain.shape[0] == ref.chain.shape[0]
                             and cut_equal(res, ref, cols=healthy)
                             and rec["status0"] == "diverged"
                             and ((hl["quarantined_chains"], hl["n_reinits"])
                                  == (([0], 0) if i == 1 else ([], 1))))
                if i == 2:
                    rec["ok"] &= bool(np.isfinite(res.chain[-1, 0]).all())
                continue
            rec["ok"] = same_rows(res, ref)
        return out

    reset_counts()
    want16 = {"tenant_failures": 2, "quarantined_lanes": 1, "reinits": 1,
              "worker_restarts": 0, "pool_failures": 0}
    try:
        # 16a. the script on each executor, in turns; the drain thread's
        # death only where there is one
        runs16 = []
        for pipeline, death in ((False, False), (True, True), (True, False),
                                (False, False)):
            s = pool_server(pipeline)
            with faults.inject(*fault_script(death)):
                hs = [s.submit(r) for r in fault_set()]
                wall = drive(s)
                fired = faults.fired_counts()
            run16[0] += s.quanta * Q
            run16[1] += s.quanta
            summ = s.summary()
            counts_want = dict(want16)
            if death:
                counts_want["tenant_failures"] += 1
                counts_want["worker_restarts"] = 1
            tenants = outcome16(hs, death)
            runs16.append({
                "executor": "pipelined" if pipeline else "serial",
                "drain_death": death, "quanta": s.quanta, "wall_s": wall,
                "ms_per_quantum": 1e3 * wall / s.quanta,
                "dispatch_host_ms_per_quantum":
                    summ["host_ms"]["dispatch"]["mean"],
                "faults": summ["faults"],
                "faults_ok": summ["faults"] == counts_want,
                "fired": {f"{p}:{t}": n for (p, t), n in fired.items()},
                "tenants": tenants,
                "ok": all(r["ok"] for r in tenants.values())})
            print(f"# faults 16a {runs16[-1]['executor']}"
                  f"{' + drain_death' if death else ''}: "
                  f"{json.dumps(runs16[-1])}", flush=True)
        frep["containment"] = runs16
        if not all(r["ok"] and r["faults_ok"] for r in runs16):
            fail("a fault escaped its tenant, a victim's prefix or health is "
                 "wrong, or the fault counters differ between the executors")

        # 16c. the telemetry's cost: 4 tenants of 256 chains, telemetry on
        # and off in turns; a quantum to warm up, two timed, one profiled
        tele = {True: [], False: []}
        tele_res = {}
        for on in (True, False, False, True):
            s = ChainServer(template, cfg_p, nlanes=POOL_LANES, quantum=Q,
                            record="light", device=dev, pipeline=False,
                            telemetry=on)
            hs = [s.submit(TenantRequest(ma=tenant_mas[i],
                                         niter=TELE_QUANTA * Q,
                                         nchains=POOL_CHAINS, seed=700 + i))
                  for i in range(POOL_LANES // POOL_CHAINS)]
            s.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TELE_QUANTA - 2):
                s.step()
            torch.cuda.synchronize()
            wall_q = 1e3 * (time.perf_counter() - t0) / (TELE_QUANTA - 2)
            prof = profile_calls(torch, s.step, 1)
            s.close(timeout=WAIT_S)
            run16[0] += s.quanta * Q
            run16[1] += s.quanta if on else 0
            tele_res.setdefault(on, [h.result(timeout=WAIT_S) for h in hs])
            tele[on].append({
                "wall_ms_per_quantum": wall_q,
                "device_ms_per_quantum": prof["device_ms_per_sweep"],
                "launches_per_sweep": prof["launches_per_sweep"] / Q})
        tele_bitwise = all(same_rows(a, b) for a, b in
                           zip(tele_res[True], tele_res[False]))
        frep["telemetry"] = {"on": tele[True], "off": tele[False],
                             "records_bitwise": bool(tele_bitwise)}
        if not tele_bitwise:
            fail("pool telemetry changes the chains")
        counts16 = check_launches("pool_faults", run16[0], run16[1])

        # 16b. a server process killed on either side of a spool checkpoint
        # (two spooled tenants of 512 chains x 250 sweeps, the kill in the
        # first one's second append), then ChainServer.recover in a new
        # process; both tenants bitwise 15b's uninterrupted runs
        torch.cuda.empty_cache()
        arms = ("kill_before_checkpoint", "kill_after_checkpoint")
        dirs = {a: (os.path.join(tmp16, a, "manifest"),
                    os.path.join(tmp16, a, "spools")) for a in arms}

        def child(cfg):
            return subprocess.Popen(
                [sys.executable, "-c", CHILD16, HERE, json.dumps(cfg)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        procs = []
        try:
            t_kill = time.perf_counter()
            procs = [child({"mode": "kill", "arm": a, "manifest": dirs[a][0],
                            "spools": dirs[a][1],
                            "flight": os.path.join(tmp16, a, "flight"),
                            "nlanes": POOL_LANES,
                            "quantum": Q, "chains": KILL_CHAINS,
                            "sweeps": KILL_SWEEPS}) for a in arms]
            killed = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
            kill_s = time.perf_counter() - t_kill
            rcs = [p.returncode for p in procs]
            if rcs != [9, 9]:
                fail(f"the killed servers exited {rcs}, not 9: "
                     f"{[e[-1500:] for _, e in killed]}")
            # each killed server's last flight.json (synced every
            # quantum; the kill came in its second quantum's drain)
            flight16 = {}
            for a in arms:
                fpath = os.path.join(tmp16, a, "flight", "flight.json")
                try:
                    fj = json.load(open(fpath))
                    errs = obs_schema.validate(fj, schemas["postmortem"],
                                                 defs=schemas)
                    flight16[a] = {"reason": fj.get("reason"),
                                   "quanta_recorded": fj["quanta_recorded"],
                                   "schema_errors": errs[:5]}
                except (OSError, ValueError, KeyError) as exc:
                    flight16[a] = {"error": repr(exc)}
            ck = {a: [spool_mod.load_spool_state(
                os.path.join(dirs[a][1], f"v{i}"), device="cpu")[1]
                      if os.path.exists(os.path.join(dirs[a][1], f"v{i}",
                                                     "state.npz")) else 0
                      for i in range(2)] for a in arms}
            t_spawn = time.time()
            procs = [child({"mode": "recover",
                            "manifests": [dirs[a][0] for a in arms]})]
            out, err = procs[0].communicate(timeout=2 * CHILD_TIMEOUT_S)
            if procs[0].returncode != 0:
                fail(f"the recovering server exited "
                     f"{procs[0].returncode}: {err[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rec16 = json.loads(out.strip().splitlines()[-1])
        kill = {"kill_processes_s": kill_s, "checkpoints": ck,
                "flight": flight16,
                "first_dispatch_s": (rec16["runs"][0]["first_dispatch_t"]
                                     - t_spawn),
                "recover_to_first_dispatch_s": (
                    rec16["runs"][0]["first_dispatch_t"]
                    - rec16["runs"][0]["recover_t"]),
                "recovered": {}}
        for a, r in zip(arms, rec16["runs"]):
            got = [spool_mod.load_spool(os.path.join(dirs[a][1], f"v{i}"))
                   for i in range(2)]
            kinds = [x["kind"] for x in read_manifest(dirs[a][0])]
            kill["recovered"][a] = {
                "wall_s": r["wall_s"], "start_sweeps": r["start_sweeps"],
                "status": r["status"], "lost": r["lost"],
                "watchdog": r["watchdog"],
                "bitwise": [bool(g.chain.shape[0] == KILL_SWEEPS
                                 and same_rows(g, ref))
                            for g, ref in zip(got, refs)],
                "manifest_after_close": kinds}
        frep["kill"] = kill
        print(f"# faults 16b process kill: {json.dumps(kill)}", flush=True)
        want_ck = {"kill_before_checkpoint": Q, "kill_after_checkpoint": 2 * Q}
        if not all(ck[a][0] == want_ck[a]
                   and kill["recovered"][a]["start_sweeps"]["v0"] == want_ck[a]
                   and all(kill["recovered"][a]["bitwise"])
                   and kill["recovered"][a]["manifest_after_close"]
                   == ["server"]
                   and set(kill["recovered"][a]["status"].values())
                   == {"done"} for a in arms):
            fail("a killed server's tenants did not recover bitwise from "
                 "its manifest")
        # the killed servers' flight.json: parseable, valid and at most
        # flight_sync_every (1) quanta behind the 2 they had dispatched
        if not all(f.get("reason") == "sync" and not f["schema_errors"]
                   and 2 - f["quanta_recorded"] <= 1
                   for f in flight16.values()):
            fail(f"a killed server left no valid, recent flight.json: "
                 f"{flight16}")
        if any(kill["recovered"][a]["watchdog"] == "tripped" for a in arms):
            fail("the recovering server's watchdog tripped")
    finally:
        shutil.rmtree(tmp16, ignore_errors=True)

    def mean(vals):
        return sum(vals) / len(vals)

    for r in runs16:
        base = srep["serial" if r["executor"] == "serial" else "pipelined"]
        print(f"# faults 16a pool1024 {r['executor']}"
              f"{' + drain_death' if r['drain_death'] else ''}: "
              f"{r['ms_per_quantum']:.2f} ms a quantum with the script "
              f"({r['quanta']} quanta; without it, 15a: "
              f"{base['ms_per_quantum']:.2f}), faults {r['faults']} | {card}",
              flush=True)
    for on in (True, False):
        t_ = tele[on]
        print(f"# faults 16c pool1024 telemetry {'on' if on else 'off'}: "
              f"{mean([x['launches_per_sweep'] for x in t_]):.1f} launches a "
              f"sweep, device "
              f"{mean([x['device_ms_per_quantum'] for x in t_]):.3f} ms and "
              f"wall {' / '.join(format(x['wall_ms_per_quantum'], '.2f') for x in t_)}"
              f" ms a quantum | {card}", flush=True)
    print(f"# faults 16b: killed servers {kill['kill_processes_s']:.1f} s; "
          f"the recovering process's start to its first dispatch "
          f"{kill['first_dispatch_s']:.2f} s (recover() to first dispatch "
          f"{kill['recover_to_first_dispatch_s']:.2f} s), recovered runs "
          + ", ".join(f"{a} {kill['recovered'][a]['wall_s']:.2f} s"
                      for a in arms) + f" | {card}", flush=True)
    frep["launches"] = counts16
    frep["seconds"] = time.perf_counter() - t16
    # the plane is on by default: no clean run of phases 15 and 16 tripped
    # the watchdog
    frep["watchdog_states"] = {st: wd_states.count(st)
                               for st in sorted(set(wd_states))}
    print(f"# phase 16: {frep['seconds']:.1f} s; watchdog after phases 15 "
          f"and 16's runs: {frep['watchdog_states']}", flush=True)
    if "tripped" in wd_states:
        fail("the watchdog tripped in a run of phase 15 or 16")

    # --- 17. the serving observability plane (pool1024) ---------------------
    from gibbs_student_t_tpu_torch.obs import MetricsRegistry
    from gibbs_student_t_tpu_torch.obs.metrics import _jsonable, read_events
    from gibbs_student_t_tpu_torch.obs.watchdog import WatchdogSpec
    from gibbs_student_t_tpu_torch.parallel.diagnostics import (
        ess_per_param,
        split_rhat_per_param,
    )
    from gibbs_student_t_tpu_torch.serve import MonitorSpec

    t17 = time.perf_counter()
    orep = report["obs"] = {}
    tmp17 = tempfile.mkdtemp(prefix="gst_chip_smoke_obs_")
    MON = [0, 1, 2]         # the monitored parameters
    run17 = [0, 0]          # pool sweeps and quanta of phase 17's servers
    bad = []                # (record, the schema's complaints)

    def check_schema(doc, name, label):
        """Validate ``doc``, as a reader of its JSON would see it, against
        the port's schema ``name``; complaints are collected in ``bad``."""
        errs = obs_schema.validate(json.loads(json.dumps(_jsonable(doc))),
                                   schemas[name], defs=schemas)
        if errs:
            bad.append((label, errs[:5]))

    def count_run(s):
        run17[0] += s.quanta * Q
        run17[1] += s.quanta

    def launches_now():
        return {n: count(n) for n in wrappers}

    def plane_run(pipeline, on, tag):
        """The tenant set with every tenant monitored and the whole plane
        on (spans with a JSONL sink, obs_dir, a metrics run directory, the
        flight recorder, the watchdog), or all of it off. Returns the
        server, handles, results, wall, each kernel's launches, and (on)
        its directory and the status and healthz read at the first
        boundary with busy lanes."""
        d = os.path.join(tmp17, tag)
        reg = None
        if on:
            reg = MetricsRegistry(run_dir=os.path.join(d, "run"))
            reg.write_manifest(config=cfg_p)
            kw = dict(metrics=reg, obs_dir=os.path.join(d, "obs"),
                      trace_jsonl=os.path.join(d, "obs", "spans.jsonl"))
        else:
            kw = dict(spans=False, flight=False, watchdog=False)
        s = pool_server(pipeline, **kw)
        reqs = tenant_set()
        if on:
            for r in reqs:
                r.monitor = MonitorSpec(params=MON)
        live = {}

        def on_quantum(srv_):
            if on and not live and srv_.quanta:
                live["status"] = srv_.status()
                live["healthz"] = srv_.healthz()

        before = launches_now()
        hs = [s.submit(r) for r in reqs]
        wall = drive(s, on_quantum)
        launches = {n: c - before[n] for n, c in launches_now().items()}
        count_run(s)
        res = [h.result(timeout=WAIT_S) for h in hs]
        if reg is not None:
            reg.close()
        return dict(s=s, hs=hs, res=res, wall=wall, launches=launches, d=d,
                    live=live)

    reset_counts()
    try:
        # 17a. the plane on and off, each executor, in turns
        runs17 = {(p, on): [] for p in (False, True) for on in (True, False)}
        order = ((False, True), (False, False), (True, True), (True, False),
                 (True, False), (True, True), (False, False), (False, True))
        for i, (pipeline, on) in enumerate(order):
            runs17[(pipeline, on)].append(
                plane_run(pipeline, on, f"a{i}_{int(pipeline)}{int(on)}"))
        bitwise17 = all(same_rows(a, b) for rs in runs17.values()
                        for r in rs for a, b in zip(r["res"], first))
        # launches a quantum of every kernel: the same in every run
        per_q = [{n: c / r["s"].quanta for n, c in r["launches"].items()}
                 for rs in runs17.values() for r in rs]
        launches_equal = all(x == per_q[0] for x in per_q)
        # the monitor's final view against the diagnostics of the rows
        prog_err = 0.0
        rows_ok = True
        for pipeline in (False, True):
            for r in runs17[(pipeline, True)]:
                for h, res in zip(r["hs"], r["res"]):
                    p = h.progress()
                    window = np.asarray(res.chain)[:, :, MON]
                    e_ref = ess_per_param(window)
                    r_ref = split_rhat_per_param(window)
                    rows_ok &= p["rows"] == window.shape[0]
                    prog_err = max(
                        prog_err,
                        float(np.max(np.abs(np.asarray(p["ess"]) - e_ref)
                                     / e_ref)),
                        float(np.nanmax(np.abs(np.asarray(p["rhat"])
                                               - r_ref) / r_ref)))
        # spans: one a (tenant, quantum, role) and a staging span a tenant
        spans_ok = True
        for pipeline in (False, True):
            r = runs17[(pipeline, True)][0]
            doc = json.load(open(r["s"].export_trace(
                os.path.join(r["d"], "trace.json"))))
            check_schema(doc, "chrome_trace", "trace")
            roles = {}
            staged = set()
            for e in doc["traceEvents"]:
                if e["ph"] != "X" or e["pid"] == 0:
                    continue
                if e["cat"] == "staging":
                    staged.add(e["pid"] - 1)
                q = e["args"].get("quantum")
                if q is not None and e["name"] in ("quantum", "drain"):
                    roles.setdefault(e["pid"] - 1, {}).setdefault(
                        q, set()).add(e["cat"])
            for h in r["hs"]:
                got = roles.get(h.tenant_id, {})
                spans_ok &= (h.tenant_id in staged
                             and len(got) == h.request.niter // Q
                             and all(v == {"dispatch", "drain"}
                                     for v in got.values()))
        # every record the plane emitted, against the port's schema; the
        # tenants' cost against the dispatch wall; the watchdog untripped
        cost_err = 0.0
        tripped = []
        for pipeline in (False, True):
            for r in runs17[(pipeline, True)]:
                s, d = r["s"], r["d"]
                check_schema(r["live"]["status"], "serve_status",
                             "live status")
                check_schema(r["live"]["healthz"], "healthz", "live healthz")
                check_schema(s.status(), "serve_status", "status")
                check_schema(s.healthz(), "healthz", "healthz")
                check_schema(json.load(open(os.path.join(
                    d, "obs", "status.json"))), "serve_status",
                    "status.json")
                for line in open(os.path.join(d, "obs", "spans.jsonl")):
                    check_schema(json.loads(line), "span", "span line")
                for e in read_events(os.path.join(d, "run")):
                    check_schema(e, "event", "event")
                check_schema(json.load(open(os.path.join(
                    d, "run", "manifest.json"))), "manifest", "manifest")
                for h in r["hs"]:
                    check_schema(h.cost(), "cost", "cost")
                check_schema(json.load(open(s.dump_postmortem(
                    reason="phase17"))), "postmortem", "postmortem")
                check_schema(json.load(open(os.path.join(
                    d, "obs", "flight.json"))), "postmortem", "flight.json")
                summ = s.summary()
                check_schema(summ["watchdog"], "watchdog", "watchdog")
                wall_ms = summ["cost"]["dispatch_wall_ms"]
                cost_err = max(cost_err, abs(sum(
                    h.cost()["device_ms"] for h in r["hs"]) - wall_ms)
                    / wall_ms)
                if summ["watchdog"]["state"] != "ok":
                    tripped.append(summ["watchdog"]["trip"])
        t17p = time.perf_counter()
        # device time and all device events a quantum, plane on and off: a
        # profiled window of 4 tenants x 2 quanta on the serial loop (the
        # executors launch the same work), device activity only
        prof17 = {}
        for pipeline, on in ((False, True), (False, False)):
            kw = (dict(obs_dir=os.path.join(tmp17, f"p{int(pipeline)}"))
                  if on else dict(spans=False, flight=False, watchdog=False))
            s = pool_server(pipeline, **kw)
            for i in range(POOL_LANES // POOL_CHAINS):
                s.submit(TenantRequest(
                    ma=tenant_mas[i], niter=2 * Q, nchains=POOL_CHAINS,
                    seed=600 + i,
                    monitor=MonitorSpec(params=MON) if on else None))
            prof = profile_calls(torch, lambda s=s: drive(s), 1, cpu=False)
            count_run(s)
            if prof["device_ms_per_sweep"] <= 0:
                fail("the profiler saw no device time in phase 17's window")
            prof17[(pipeline, on)] = {
                "quanta": s.quanta,
                "device_ms_per_quantum": prof["device_ms_per_sweep"]
                / s.quanta,
                "launches_per_quantum": prof["launches_per_sweep"]
                / s.quanta,
                "device_events": prof["device_events"]}
        orep["seconds_profiles"] = time.perf_counter() - t17p
        pon, poff = prof17[(False, True)], prof17[(False, False)]
        for pipeline in (False, True):
            name = "pipelined" if pipeline else "serial"
            on_r, off_r = runs17[(pipeline, True)], runs17[(pipeline, False)]

            def host(rs, leg):
                return [r["s"].summary()["host_ms"][leg]["mean"] for r in rs]

            orep[name] = {
                "ms_per_quantum_on": [1e3 * r["wall"] / r["s"].quanta
                                      for r in on_r],
                "ms_per_quantum_off": [1e3 * r["wall"] / r["s"].quanta
                                       for r in off_r],
                "quanta_on": [r["s"].quanta for r in on_r],
                "quanta_off": [r["s"].quanta for r in off_r],
                "dispatch_host_ms_on": host(on_r, "dispatch"),
                "dispatch_host_ms_off": host(off_r, "dispatch"),
                "monitor_host_ms_per_quantum": host(on_r, "monitor"),
                "obs_refresh_host_ms_per_quantum": host(on_r, "obs_refresh"),
                "drain_host_ms_on": host(on_r, "drain"),
                "drain_host_ms_off": host(off_r, "drain")}
        orep["device"] = {
            "ms_per_quantum_on": pon["device_ms_per_quantum"],
            "ms_per_quantum_off": poff["device_ms_per_quantum"],
            "launches_per_quantum_on": pon["launches_per_quantum"],
            "launches_per_quantum_off": poff["launches_per_quantum"],
            "events_on": sum(pon["device_events"].values()),
            "events_off": sum(poff["device_events"].values()),
            "profiled_quanta": [pon["quanta"], poff["quanta"]]}
        dev_spread = abs(pon["device_ms_per_quantum"]
                         / poff["device_ms_per_quantum"] - 1.0)
        # every device event of the profiles, by name: the names whose
        # counts differ on and off (reported; the launches of the
        # hand-written kernels above are the exact check)
        ev_on, ev_off = pon["device_events"], poff["device_events"]
        events_differ = {k: [ev_on.get(k, 0), ev_off.get(k, 0)]
                         for k in sorted(set(ev_on) | set(ev_off))
                         if ev_on.get(k, 0) != ev_off.get(k, 0)}
        orep["plane"] = {
            "bitwise": bool(bitwise17), "launches_equal": bool(launches_equal),
            "device_events": {f"{'pipelined' if p else 'serial'}_"
                              f"{'on' if on else 'off'}":
                              sum(v["device_events"].values())
                              for (p, on), v in prof17.items()},
            "device_events_differ_on_off": events_differ,
            "device_ms_spread": dev_spread,
            "progress_max_rel_err": prog_err, "rows_ok": bool(rows_ok),
            "spans_ok": bool(spans_ok), "cost_max_rel_err": cost_err,
            "schema_failures": [str(b) for b in bad],
            "watchdog_trips": tripped}
        print(f"# obs 17a plane on vs off: {json.dumps(orep['plane'])}",
              flush=True)
        if not (bitwise17 and launches_equal):
            fail("the plane changes the chains or the launches")
        if dev_spread > 0.03:
            fail(f"device ms a quantum move by {dev_spread:.4f} with the "
                 "plane on (more than the 3 % device spread)")
        if not (rows_ok and prog_err <= 1e-6):
            fail(f"progress() differs from the diagnostics of the drained "
                 f"rows by {prog_err:.3g} (allowed 1e-6)")
        if not spans_ok:
            fail("the trace lacks a span of some (tenant, quantum, role)")
        if bad:
            fail(f"records violate the port's schema: {bad[:4]}")
        if cost_err > 1e-9:
            fail(f"the tenants' cost misses the dispatch wall by "
                 f"{cost_err:.3g} relative (allowed 1e-9)")
        if tripped:
            fail(f"the watchdog tripped on a clean run: {tripped}")
        del runs17

        n_wd = len(wd_states)
        # 17b. a stalled dispatch: the pool warms for one quantum, then the
        # next dispatch sleeps 2 s under a watchdog whose floor is 0.5 s
        stall = {}
        for pipeline in (False, True):
            d = os.path.join(tmp17, f"stall{int(pipeline)}")
            s = pool_server(pipeline, flight_dir=d, watchdog_spec=WatchdogSpec(
                min_deadline_s=0.5, deadline_factor=2.0, tick_s=0.05))
            polls, first_trip, stop = [], {}, threading.Event()

            def poll(s=s, polls=polls, first_trip=first_trip, stop=stop):
                while not stop.is_set():
                    t0 = time.perf_counter()
                    hz = s.healthz()
                    polls.append(time.perf_counter() - t0)
                    trip = hz["watchdog"]["trip"]
                    if trip is not None and not first_trip:
                        first_trip.update(hz=hz, quanta=s.quanta,
                                          cause=trip["cause"])
                    time.sleep(0.02)

            th = threading.Thread(target=poll, daemon=True)
            with faults.inject(faults.FaultSpec(
                    "dispatch_stall", after=1, action="sleep", seconds=2.0)):
                hs = [s.submit(r) for r in tenant_set()[:2]]
                th.start()
                try:
                    wall = drive(s)
                finally:
                    stop.set()
                    th.join(5.0)
                fired = faults.fired_counts()
            count_run(s)
            res = [h.result(timeout=WAIT_S) for h in hs]
            pm_path = os.path.join(d, "postmortem.json")
            pm = json.load(open(pm_path)) if os.path.exists(pm_path) else {}
            n_bad = len(bad)
            if first_trip:
                check_schema(first_trip["hz"], "healthz", "stalled healthz")
            check_schema(pm, "postmortem", "stall postmortem")
            stall["pipelined" if pipeline else "serial"] = rec = {
                "wall_s": wall, "quanta": s.quanta,
                "fired": {f"{p}:{t}": n for (p, t), n in fired.items()},
                "trip_cause": first_trip.get("cause"),
                "trip_seen_at_quanta": first_trip.get("quanta"),
                "healthz_ok_during_stall": (first_trip["hz"]["ok"]
                                            if first_trip else None),
                "healthz_polls": len(polls),
                "healthz_max_ms": 1e3 * max(polls) if polls else None,
                "postmortem_reason": pm.get("reason"),
                "schema_ok": len(bad) == n_bad,
                "bitwise": [bool(same_rows(a, b))
                            for a, b in zip(res, first[:2])]}
            print(f"# obs 17b stall, {'pipelined' if pipeline else 'serial'}"
                  f": {json.dumps(rec)}", flush=True)
            if not (rec["trip_cause"] == "dispatch_stall"
                    and rec["trip_seen_at_quanta"] == 1
                    and rec["healthz_ok_during_stall"] is False
                    and rec["postmortem_reason"] == "watchdog:dispatch_stall"
                    and rec["schema_ok"] and all(rec["bitwise"])
                    and rec["fired"] == {"dispatch_stall:None": 1}):
                fail("the stalled dispatch was not reported during the "
                     "stall, left no valid postmortem, or changed a tenant")
        orep["stall"] = stall
        del wd_states[n_wd:]    # these runs trip it on purpose

        # 17c. eviction at convergence: the tenant with the longest budget
        # of the first four, its ESS target the min-ESS its uninterrupted
        # rows first reach at a quantum k >= 2 before its budget, above
        # every earlier quantum's where the monitor evaluates (from 15a's
        # rows: it must converge at exactly k quanta)
        ev = max(range(4), key=lambda i: budgets[i])
        ref = first[ev]
        xs = np.asarray(ref.chain)[:, :, MON]
        nq = budgets[ev] // Q
        k1 = -(-MonitorSpec().min_rows // Q)    # the first evaluation
        ess_k = [float(ess_per_param(xs[:k * Q]).min())
                 for k in range(1, nq + 1)]
        k_ev = next((k for k in range(max(2, k1 + 1), nq)
                     if ess_k[k - 1] > max(ess_k[k1 - 1:k - 1])), None)
        if k_ev is None:
            fail(f"no quantum before the budget raises tenant {ev}'s "
                 f"min-ESS: {ess_k}")
        target = ess_k[k_ev - 1]
        evict = {}
        for pipeline in (False, True):
            s = pool_server(pipeline)
            reqs = tenant_set()
            reqs[ev].monitor = MonitorSpec(params=MON, ess_target=target)
            reqs[ev].on_converged = "evict"
            hs = [s.submit(r) for r in reqs]
            wall = drive(s)
            count_run(s)
            h = hs[ev]
            res = h.result(timeout=WAIT_S)
            rows = res.chain.shape[0]
            spans = s.spans.spans()
            last_q = max(x["quantum"] for x in spans
                         if x["name"] == "quantum"
                         and x["tenant"] == h.tenant_id)
            lane0 = {e["tenant"]: e["lane0"]
                     for e in s.flight.bundle("phase17")["events"]
                     if e["kind"] == "admit"}
            backfilled = [x["tenant"] for x in spans
                          if x["name"] == "admit" and x["quantum"] == last_q + 1
                          and lane0[h.tenant_id] <= lane0.get(x["tenant"], -1)
                          < lane0[h.tenant_id] + POOL_CHAINS]
            summ = s.summary()
            others = [same_rows(a, b) for i, (a, b) in enumerate(zip(
                [x.result(timeout=WAIT_S) for x in hs], first)) if i != ev]
            evict["pipelined" if pipeline else "serial"] = rec = {
                "tenant": ev, "budget": budgets[ev], "ess_target": target,
                "converged_at": h.converged_at, "expected": k_ev * Q,
                "status": h.status, "rows": rows,
                "prefix_bitwise": bool(cut_equal(res, ref, rows=rows)),
                "last_quantum": last_q, "backfilled": backfilled,
                "converged_evictions": summ["converged_evictions"],
                "others_bitwise": bool(all(others)),
                "occupancy": summ["occupancy"], "quanta": s.quanta,
                "wall_s": wall,
                "busy_chain_sweeps_per_s": summ["busy_chain_sweeps"] / wall}
            print(f"# obs 17c evict, {'pipelined' if pipeline else 'serial'}"
                  f": {json.dumps(rec)}", flush=True)
            if not (h.status == "done" and h.converged_at == k_ev * Q
                    and k_ev * Q <= rows < budgets[ev]
                    and (pipeline or rows == k_ev * Q)
                    and rec["prefix_bitwise"] and backfilled
                    and summ["converged_evictions"] == 1
                    and rec["others_bitwise"]):
                fail("the converged tenant was not evicted at its boundary "
                     "with a bitwise prefix, or its groups did not backfill")
        orep["evict"] = evict
        if "tripped" in wd_states:
            fail("the watchdog tripped in a clean run of phase 17")
        counts17 = check_launches("pool_obs", run17[0], run17[1])
    finally:
        shutil.rmtree(tmp17, ignore_errors=True)

    for name in ("serial", "pipelined"):
        r, base = orep[name], srep[name]

        def two(vals, f=".2f"):
            return " / ".join(format(v, f) for v in vals)

        print(f"# obs 17a pool1024 {name}: plane on "
              f"{two(r['ms_per_quantum_on'])} ms a quantum, off "
              f"{two(r['ms_per_quantum_off'])} (15a: "
              f"{base['ms_per_quantum']:.2f}); "
              f"monitor feed {two(r['monitor_host_ms_per_quantum'], '.3f')} "
              f"ms and obs_dir refresh "
              f"{two(r['obs_refresh_host_ms_per_quantum'], '.3f')} ms a "
              f"quantum (host); dispatch host on "
              f"{two(r['dispatch_host_ms_on'], '.3f')}, off "
              f"{two(r['dispatch_host_ms_off'], '.3f')} | {card}",
              flush=True)
    dv = orep["device"]
    print(f"# obs 17a pool1024 device (serial, profiled): "
          f"{dv['ms_per_quantum_on']:.3f} / {dv['ms_per_quantum_off']:.3f} ms "
          f"and {dv['events_on']} / {dv['events_off']} device events in "
          f"{dv['profiled_quanta'][0]} quanta, plane on / off | {card}",
          flush=True)
    for name in ("serial", "pipelined"):
        e, base = orep["evict"][name], srep[name]
        print(f"# obs 17c pool1024 {name}: tenant {e['tenant']} evicted at "
              f"sweep {e['converged_at']} of {e['budget']} ({e['rows']} rows "
              f"served), occupancy {e['occupancy']:.4f}, "
              f"{e['busy_chain_sweeps_per_s']:.1f} busy chain-sweeps/s "
              f"(15a: occupancy {base['occupancy']:.4f}, "
              f"{' / '.join(format(v, '.1f') for v in base['busy_chain_sweeps_per_s'])}"
              f") | {card}", flush=True)
    orep["launches"] = counts17
    orep["seconds"] = time.perf_counter() - t17
    print(f"# phase 17: {orep['seconds']:.1f} s", flush=True)

    # --- 18. the capacity arms: adaptive scans, warm starts, recycling ------
    import contextlib as _ctx

    from gibbs_student_t_tpu_torch.serve import (
        AdaptScanSpec,
        WarmStartFit,
        WarmStartSpec,
    )
    from gibbs_student_t_tpu_torch.serve import TenantMonitor
    from gibbs_student_t_tpu_torch.serve.adapt import NBLOCKS

    t18 = time.perf_counter()
    crep = report["capacity"] = {}
    tmp18 = tempfile.mkdtemp(prefix="gst_chip_smoke_capacity_")
    run18 = [0, 0]          # pool sweeps and quanta of phase 18's servers
    MON18 = [0, 1, 2]       # the monitored parameters
    CAP_TENANTS = 4         # a window of 4 tenants of 256 chains

    @_ctx.contextmanager
    def env_set(var, value):
        old = os.environ.get(var)
        os.environ[var] = value
        try:
            yield
        finally:
            if old is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = old

    def window_set(nq, seed0, monitor=None, adapt=0):
        """4 tenants of 256 chains for ``nq`` quanta, ``monitor`` on each,
        an ``AdaptScanSpec`` on the first ``adapt``."""
        return [TenantRequest(
            ma=tenant_mas[i], niter=nq * Q, nchains=POOL_CHAINS,
            seed=seed0 + i, monitor=monitor,
            adapt_scan=AdaptScanSpec(floor=0.25) if i < adapt else None)
            for i in range(CAP_TENANTS)]

    def serve18(s, reqs, keep_open=False):
        """Serve ``reqs`` to idle (``drive``, or, with ``keep_open``, the
        same without the close) and count the run; the server, handles,
        results, wall, and each kernel's launches and launches a
        quantum."""
        before = launches_now()
        hs = [s.submit(r) for r in reqs]
        if keep_open:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        else:
            wall = drive(s)
        launches = {n: c - before[n] for n, c in launches_now().items()}
        run18[0] += s.quanta * Q
        run18[1] += s.quanta
        res = [h.result(timeout=WAIT_S) for h in hs]
        return dict(s=s, hs=hs, res=res, wall=wall, launches=launches,
                    per_q={n: c / s.quanta for n, c in launches.items()})

    # 18a-iii. the gates on the card against the CPU: a 64-lane pool (two
    # tenants of 32 chains) and its CPU twin, the first tenant's white,
    # hyper (so b) and z blocks gated, the second's theta, alpha and df;
    # after a quantum of 5 sweeps at full rate, two quanta of 5 sweeps,
    # each sweep from the card's state with the card's draws, ties
    # separated as in 11b (these sweeps are not counted with the served
    # runs' launches)
    Q_S = 5
    gates18 = [np.ones(NBLOCKS, np.float32) for _ in range(2)]
    gates18[0][[0, 1, 4]] = 0.0
    gates18[1][[3, 5, 6]] = 0.0
    carried18 = (("x", "b", "z", "pout"), ("theta", "alpha", "df"))
    C2 = POOL_CPU_CHAINS
    pools18 = {}
    for device in (dev, "cpu"):
        pl = SlotPool(template, cfg_p, nlanes=POOL_CPU_LANES, quantum=Q_S,
                      record="full", device=device)
        for i in range(2):
            be = tb.TorchGibbs(tenant_mas[i], cfg_p, nchains=C2,
                               device=device, tnt_block_size=None)
            lanes = np.arange(i * C2, (i + 1) * C2)
            pl.write_tenant(TenantSlot(i, lanes, C2, 2 * Q_S, 0, 500 + i),
                            be, be.init_state(seed=500 + i))
        pools18[device] = pl
    pg, pc = pools18[dev], pools18["cpu"]
    # a quantum at full rate on the card first, as 11b starts from a state
    # two sweeps in (each sweep below starts from the card's state)
    pg.run_quantum()
    for pl in (pg, pc):
        for i in range(2):
            pl.set_block_gates(np.arange(i * C2, (i + 1) * C2), gates18[i])
        pl._upload()
    gg, gc = pg.block_gates(), pc.block_gates()
    st = pg.state
    gate_rows = []
    for j in range(2 * Q_S):
        dr = pg._lane_draws(st, pg._lane_sweep + j)
        dr = type(dr)(*(t.clone() for t in dr))
        st_c = type(st)(*map(to_cpu, st))
        for name, field in (("white_mh_lanes", "logu_w"),
                            ("hyper_mh_lanes", "logu_h")):
            dr_c = type(dr)(*map(to_cpu, dr))
            (g,) = capture([name], lambda: pg.sampler._sweep(
                st, dr, 0, block_gates=gg)).values()
            (c,) = capture([name], lambda: pc.sampler._sweep(
                st_c, dr_c, 0, block_gates=gc)).values()
            gname = name.replace("lanes", "grouped")
            lu = grouped_sep(gname, lanes_grouped(name, g), others=(
                grouped_ll(gname, lanes_grouped(name, c), torch.float32),))
            dr = dr._replace(**{field: lu})
        dr_c = type(dr)(*map(to_cpu, dr))
        out_g = pg.sampler._sweep(st, dr, 0, block_gates=gg)
        out_c = pc.sampler._sweep(st_c, dr_c, 0, block_gates=gc)
        nw, nh = cfg_p.mh.n_white_steps, cfg_p.mh.n_hyper_steps
        agree = ((torch.round(to_cpu(out_g.acc_white) * nw)
                  == torch.round(out_c.acc_white * nw))
                 & (torch.round(to_cpu(out_g.acc_hyper) * nh)
                    == torch.round(out_c.acc_hyper * nh)))
        carried = all(
            torch.equal(lanes_flat(getattr(out_g, f))[i * C2:(i + 1) * C2],
                        lanes_flat(getattr(st, f))[i * C2:(i + 1) * C2])
            for i, fields in enumerate(carried18) for f in fields)
        gate_rows.append({
            "sweep": j, "chains_acc_mismatch": int((~agree).sum()),
            "carried_bitwise": bool(carried),
            **{f: rel_err(to_cpu(getattr(out_g, f)), getattr(out_c, f))[:2]
               for f in ("x", "b")}})
        st = out_g
    crep["gated_card_vs_cpu"] = gate_rows
    print(f"# capacity 18a gated pool card-vs-cpu ({POOL_CPU_LANES} lanes, "
          f"2 x {Q_S} sweeps): {json.dumps(gate_rows)}", flush=True)
    # tolerance: the gated fields bitwise their carried values on the card;
    # every chain's accept counts equal and x to 1e-4 relative at every
    # sweep, as 11b (b reported, as 11b reports it)
    if not all(r["carried_bitwise"] and r["chains_acc_mismatch"] == 0
               and r["x"][1] <= 1e-4 for r in gate_rows):
        fail("a gated pool sweep on the card does not carry the gated "
             "fields, or disagrees with the CPU's")
    del pools18, pg, pc, st, st_c, dr, dr_c, out_g, out_c

    reset_counts()
    try:
        # 18a-ii. two of four monitored tenants with an AdaptScanSpec (an
        # ESS target of 1: every block converged at the first evaluation,
        # so each thins to the floor), against the same four monitored
        # without, both executors in turns
        mon18 = MonitorSpec(params=MON18, ess_target=1.0)
        thin = {(p, t): [] for p in (False, True) for t in (True, False)}
        order = ((False, True), (False, False), (True, False), (True, True))
        for pipeline, th in order:
            r = serve18(pool_server(pipeline),
                        window_set(5, 720, mon18, adapt=2 if th else 0))
            r["adapt"] = r["s"].summary()["adapt"]
            r["views"] = [h.adapt for h in r["hs"]]
            thin[(pipeline, th)].append(r)
        per_q0 = thin[(False, False)][0]["per_q"]
        thin_ok = {
            "thinned": all(r["adapt"]["tenants_thinned"] == 2
                           and all(v and v["probs"] for v in r["views"][:2])
                           for p in (False, True) for r in thin[(p, True)]),
            "unthinned": all(r["adapt"]["tenants_thinned"] == 0
                             and not any(r["views"])
                             for p in (False, True)
                             for r in thin[(p, False)]),
            "launches_equal": all(r["per_q"] == per_q0
                                  for rs in thin.values() for r in rs)}
        # the launches and device ms a quantum of every device op, thinning
        # and not: a device-only profile of the same window, serial
        prof18 = {}
        for th in (True, False):
            s = pool_server(False)
            for req in window_set(5, 720, mon18, adapt=2 if th else 0):
                s.submit(req)
            prof = profile_calls(torch, lambda s=s: drive(s), 1, cpu=False)
            run18[0] += s.quanta * Q
            run18[1] += s.quanta
            if prof["device_ms_per_sweep"] <= 0:
                fail("the profiler saw no device time in phase 18's window")
            prof18[th] = {
                "quanta": s.quanta,
                "device_ms_per_quantum": prof["device_ms_per_sweep"]
                / s.quanta,
                "launches_per_sweep": prof["launches_per_sweep"]
                / (s.quanta * Q)}
        for pipeline in (False, True):
            name = "pipelined" if pipeline else "serial"
            crep[f"adapt_{name}"] = {
                f"ms_per_quantum_{'thin' if th else 'full'}": [
                    1e3 * r["wall"] / r["s"].quanta
                    for r in thin[(pipeline, th)]]
                for th in (True, False)}
            crep[f"adapt_{name}"]["gate_updates"] = [
                r["adapt"]["updates"] for r in thin[(pipeline, True)]]
        crep["adapt_probs"] = thin[(False, True)][0]["views"][0]["probs"]
        crep["adapt_profile"] = {"thin" if th else "full": v
                                 for th, v in prof18.items()}
        crep["adapt_checks"] = thin_ok
        print(f"# capacity 18a adaptive scans: {json.dumps(thin_ok)}",
              flush=True)
        if not all(thin_ok.values()):
            fail("an adaptive tenant did not thin, a tenant without a spec "
                 "did, or thinning changed the kernels' launches")
        del thin

        # 18b. warm starts: four WarmStartSpec() tenants and one flow tenant
        # of 128 chains, monitored, on the pipelined executor (their pilots
        # served on the pool, one wave), against the same tenants cold; a
        # journaled fit given to a new server draws the same x0 and gives
        # the same tenant
        W_CHAINS, W_QUANTA = 128, 8
        mon_w = MonitorSpec(params=MON18)

        def warm_set(warm):
            return [TenantRequest(
                ma=tenant_mas[i], niter=W_QUANTA * Q, nchains=W_CHAINS,
                seed=800 + i, monitor=mon_w,
                warm_start=((WarmStartSpec(kind="flow") if i == 4
                             else WarmStartSpec()) if warm else None))
                for i in range(5)]

        man18 = os.path.join(tmp18, "manifest")
        s = pool_server(True, manifest_dir=man18)
        try:
            w = serve18(s, warm_set(True), keep_open=True)
            journal = {r["seed"]: r["warm"] for r in read_manifest(man18)
                       if r.get("kind") == "admit"}
        finally:
            s.close(timeout=WAIT_S)
        wd_states.append(s.healthz()["watchdog"]["state"])
        w_summ = s.summary()["warm"]
        c = serve18(pool_server(True), warm_set(False))
        # the replay: the gmm tenant 0 and the flow tenant 4 from their
        # journaled fits on a new server, no pilot
        replay_idx = (0, 4)
        rp = serve18(pool_server(True), [
            TenantRequest(ma=tenant_mas[i], niter=W_QUANTA * Q,
                          nchains=W_CHAINS, seed=800 + i, monitor=mon_w,
                          warm_start=journal[800 + i])
            for i in replay_idx])
        # the convergence verdict of one ESS target on every tenant's rows,
        # warm and cold: the monitor's own update, quantum by quantum, with
        # the target the cold tenants' median min-ESS after half the budget
        ess_half = float(np.median([
            ess_per_param(r.chain[:W_QUANTA // 2 * Q][:, :, MON18]).min()
            for r in c["res"]]))

        def verdict(res):
            mon = TenantMonitor(MonitorSpec(params=MON18,
                                            ess_target=ess_half),
                                W_CHAINS, np.asarray(MON18))
            for k in range(1, W_QUANTA + 1):
                mon.update(res.chain[(k - 1) * Q:k * Q], k * Q)
            return mon.converged_at

        x0_ok = all(np.array_equal(
            w["res"][i].chain[0],
            WarmStartFit.from_json(journal[800 + i]).draw_x0(
                W_CHAINS, 800 + i, tenant_mas[i].specs_np).astype(
                    np.float32)) for i in replay_idx)
        warm_ok = {
            "warm_starts": w_summ["warm_starts"],
            "degraded": w_summ["degraded"],
            "pilot_batches": w_summ["pilot_batches"],
            "pilot_batched_fits": w_summ["pilot_batched_fits"],
            "flow_fits": w_summ["flow_fits"],
            "kinds": [h.warm["kind"] for h in w["hs"]],
            "journaled": sorted(journal) == [800 + i for i in range(5)],
            "x0_replayed_bitwise": bool(x0_ok),
            "replay_bitwise": all(
                same_rows(a, w["res"][i])
                for a, i in zip(rp["res"], replay_idx)),
            "replayed_without_pilot": all(
                h.warm["replayed"] for h in rp["hs"])
            and rp["s"].summary()["warm"]["pilot_ms_total"] == 0.0,
            "finite": all(np.isfinite(r.chain).all() for r in w["res"])}
        crep["warm"] = {
            **warm_ok, "pilot_ms_total": w_summ["pilot_ms_total"],
            "tenants": [{
                "kind": h.warm["kind"], "batched": h.warm["batched"],
                "pilot_ms": h.warm["pilot_ms"],
                "admission_ms": [h.admission_ms, hc.admission_ms],
                "first_result_ms": [h.first_result_ms, hc.first_result_ms],
                "converged_at": [verdict(rw), verdict(rc)],
                "ess_min_final": [h.progress()["ess_min"],
                                  hc.progress()["ess_min"]]}
                for h, hc, rw, rc in zip(w["hs"], c["hs"], w["res"],
                                         c["res"])],
            "ess_target": ess_half,
            "wall_s": [w["wall"], c["wall"]],
            "quanta": [w["s"].quanta, c["s"].quanta]}
        print(f"# capacity 18b warm starts: {json.dumps(warm_ok)}",
              flush=True)
        if not (warm_ok["warm_starts"] == 5 and warm_ok["degraded"] == 0
                and warm_ok["pilot_batches"] >= 1
                and warm_ok["flow_fits"] == 1
                and warm_ok["kinds"] == ["gmm"] * 4 + ["flow"]
                and warm_ok["journaled"] and warm_ok["x0_replayed_bitwise"]
                and warm_ok["replay_bitwise"]
                and warm_ok["replayed_without_pilot"]
                and warm_ok["finite"]):
            fail("the warm starts did not ride one pilot wave, degraded, or "
                 "a journaled fit did not replay the tenant bitwise")
        del w, c, rp

        # 18c. recycling on against off, each executor, in turns: the window
        # with two spooled tenants; its first run with every lane's gates
        # armed at ones, and a last one on a pool built without gates
        # (GST_ADAPT_SCAN=0), both held to the others bit for bit with equal
        # launches a quantum (18a's all-ones check)
        rec = {}
        for pipeline, on, arm in ((False, True, "ones"), (False, False, ""),
                                  (True, False, ""), (True, True, ""),
                                  (False, True, "off")):
            reqs = window_set(4, 900)
            for i in range(2):
                reqs[i].spool_dir = os.path.join(
                    tmp18, f"rec{int(pipeline)}{int(on)}{arm}_{i}")
            if arm == "off":
                with env_set("GST_ADAPT_SCAN", "0"):
                    s = pool_server(pipeline, recycle=on)
            else:
                s = pool_server(pipeline, recycle=on)
            if s.pool.adaptive is (arm == "off"):
                fail("GST_ADAPT_SCAN=0 did not build a pool without gates")
            if arm == "ones":
                s.pool.set_block_gates(np.arange(POOL_LANES),
                                       np.ones(NBLOCKS, np.float32))
            rec[(pipeline, on, arm)] = r = serve18(s, reqs)
            r["dirs"] = [q.spool_dir for q in reqs[:2]]

        def spool_bytes(d):
            out = {}
            for name in sorted(os.listdir(d)):
                if name.endswith(".spool"):
                    with open(os.path.join(d, name), "rb") as fh:
                        out[name] = fh.read()
            return out

        base = rec[(False, True, "ones")]["res"]
        rec_ok = {
            "bitwise": all(same_rows(a, b) for r in rec.values()
                           for a, b in zip(r["res"], base)),
            "spools_bitwise": all(
                spool_bytes(a) == spool_bytes(b)
                for key in rec for a, b in zip(
                    rec[key]["dirs"], rec[(False, True, "ones")]["dirs"])),
            "recycled_rows": all(
                h.recycled_rows == ((res.chain.shape[0] - 1)
                                    * res.chain.shape[1] if on else 0)
                and ("recycle" in res.stats) == on
                for (p, on, _), r in rec.items()
                for h, res in zip(r["hs"], r["res"])),
            "launches_equal": all(
                r["per_q"] == rec[(False, True, "ones")]["per_q"]
                for r in rec.values())}
        for pipeline in (False, True):
            crep[f"recycle_{'pipelined' if pipeline else 'serial'}"] = {
                f"drain_host_ms_{'on' if on else 'off'}":
                rec[(pipeline, on, "ones" if not pipeline and on else "")][
                    "s"].summary()["host_ms"]["drain"]["mean"]
                for on in (True, False)}
        crep["recycle"] = rec_ok
        print(f"# capacity 18c recycling on vs off, gates all ones and "
              f"GST_ADAPT_SCAN=0: {json.dumps(rec_ok)}", flush=True)
        if not all(rec_ok.values()):
            fail("recycling or the all-ones gates changed the chains, the "
                 "spools or the launches, or the recycled rows miscount")
        del rec
        if "tripped" in wd_states:
            fail("the watchdog tripped in a run of phase 18")
        counts18 = check_launches("pool_capacity", run18[0], run18[1])
    finally:
        shutil.rmtree(tmp18, ignore_errors=True)

    for pipeline in (False, True):
        name = "pipelined" if pipeline else "serial"
        a = crep[f"adapt_{name}"]
        print(f"# capacity 18a pool1024 {name}: ms a quantum thinning "
              f"{' / '.join(format(v, '.2f') for v in a['ms_per_quantum_thin'])}"
              f", full rate "
              f"{' / '.join(format(v, '.2f') for v in a['ms_per_quantum_full'])}"
              f"; gate updates {a['gate_updates']} | {card}", flush=True)
    pf = crep["adapt_profile"]
    print(f"# capacity 18a pool1024 device (serial, profiled): thinning "
          f"{pf['thin']['launches_per_sweep']:.1f} launches a sweep, "
          f"{pf['thin']['device_ms_per_quantum']:.3f} ms a quantum; full "
          f"rate {pf['full']['launches_per_sweep']:.1f}, "
          f"{pf['full']['device_ms_per_quantum']:.3f}; selection "
          f"probabilities {json.dumps(crep['adapt_probs'])} | {card}",
          flush=True)
    wm = crep["warm"]
    for t in wm["tenants"]:
        print(f"# capacity 18b warm {t['kind']} (batched {t['batched']}): "
              f"pilot {t['pilot_ms']:.1f} ms; admission "
              f"{t['admission_ms'][0]:.1f} ms warm / {t['admission_ms'][1]:.1f}"
              f" cold; first result {t['first_result_ms'][0]:.1f} / "
              f"{t['first_result_ms'][1]:.1f} ms; at ESS "
              f"{wm['ess_target']:.1f} converged at sweep "
              f"{t['converged_at'][0]} warm / {t['converged_at'][1]} cold, "
              f"final min-ESS {t['ess_min_final'][0]:.1f} / "
              f"{t['ess_min_final'][1]:.1f} | {card}", flush=True)
    for pipeline in (False, True):
        name = "pipelined" if pipeline else "serial"
        r = crep[f"recycle_{name}"]
        print(f"# capacity 18c pool1024 {name}: drain host ms a quantum, "
              f"recycling on {r['drain_host_ms_on']:.3f}, off "
              f"{r['drain_host_ms_off']:.3f} | {card}", flush=True)
    crep["launches"] = counts18
    crep["seconds"] = time.perf_counter() - t18
    print(f"# phase 18: {crep['seconds']:.1f} s", flush=True)

    # --- 19. the wire for one pool (pool1024) -------------------------------
    import urllib.error
    import urllib.request

    from gibbs_student_t_tpu_torch.serve import RemoteChainServer, RpcServer
    from gibbs_student_t_tpu_torch.serve import rpc as rpc_mod
    from gibbs_student_t_tpu_torch.serve.pool_main import write_spec

    t19 = time.perf_counter()
    wrep = report["wire"] = {}
    tmp19 = tempfile.mkdtemp(prefix="gst_chip_smoke_wire_")
    run19 = [0, 0]          # pool sweeps and quanta of phase 19's servers
    workers = []            # every worker process this phase started
    prom_line = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*='
        r'"([^"\\]|\\.)*",?)*\})? (NaN|[+-]Inf|-?[0-9.eE+-]+)( -?[0-9]+)?$')

    def http_get(port, route):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                        timeout=120) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read().decode()

    def worker_log(d):
        try:
            with open(os.path.join(d, "worker.log")) as fh:
                return fh.read()[-3000:]
        except OSError:
            return ""

    def spawn(name, *args):
        """A pool1024 worker on the card (serve/pool_main.py: the serial
        executor, light records), its output in its directory's log."""
        d = os.path.join(tmp19, name)
        if not os.path.exists(os.path.join(d, "spec.pkl")):
            write_spec(d, template, cfg_p, dict(
                nlanes=POOL_LANES, quantum=POOL_QUANTUM, record="light",
                pipeline=False))
        with open(os.path.join(d, "worker.log"), "a") as log:
            t = time.time()
            p = subprocess.Popen(
                [sys.executable, "-m",
                 "gibbs_student_t_tpu_torch.serve.pool_main", "--dir", d,
                 *args], cwd=HERE, stdout=log, stderr=subprocess.STDOUT)
        workers.append(p)
        return d, p, t

    def ready_of(d, p, key=None):
        """The worker's ready.json once written (and holding ``key`` in
        its coldstart block, when given)."""
        path = os.path.join(d, "ready.json")
        t_end = time.monotonic() + CHILD_TIMEOUT_S
        while True:
            if os.path.exists(path):
                with open(path) as fh:
                    doc = json.load(fh)
                if key is None or key in doc["coldstart"]:
                    return doc
            if p.poll() is not None:
                fail(f"a worker exited {p.returncode} before it was ready: "
                     f"{worker_log(d)}")
            if time.monotonic() > t_end:
                fail(f"a worker was not ready in {CHILD_TIMEOUT_S} s: "
                     f"{worker_log(d)}")
            time.sleep(0.05)

    def ended(d, p):
        try:
            return p.wait(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            fail(f"a worker did not exit in {CHILD_TIMEOUT_S} s: "
                 f"{worker_log(d)}")

    def named_set():
        reqs = tenant_set()
        for i, r in enumerate(reqs):
            r.name = f"w{i}"
        return reqs

    def in_process(rpc_mounted):
        """The tenant set on an in-process serial server (behind an
        RpcServer, submitted over loopback, with ``rpc_mounted``): wall,
        summary, each kernel's launches, results."""
        s = pool_server(False)
        rpc = cl = None
        reqs = named_set()
        before = launches_now()
        if rpc_mounted:
            rpc = RpcServer(s)
            cl = RemoteChainServer(rpc.address, timeout=120.0)
            reqs[0].on_chunk = lambda h, sweep_end, records: None
            hs = [cl.submit(r) for r in reqs]
        else:
            hs = [s.submit(r) for r in reqs]
        try:
            wall = drive(s)
            res = [h.result(timeout=WAIT_S) for h in hs]
        finally:
            if rpc is not None:
                cl.close()
                rpc.close()
        launches = {n: c - before[n] for n, c in launches_now().items()}
        run19[0] += s.quanta * Q
        run19[1] += s.quanta
        return dict(wall=wall, summary=s.summary(), launches=launches,
                    quanta=s.quanta, res=res)

    def frame_cost(body, reps=5):
        """Bytes of ``body``'s frame, and its mean encode and decode ms."""
        t0 = time.perf_counter()
        for _ in range(reps):
            data = rpc_mod.encode_frame(body)
        enc = 1e3 * (time.perf_counter() - t0) / reps
        _, _, kind, _ = rpc_mod._HEADER.unpack(data[:rpc_mod._HEADER.size])
        payload = data[rpc_mod._HEADER.size:]
        t0 = time.perf_counter()
        for _ in range(reps):
            rpc_mod.decode_payload(kind, payload)
        dec = 1e3 * (time.perf_counter() - t0) / reps
        return {"bytes": len(data), "encode_ms": enc, "decode_ms": dec}

    # every submit frame the parent's clients send: (name, model
    # attached, bytes)
    sent = []
    plain_send = rpc_mod.send_frame

    def counting_send(sock, body, max_frame=None):
        if body.get("op") == "submit":
            sent.append((body.get("name"), "ma" in body,
                         len(rpc_mod.encode_frame(body))))
        return plain_send(sock, body, max_frame)

    reset_counts()
    rpc_mod.send_frame = counting_send
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    try:
        # 19a. spawn a worker on the card; it arms a sever of the "sev"
        # tenant's stream at its second chunk (its submit request is the
        # point's first traversal)
        sever = json.dumps([{"point": "rpc_sever", "tenant": "sev",
                             "after": 2}])
        d1, w1, t_spawn = spawn("w1", "--faults", sever)
        ready1 = ready_of(d1, w1)
        spawn_s = time.time() - t_spawn
        if not (ready1.get("rpc_port") and ready1.get("http_port")):
            fail(f"the worker's ready.json lacks a port: {ready1}")
        if ready1["coldstart"]["library"] not in ("built", "loaded"):
            fail(f"the worker did not load the kernels: {ready1}")
        wrep["spawn"] = {"spawn_to_ready_s": spawn_s,
                         "coldstart": ready1["coldstart"]}
        hport = ready1["http_port"]
        cli = RemoteChainServer(("127.0.0.1", ready1["rpc_port"]),
                                timeout=120.0)

        # 19b. the tenant set through the worker: every tenant bitwise
        # 15a's in-process serial results; w0 streamed, w1 and w2 traced
        chunks = []
        traced = {1: "wire-trace-1", 2: "wire-trace-2"}
        reqs = named_set()
        reqs[0].on_chunk = lambda h, sweep_end, records: chunks.append(
            (sweep_end, records))
        for i, tid in traced.items():
            reqs[i].trace_id = tid
        t0 = time.perf_counter()
        hs = [cli.submit(r) for r in reqs]
        res19 = [h.result(timeout=WAIT_S) for h in hs]
        set_wall_1 = time.perf_counter() - t0
        bitwise19 = [bool(same_rows(a, b)) for a, b in zip(res19, set_refs)]
        ends = [s_ for s_, _ in chunks]
        stream_ok = (ends == list(range(Q, budgets[0] + 1, Q))
                     and eq(np.concatenate([c["x"] for _, c in chunks]),
                            res19[0].chain))
        code, body = http_get(hport, "/trace")
        doc = json.loads(body)
        tagged = {hs[i].tenant_id: tid for i, tid in traced.items()}
        spans_x = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        tagged_ev = [e for e in spans_x if e["pid"] - 1 in tagged]
        trace_ok = (code == 200 and {e["pid"] - 1 for e in tagged_ev}
                    == set(tagged)
                    and all(e["args"].get("trace_id") == tagged[e["pid"] - 1]
                            for e in tagged_ev)
                    and not any("trace_id" in e["args"] for e in spans_x
                                if e["pid"] - 1 not in tagged))
        wrep["set"] = {"bitwise": bitwise19, "stream_ends": ends,
                       "stream_ok": bool(stream_ok),
                       "traced_spans": len(tagged_ev),
                       "trace_ok": bool(trace_ok), "wall_s": set_wall_1}
        print(f"# wire 19b the tenant set through the worker: "
              f"{json.dumps(wrep['set'])}", flush=True)
        if not (all(bitwise19) and stream_ok and trace_ok):
            fail("a tenant served by the worker differs from the in-process "
                 "run, its stream from its chain, or a trace id is missing")

        # 19c. the worker's HTTP endpoints
        http = {}
        code, body = http_get(hport, "/healthz")
        http["healthz"] = code == 200 and json.loads(body)["ok"] is True
        code, body = http_get(hport, "/status")
        st = json.loads(body)
        http["status"] = code == 200 and not obs_schema.validate(
            st, schemas["serve_status"], defs=schemas)
        code, text = http_get(hport, "/metrics")
        lines = [ln for ln in text.splitlines() if ln]
        http["metrics"] = (code == 200 and bool(lines) and all(
            ln.startswith(("# HELP ", "# TYPE ")) or prom_line.match(ln)
            for ln in lines) and "gst_serve_admissions" in text)
        http["progress"] = True
        for i in (0, 3, POOL_TENANTS):
            code, body = http_get(hport, f"/tenants/w{i}/progress")
            http["progress"] &= (code == 200
                                 and json.loads(body) == hs[i].progress())
        code, body = http_get(hport, "/postmortem")
        pm = json.loads(body)
        http["postmortem"] = (code == 200 and pm.get("reason") == "endpoint"
                              and not obs_schema.validate(
                                  pm, schemas["postmortem"], defs=schemas))
        http["unknown_404"] = http_get(hport, "/tenants/nobody/progress")[
            0] == 404
        wrep["http"] = http
        print(f"# wire 19c HTTP: {json.dumps(http)}", flush=True)
        if not all(http.values()):
            fail(f"a worker endpoint failed: {http}")

        # 19d. control over the wire: a digest-only resubmit (w0's model),
        # a queued tenant cancelled behind it, a bad model rejected while
        # the pool serves on, reset
        n_sent = len(sent)
        hf = cli.submit(TenantRequest(ma=tenant_mas[0], niter=2 * Q,
                                      nchains=POOL_LANES, seed=900,
                                      name="fill"))
        hq = cli.submit(TenantRequest(ma=tenant_mas[1], niter=Q,
                                      nchains=POOL_CHAINS, seed=901,
                                      name="queued"))
        ctl = {"cancel_returned": bool(hq.cancel())}
        try:
            hq.result(timeout=WAIT_S)
            ctl["cancelled"] = False
        except RuntimeError as exc:
            ctl["cancelled"] = "cancelled" in str(exc)
        psr_b, _ = make_contaminated_pulsar(n=130, components=20, theta=0.02,
                                            sigma_out=1e-5, seed=903)
        hb = cli.submit(TenantRequest(
            ma=make_reference_pta(psr_b, 20).frozen(0), niter=Q,
            nchains=POOL_CHAINS, seed=902, name="bad"))
        hg = cli.submit(TenantRequest(ma=tenant_mas[2], niter=2 * Q,
                                      nchains=POOL_CHAINS, seed=903,
                                      name="good"))
        try:
            hb.result(timeout=WAIT_S)
            ctl["bad_rejected"] = False
        except RuntimeError as exc:
            ctl["bad_rejected"] = "basis size" in str(exc)
        ctl["served_on"] = bool(
            finite_shaped(hg.result(timeout=WAIT_S), POOL_CHAINS, 2 * Q)
            and finite_shaped(hf.result(timeout=WAIT_S), POOL_LANES, 2 * Q))
        first_w0 = next(x for x in sent if x[0] == "w0")
        fill = sent[n_sent]
        ctl["submit_bytes"] = {"w0_with_model": first_w0[2],
                               "fill_digest_only": fill[2]}
        ctl["digest_only"] = first_w0[1] and not fill[1]
        cli.reset_counters()
        ctl["reset"] = cli.status()["quanta"] == 0

        # 19e. chaos: the sever of sev's stream at its second chunk; its
        # result fetched by id on a new connection
        sev_ends = []
        rq = tenant_set()[0]
        rq.name = "sev"
        rq.on_chunk = lambda h, sweep_end, records: sev_ends.append(
            sweep_end)
        hsv = cli.submit(rq)
        try:
            hsv.result(timeout=WAIT_S)
            ctl["severed"] = False
        except ConnectionError as exc:
            ctl["severed"] = "severed" in str(exc)
        res_sev = rpc_mod.RemoteTenantHandle(cli, hsv.tenant_id, None).result(
            timeout=WAIT_S)
        ctl["sever_chunks"] = sev_ends
        ctl["sever_bitwise"] = bool(same_rows(res_sev, set_refs[0]))
        wrep["control"] = ctl
        print(f"# wire 19d-e control and the sever: {json.dumps(ctl)}",
              flush=True)
        if not (all(v for k, v in ctl.items() if k not in (
                "submit_bytes", "sever_chunks"))
                and sev_ends == [Q]
                and fill[2] < first_w0[2]):
            fail(f"a control op over the wire failed: {ctl}")

        # 19f. the wire's cost, in turns: the set in process, through the
        # worker, in process, through the worker (its counters reset before
        # the first of its turns; its summary, written at its shutdown,
        # covers both); then behind an RpcServer mounted on an in-process
        # server, whose launches must equal the in-process runs'
        def worker_turn():
            q0 = cli.status()["quanta"]
            t0 = time.perf_counter()
            hs_ = [cli.submit(r) for r in named_set()]
            res_ = [h.result(timeout=WAIT_S) for h in hs_]
            wall = time.perf_counter() - t0
            q = cli.status()["quanta"] - q0
            return dict(wall=wall, quanta=q, res=res_,
                        ms_per_quantum=1e3 * wall / q)

        turns = [in_process(False)]
        cli.reset_counters()
        wturns = [worker_turn()]
        turns.append(in_process(False))
        wturns.append(worker_turn())
        # reported, not gated: the collapse rule reads chain-sweeps/s, so
        # a long-lived worker whose occupancy falls (one small tenant
        # after a full pool) can trip it
        wd = cli.healthz()["watchdog"]
        wd_worker = {"state": wd["state"],
                     "cause": (wd.get("trip") or {}).get("cause")}
        cli.shutdown()
        rc1 = ended(d1, w1)
        cli.close()
        if rc1 != 0:
            fail(f"the worker exited {rc1} after shutdown: {worker_log(d1)}")
        with open(os.path.join(d1, "summary.json")) as fh:
            wsum = json.load(fh)
        over_rpc = in_process(True)
        bit_more = all(same_rows(a, b) for t in turns + wturns + [over_rpc]
                       for a, b in zip(t["res"], set_refs))
        launches_equal = (over_rpc["quanta"] == turns[0]["quanta"]
                          and over_rpc["launches"] == turns[0]["launches"]
                          == turns[1]["launches"])
        per_sweep = {n: c / (over_rpc["quanta"] * Q)
                     for n, c in over_rpc["launches"].items() if c}
        # one 256-chain result frame, and one chunk frame of w0's stream
        frames = {
            "result": dict(frame_cost({"op": "result",
                                       "result": rpc_mod.Pickled(
                                           set_refs[0])}),
                           shape=list(set_refs[0].chain.shape)),
            "chunk": dict(frame_cost({"op": "chunk",
                                      "sweep_end": chunks[0][0],
                                      "records": {f: np.asarray(a) for f, a
                                                  in chunks[0][1].items()}}),
                          shape=list(chunks[0][1]["x"].shape))}

        def host_mean(summ, leg):
            return summ["host_ms"][leg]["mean"]

        wrep["cost"] = {
            "worker": {"quanta": [t["quanta"] for t in wturns],
                       "ms_per_quantum_client": [t["ms_per_quantum"]
                                                 for t in wturns],
                       "summary_quanta": wsum["quanta"],
                       "dispatch_host_ms": host_mean(wsum, "dispatch"),
                       "drain_host_ms": host_mean(wsum, "drain"),
                       "watchdog": wd_worker},
            "in_process": [{"quanta": t["quanta"],
                            "ms_per_quantum": 1e3 * t["wall"] / t["quanta"],
                            "dispatch_host_ms": host_mean(t["summary"],
                                                          "dispatch"),
                            "drain_host_ms": host_mean(t["summary"],
                                                       "drain")}
                           for t in turns],
            "over_rpc_in_process": {
                "ms_per_quantum": 1e3 * over_rpc["wall"] / over_rpc["quanta"],
                "launches_per_sweep": per_sweep,
                "launches_equal": bool(launches_equal)},
            "bitwise": bool(bit_more), "frames": frames}
        print(f"# wire 19f cost: {json.dumps(wrep['cost'])}", flush=True)
        if not (bit_more and launches_equal):
            fail("the wire's runs differ from the in-process run in chains "
                 "or launches")
        counts19 = check_launches("pool_wire", run19[0], run19[1])

        # 19e. chaos: a worker killed by pool_kill at its fourth completed
        # quantum over phase 15b's two spooled victims; a --recover worker
        # maps both and serves them bitwise their uninterrupted runs
        torch.cuda.empty_cache()
        kill_spec = json.dumps([{"point": "pool_kill", "after": 3,
                                 "action": "kill"}])
        d2, w2, _ = spawn("w2", "--faults", kill_spec)
        ready2 = ready_of(d2, w2)
        c2 = RemoteChainServer(("127.0.0.1", ready2["rpc_port"]),
                               timeout=120.0)
        for i in range(2):
            c2.submit(TenantRequest(
                ma=tenant_mas[4 + i], niter=KILL_SWEEPS, nchains=KILL_CHAINS,
                seed=300 + i, priority=2, name=f"v{i}",
                spool_dir=os.path.join(tmp19, "spools", f"v{i}")))
        rc2 = ended(d2, w2)
        c2.close()
        if rc2 != 9:
            fail(f"the pool_kill worker exited {rc2}, not 9: "
                 f"{worker_log(d2)}")
        os.remove(os.path.join(d2, "ready.json"))
        _, w3, t_spawn3 = spawn("w2", "--recover")
        ready3 = ready_of(d2, w3)
        ready3_s = time.time() - t_spawn3
        if set(ready3["recovered"]) != {"v0", "v1"} or ready3["lost"]:
            fail(f"the recovered worker did not map both victims: {ready3}")
        c3 = RemoteChainServer(("127.0.0.1", ready3["rpc_port"]),
                               timeout=120.0)
        got = [rpc_mod.RemoteTenantHandle(
            c3, ready3["recovered"][f"v{i}"], None).result(timeout=WAIT_S)
            for i in range(2)]
        first3 = ready_of(d2, w3, key="first_dispatch_t")["coldstart"]
        c3.shutdown()
        rc3 = ended(d2, w3)
        c3.close()
        rec = {"spawn_to_ready_s": ready3_s,
               "coldstart": first3,
               "first_dispatch_s": first3["first_dispatch_t"] - t_spawn3,
               "bitwise": [bool(g.chain.shape[0] == KILL_SWEEPS
                                and same_rows(g, r_))
                           for g, r_ in zip(got, refs)],
               "exit": rc3}
        wrep["kill"] = rec
        print(f"# wire 19e kill and recover: {json.dumps(rec)}", flush=True)
        if not (all(rec["bitwise"]) and rc3 == 0):
            fail("a victim of the killed worker did not recover bitwise, or "
                 "the recovered worker did not retire cleanly")
    finally:
        rpc_mod.send_frame = plain_send
        for p in workers:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp19, ignore_errors=True)

    print(f"# wire 19a pool1024 worker: ready.json {spawn_s:.2f} s after the "
          f"spawn, the kernels' library {ready1['coldstart']['library']} "
          f"({ready1['coldstart']['library_s']} s) | {card}", flush=True)
    print(f"# wire 19e the recovered worker's first dispatch "
          f"{wrep['kill']['first_dispatch_s']:.2f} s after its spawn "
          f"(16b's recovering process: {kill['first_dispatch_s']:.2f} s) | "
          f"{card}", flush=True)
    wc = wrep["cost"]
    print(f"# wire 19f pool1024 ms a quantum: worker "
          + " / ".join(format(v, ".2f")
                       for v in wc["worker"]["ms_per_quantum_client"])
          + f" (seen by the client; its dispatch "
          f"{wc['worker']['dispatch_host_ms']:.2f}, drain "
          f"{wc['worker']['drain_host_ms']:.2f} host ms), in process "
          + " / ".join(f"{t['ms_per_quantum']:.2f} (dispatch "
                       f"{t['dispatch_host_ms']:.2f}, drain "
                       f"{t['drain_host_ms']:.2f})" for t in wc["in_process"])
          + f"; behind an in-process RpcServer "
          f"{wc['over_rpc_in_process']['ms_per_quantum']:.2f}, launches a "
          f"sweep equal | {card}", flush=True)
    for kind, f_ in wc["frames"].items():
        print(f"# wire 19f {kind} frame {f_['shape']}: {f_['bytes']} bytes, "
              f"encode {f_['encode_ms']:.3f} ms, decode "
              f"{f_['decode_ms']:.3f} ms | {card}", flush=True)
    sb = wrep["control"]["submit_bytes"]
    print(f"# wire 19d submit frames: with the model {sb['w0_with_model']} "
          f"bytes, digest only {sb['fill_digest_only']} bytes", flush=True)
    wrep["launches"] = counts19
    wrep["seconds"] = time.perf_counter() - t19
    print(f"# phase 19: {wrep['seconds']:.1f} s", flush=True)

    # --- 20. the fleet on one card (pool1024) --------------------------------
    from gibbs_student_t_tpu_torch.obs import aggregate as fleet_agg
    from gibbs_student_t_tpu_torch.serve.router import (
        spawn_fleet,
        teardown_fleet,
    )

    t20 = time.perf_counter()
    flrep = report["fleet"] = {}
    tmp20 = tempfile.mkdtemp(prefix="gst_chip_smoke_fleet_")
    fleets = []             # every router this phase made
    worker_kw = dict(nlanes=POOL_LANES, quantum=Q, record="light",
                     pipeline=False)

    def fleet_of(name, **kw):
        """Two pool1024 workers on the card behind a router; no fallback:
        a worker that does not come up raises."""
        kw.setdefault("ready_timeout", CHILD_TIMEOUT_S)
        fl = spawn_fleet(os.path.join(tmp20, name), 2, template, cfg_p,
                         pool_kwargs=dict(worker_kw), **kw)
        fleets.append(fl)
        libs = [p.ready["coldstart"]["library"] for p in fl.pools]
        if any(lib not in ("built", "loaded") for lib in libs):
            fail(f"a fleet worker did not load the kernels: {libs}")
        return fl

    def fleet_set():
        reqs = tenant_set()
        for i, r in enumerate(reqs):
            r.name = f"f{i}"
        return reqs

    def through(fl, reqs, pin=None):
        """The requests through the router (all on pool ``pin`` when
        given): results, the wall, each worker's quanta in the run."""
        q0 = [p.rpc.status()["quanta"] for p in fl.pools]
        t0 = time.perf_counter()
        hs = [fl.submit(r, pool=pin) for r in reqs]
        res = [h.result(timeout=WAIT_S) for h in hs]
        wall = time.perf_counter() - t0
        dq = [p.rpc.status()["quanta"] - q for p, q in zip(fl.pools, q0)]
        return hs, res, wall, dq

    def pool_health(fl):
        """Each worker's healthz verdict and cause (reported, not gated:
        the watchdog's collapse rule reads chain-sweeps/s)."""
        return {p.label: {"ok": h["ok"], "cause": h.get("error"),
                          "watchdog": h.get("watchdog", {}).get("state")}
                for p, h in ((p, p.healthz()) for p in fl.pools)}

    set_chain_sweeps = sum(r.niter * r.nchains for r in tenant_set())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    try:
        # 20a. two workers, round robin: the set bitwise 15a's in-process
        # serial results, spread over both; the fleet's wire
        fa = fleet_of("a", placement="round_robin", http_port=0,
                      obs_dir=os.path.join(tmp20, "a_obs"),
                      capacity_sample_s=0.5)
        spawn_s = {p.label: p.spawn_s for p in fa.pools}
        hs, res, wall, dq = through(fa, fleet_set())
        bitwise_a = [bool(same_rows(a, b)) for a, b in zip(res, set_refs)]
        placements = dict(fa.placements)
        fport = fa.http.port
        code, body = http_get(fport, "/status")
        snap = json.loads(body)
        status_ok = (code == 200 and not obs_schema.validate(
            snap, schemas["fleet_status"], defs=schemas)
            and snap["n_reachable"] == 2)
        code, text = http_get(fport, "/metrics")
        lines = [ln for ln in text.splitlines() if ln]
        metrics_ok = (code == 200 and bool(lines) and all(
            ln.startswith(("# HELP ", "# TYPE ")) or prom_line.match(ln)
            for ln in lines) and 'gst_fleet_placements{pool="pool0"}' in text)
        code, body = http_get(fport, "/trace")
        doc = json.loads(body)
        cov = fleet_agg.trace_coverage(doc)
        traced = sum(1 for h in hs
                     if cov.get(h.request.trace_id, {}).get("router", 0) >= 1
                     and cov.get(h.request.trace_id, {}).get("pool", 0) >= 1)
        clocks = doc["otherData"]["clocks"]
        trace_ok = (code == 200 and not obs_schema.validate(
            doc, schemas["fleet_trace"], defs=schemas)
            and set(clocks) == {"pool0", "pool1"}
            and all(c["n"] >= 1 for c in clocks.values())
            and traced == len(hs))
        flrep["set"] = {
            "bitwise": bitwise_a, "placements": placements,
            "status_schema_valid": bool(status_ok),
            "metrics_ok": bool(metrics_ok), "trace_ok": bool(trace_ok),
            "jobs_traced_end_to_end": traced, "jobs": len(hs),
            "clocks": clocks, "spawn_to_ready_s": spawn_s,
            "coldstart": {p.label: p.ready["coldstart"] for p in fa.pools},
            "wall_s": wall, "quanta": dq}
        print(f"# fleet 20a the set through two workers: "
              f"{json.dumps(flrep['set'])}", flush=True)
        if not (all(bitwise_a) and status_ok and metrics_ok and trace_ok
                and set(placements) == {"pool0", "pool1"}):
            fail("the fleet's tenants differ from the in-process run, or its "
                 "placements, /status, /metrics or /trace are wrong")

        # 20e. throughput, in turns: the set through one worker (pinned to
        # pool 0), through both, both, one
        turns = []
        for pin in (0, None, None, 0):
            _, res_, wall_, dq_ = through(fa, fleet_set(), pin=pin)
            turns.append({
                "workers": 1 if pin == 0 else 2, "wall_s": wall_,
                "busy_chain_sweeps_per_s": set_chain_sweeps / wall_,
                "quanta": dq_,
                "ms_per_quantum": [1e3 * wall_ / q if q else None
                                   for q in dq_],
                "bitwise": all(same_rows(a, b)
                               for a, b in zip(res_, set_refs))})
        one = [t["busy_chain_sweeps_per_s"] for t in turns
               if t["workers"] == 1]
        two = [t["busy_chain_sweeps_per_s"] for t in turns
               if t["workers"] == 2]
        flrep["throughput"] = {"turns": turns,
                               "two_over_one": float(np.mean(two)
                                                     / np.mean(one))}
        flrep["health_a"] = pool_health(fa)
        if not all(t["bitwise"] for t in turns):
            fail("a tenant of the throughput turns differs from 15a's")

        # 20b. live migration: a running spooled 256-chain tenant moved to
        # the other worker once its source has counted two of its quanta,
        # with a caller blocked in result(); then a queued tenant, moved
        # by replay
        mi = int(np.argmax(budgets[:POOL_TENANTS]))
        mreq = fleet_set()[mi]
        mreq.spool_dir = os.path.join(tmp20, "spool_mig")
        src = fa.pools[0]
        q_start = src.rpc.healthz()["quanta"]
        rh = fa.submit(mreq, pool=0)
        got = {}
        waiter = threading.Thread(
            target=lambda: got.update(res=rh.result(timeout=WAIT_S)),
            daemon=True)
        waiter.start()
        t_end = time.monotonic() + WAIT_S
        while src.rpc.healthz()["quanta"] < q_start + 2:
            if time.monotonic() > t_end:
                fail("the tenant to migrate never ran")
            time.sleep(0.005)
        t_mig = time.perf_counter()
        moved = fa.migrate(rh, 1, timeout=WAIT_S)
        mig_s = time.perf_counter() - t_mig
        waiter.join(WAIT_S)
        frozen_at = rh._inner.request.start_sweep
        anchor = fa.submit(TenantRequest(
            ma=tenant_mas[0], niter=40 * Q, nchains=POOL_LANES, seed=950,
            name="anchor"), pool=0)
        qreq = fleet_set()[1]
        qh = fa.submit(qreq, pool=0)
        moved_q = fa.migrate(qh, 1, timeout=WAIT_S)
        res_q = qh.result(timeout=WAIT_S)
        anchor.cancel()
        anchor.result(timeout=WAIT_S)
        mig = {"moved": bool(moved), "seconds": mig_s,
               "frozen_at_sweep": frozen_at, "budget": mreq.niter,
               "rode_through": "res" in got,
               "bitwise": bool("res" in got
                               and same_rows(got["res"], set_refs[mi])),
               "queued_moved": bool(moved_q),
               "queued_bitwise": bool(same_rows(res_q, set_refs[1])),
               "migrations": fa.migrations}
        flrep["migration"] = mig
        print(f"# fleet 20b live migration: {json.dumps(mig)}", flush=True)
        if not (mig["moved"] and mig["rode_through"] and mig["bitwise"]
                and 0 < frozen_at < mreq.niter and mig["queued_moved"]
                and mig["queued_bitwise"] and fa.migrations == 2):
            fail("a migrated tenant is not bitwise its unmigrated run, or a "
                 "caller did not ride through the move")
        flrep["router_a"] = fa.fleet_status()["router"]
        teardown_fleet(fa)
        exits = [p.proc.returncode for p in fa.pools]
        if exits != [0, 0]:
            fail(f"a fleet worker did not retire cleanly: {exits}")

        # 20c. dead-pool failover: worker 1 dies at its third completed
        # quantum (pool_kill) under two spooled tenants and one in memory;
        # the router's watch respawns it with --recover
        fc = fleet_of("c", placement="round_robin", watch_poll_s=0.2,
                      faults_for={1: [{"point": "pool_kill", "after": 2,
                                       "action": "kill"}]})
        dying = fc.pools[1].proc
        died = {}

        def watch_death():
            while dying.poll() is None and not died.get("stop"):
                time.sleep(0.005)
            died["t"] = time.time()

        wt = threading.Thread(target=watch_death, daemon=True)
        wt.start()
        reqs = fleet_set()[:6]
        for i in (1, 5):            # round robin puts 1, 3, 5 on pool 1
            reqs[i].spool_dir = os.path.join(tmp20, f"spool_f{i}")
        hs = [fc.submit(r) for r in reqs]
        on1 = [h.pool_idx for h in hs]
        inner0 = {i: hs[i]._inner for i in (0, 2, 4)}
        res = [h.result(timeout=WAIT_S) for h in hs]
        died["stop"] = True
        wt.join(10.0)
        new1 = fc.pools[1]
        rpath = os.path.join(new1.spec.pool_dir, "ready.json")
        t_end = time.monotonic() + CHILD_TIMEOUT_S
        while True:
            with open(rpath) as fh:
                rdoc = json.load(fh)
            if "first_dispatch_t" in rdoc["coldstart"]:
                break
            if time.monotonic() > t_end:
                fail("the recovered worker never dispatched")
            time.sleep(0.05)
        fo = {"placed_on": on1, "exit_of_killed": dying.returncode,
              "failovers": fc.failovers, "resubmitted": fc.resubmitted,
              "recovered": sorted(new1.ready.get("recovered") or {}),
              "bitwise": [bool(same_rows(a, set_refs[i]))
                          for i, a in enumerate(res)],
              "others_untouched": all(hs[i]._inner is inner0[i]
                                      and hs[i].pool_idx == 0
                                      for i in (0, 2, 4)),
              "respawn_spawn_to_ready_s": new1.spawn_s,
              "kill_to_first_dispatch_s": (
                  rdoc["coldstart"]["first_dispatch_t"] - died["t"]
                  if "t" in died else None)}
        flrep["failover"] = fo
        print(f"# fleet 20c dead-pool failover: {json.dumps(fo)}",
              flush=True)
        if not (on1 == [0, 1, 0, 1, 0, 1] and fo["exit_of_killed"] == 9
                and fo["failovers"] == 1 and fo["resubmitted"] == 1
                and fo["recovered"] == ["f1", "f5"] and all(fo["bitwise"])
                and fo["others_untouched"]):
            fail("the failover did not recover the victims bitwise, or it "
                 "touched the other worker's tenants")

        flrep["health_c"] = pool_health(fc)
        flrep["router_c"] = fc.fleet_status()["router"]
        teardown_fleet(fc)

        # 20d. rebalancing (a fleet of its own: with both pools free, the
        # policy also moves a tenant queued for an instant): a long tenant
        # fills pool 0 and a queued one waits behind it; the drained pool 1
        # steals it (a replay), bitwise
        fd = fleet_of("d", placement="round_robin", failover=False,
                      rebalance=True, rebalance_poll_s=0.25)
        filler = fd.submit(TenantRequest(
            ma=tenant_mas[2], niter=40 * Q, nchains=POOL_LANES, seed=951,
            name="filler"), pool=0)
        sh = fd.submit(fleet_set()[6], pool=0)
        res_s = sh.result(timeout=WAIT_S)
        filler.cancel()
        filler.result(timeout=WAIT_S)
        reb = {"steals": fd.steals, "stolen_to": sh.pool_idx,
               "bitwise": bool(same_rows(res_s, set_refs[6])),
               "explain": [e["won"] for e in fd.explain(sh)]}
        flrep["rebalance"] = reb
        print(f"# fleet 20d rebalance: {json.dumps(reb)}", flush=True)
        if not (reb["steals"] == 1 and reb["stolen_to"] == 1
                and reb["bitwise"]):
            fail("the drained worker did not steal the queued tenant "
                 "bitwise")
        teardown_fleet(fd)
    finally:
        for fl in fleets:
            for p in fl.pools:
                if p.proc.poll() is None:
                    p.kill()
            fl.close(grace=5.0)
        shutil.rmtree(tmp20, ignore_errors=True)

    s_ = flrep["set"]
    spawned = ", ".join(f"{k} {v:.2f} s"
                        for k, v in s_["spawn_to_ready_s"].items())
    libs = ", ".join(f"{k} {v['library']}"
                     for k, v in s_["coldstart"].items())
    print(f"# fleet 20a pool1024 workers: spawn to ready.json {spawned}, "
          f"spawned together; libraries {libs}; placements "
          f"{s_['placements']}; {s_['jobs_traced_end_to_end']}"
          f"/{s_['jobs']} jobs traced end to end | {card}", flush=True)
    print(f"# fleet 20a/20c pool healthz after the runs: "
          f"{json.dumps(flrep['health_a'])} / "
          f"{json.dumps(flrep['health_c'])}", flush=True)
    print(f"# fleet 20b a running tenant moved in "
          f"{flrep['migration']['seconds']:.3f} s, frozen at sweep "
          f"{flrep['migration']['frozen_at_sweep']} | {card}", flush=True)
    fo = flrep["failover"]
    print(f"# fleet 20c the killed worker's recovery: spawn to ready.json "
          f"{fo['respawn_spawn_to_ready_s']:.2f} s, kill to the recovered "
          f"worker's first dispatch "
          + (f"{fo['kill_to_first_dispatch_s']:.2f} s"
             if fo["kill_to_first_dispatch_s"] is not None else "not seen")
          + f" | {card}", flush=True)
    for t in flrep["throughput"]["turns"]:
        print(f"# fleet 20e the set through {t['workers']} worker(s): "
              f"{t['busy_chain_sweeps_per_s']:.1f} busy chain-sweeps/s, "
              f"wall {t['wall_s']:.3f} s, quanta {t['quanta']}, ms a quantum "
              + " / ".join("-" if m is None else f"{m:.2f}"
                           for m in t["ms_per_quantum"])
              + f" | {card}", flush=True)
    print(f"# fleet 20e two workers over one: "
          f"{flrep['throughput']['two_over_one']:.3f}x | {card}", flush=True)
    flrep["seconds"] = time.perf_counter() - t20
    print(f"# phase 20: {flrep['seconds']:.1f} s", flush=True)



    # --- 21. the pool's last gaps: record tiers, heterogeneous pools --------
    from types import SimpleNamespace

    from gibbs_student_t_tpu_torch.parallel.ensemble import (
        _localize_names,
        pad_model_arrays,
    )

    t21 = time.perf_counter()
    trep = report["tiers_hetero"] = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def het_model(n, seed):
        """The serving bench's pulsar (pool_model's) at n TOAs."""
        psr, _ = make_contaminated_pulsar(n=n, components=30, theta=0.02,
                                          sigma_out=1e-5, seed=seed)
        return make_reference_pta(psr, 30).frozen(0)

    het_mas = {n: het_model(n, 700 + n) for n in HET_NS}

    # 21a. B3-L, B4-L and B5-L on masked operands: inputs captured from a
    # sweep of a heterogeneous pool1024 holding tenants of 130, 120 and
    # 100 TOAs (256 chains each), held as 11a holds them
    cap = ChainServer(template, cfg_p, nlanes=POOL_LANES, quantum=1,
                      record="full", device=dev, telemetry=False,
                      heterogeneous=True)
    for i, n in enumerate(HET_NS):
        cap.submit(TenantRequest(ma=het_mas[n], niter=2,
                                 nchains=POOL_CHAINS, seed=710 + i))
    cap.step()
    het_names = ["tnt_lanes", "white_mh_lanes", "hyper_mh_lanes"]
    captured_h = capture(het_names, cap.step)
    del cap
    if sorted({k[0] for k in captured_h}) != sorted(het_names):
        fail(f"the heterogeneous pool's sweep reached {sorted(captured_h)}")
    gpt = POOL_CHAINS // LANES_GROUP        # groups a tenant
    ((_, wargs),) = ((k, a) for k, a in captured_h.items()
                     if k[0] == "white_mh_lanes")
    ((_, targs),) = ((k, a) for k, a in captured_h.items()
                     if k[0] == "tnt_lanes")
    # the operands really are masked: each tenant's groups carry its row
    # mask in the white constants and zero suffix rows of T and y
    masked = {}
    for i, n in enumerate(HET_NS):
        g = slice(i * gpt, (i + 1) * gpt)
        mrow = wargs[5][g, 0, 1]
        masked[n] = bool((mrow[:, :n] == 1).all() and (mrow[:, n:] == 0).all()
                         and (targs[0][g, 0, n:] == 0).all()
                         and (targs[1][g, 0, n:] == 0).all())
    trep["masked_operands"] = masked
    if not all(masked.values()):
        fail(f"the heterogeneous pool's operands are not masked: {masked}")
    for name in ("white_mh_lanes", "hyper_mh_lanes"):
        ((shape, args),) = ((k[1], a) for k, a in captured_h.items()
                            if k[0] == name)
        gname = name.replace("lanes", "grouped")
        i_lu = 4 if name.startswith("white") else 6
        lu = grouped_sep(gname, lanes_grouped(name, args))
        grouped_parity(name, args, args[:i_lu] + (lu,) + args[i_lu + 1:])
        parity[name][-1]["masked"] = True
    T_l, y_l, nv_l = targs[:3]
    n_p = nv_l.shape[-1]
    Tg64, yg64, nv64 = (T_l[:, 0, :n_p].double(),
                        y_l[:, 0, None, :n_p].double(), nv_l.double())
    out_64 = tnt.tnt_products(Tg64, yg64, nv64)
    M, Md, _ = tnt.tnt_products(Tg64.abs(), yg64.abs(), nv64)
    Mc = 0.5 * (torch.log(nv64).abs().sum(-1) + (yg64 * yg64 / nv64).sum(-1))
    out_k = tnt.tnt_lanes(*targs)
    out_p = tnt.tnt_lanes_plain(*targs)

    def over_m64(out):
        return max(float(((a.double() - b) / s_).abs().max())
                   for a, b, s_ in zip(out, out_64, (M, Md, Mc)))

    rec = {"shape": list(nv_l.shape), "m": int(T_l.shape[-1]),
           "masked": True, "n_real": list(HET_NS),
           "max_abs_err": max(rel_err(a, b)[0] for a, b in zip(out_k, out_p)),
           "kernel_err_over_M": over_m64(out_k),
           "plain_err_over_M": over_m64(out_p),
           "symmetric": bool(torch.equal(out_k[0],
                                         out_k[0].transpose(-1, -2)))}
    # tolerance: 1e-4 of M on every output, as 11a holds B5-L
    rec["ok"] = (rec["kernel_err_over_M"] <= 1e-4
                 and rec["plain_err_over_M"] <= 1e-4 and rec["symmetric"])
    parity["tnt_lanes"].append(rec)
    print(f"# parity tnt_lanes {rec['shape']} masked: {json.dumps(rec)}",
          flush=True)
    if not rec["ok"]:
        fail("tnt_lanes disagrees with float64 on masked operands")

    # B3-L and B5-L timed on these masked operands (reported, not gated).
    # What the function must do depends on the data here: each group's
    # bound counts its real TOAs only (the ones of its row mask), the
    # kernel's bytes and operations over those rows summed over groups
    n_g = [int(v) for v in wargs[5][:, 0, 1].sum(-1).round()]
    G21 = len(n_g)

    def group_rows(name, a, g, n):
        """Group ``g``'s operands of a lanes launch cut to its ``n`` real
        TOAs (views: work() reads shapes only)."""
        gid_g = a[-2 if name.startswith("white") else -1].reshape(G21, -1)[g]
        if name == "tnt_lanes":
            return (a[0][g:g + 1, :, :n], a[1][g:g + 1, :, :n],
                    a[2][g:g + 1, :, :n], gid_g)
        return (a[0][g:g + 1], a[1][g:g + 1, :, :n], a[2][g:g + 1, :, :n],
                a[3][g:g + 1], a[4][g:g + 1], a[5][g:g + 1, ..., :n],
                a[6][g:g + 1], gid_g, a[8])

    masked_rows = trep["masked_timing"] = {}
    for name, a in (("white_mh_lanes", wargs), ("tnt_lanes", targs)):
        byts = flops = 0
        for g, n in enumerate(n_g):
            b_, f_ = work(name, group_rows(name, a, g, n))
            byts, flops = byts + b_, flops + f_
        lib = library(name, a)
        row = dict(
            path="pool hetero (masked)", shape=list(a[2 if name ==
                                                      "tnt_lanes" else 1]
                                                    .shape),
            n_real=sorted(set(n_g)), first_design_ms=None,
            ms=timed(wrappers[name][2], a, 50),
            plain_ms=timed(plains[name], a, 3, queue_ahead=False),
            library_ms=timed(lib[0], lib[1], 50) if lib else None,
            bound_ms=max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            bound_by="bytes" if byts / HBM_BYTES_PER_S
            >= flops / FP32_FLOPS else "operations",
            bytes=byts, flops=flops)
        masked_rows[name] = row
        other_forms.setdefault(name, []).append(row)
        print(f"# time {name} masked {row['shape']}: {json.dumps(row)} | "
              f"{card}", flush=True)
    del captured_h, wargs, targs, T_l, y_l, nv_l, out_64, M, Md, Mc
    del Tg64, yg64, nv64, out_k, out_p

    # 21b. a heterogeneous pool's sweep on the card against the same sweep
    # on the CPU: 96 lanes, tenants of 130, 120 and 100 TOAs (32 chains
    # each), ties separated, as 11b holds the homogeneous pool
    C2 = POOL_CPU_CHAINS

    def het_pool(device):
        return SlotPool(template, cfg_p, nlanes=len(HET_NS) * C2, quantum=1,
                        record="full", device=device, heterogeneous=True)

    pg, pc = het_pool(dev), het_pool("cpu")
    for i, n in enumerate(HET_NS):
        (ma_p,) = pad_model_arrays([_localize_names(het_mas[n])],
                                   n_to=pg.n_pool)
        be_g = tb.TorchGibbs(ma_p, cfg_p, nchains=C2, device=dev,
                             tnt_block_size=None)
        be_c = tb.TorchGibbs(ma_p, cfg_p, nchains=C2, device="cpu",
                             tnt_block_size=None)
        st_i = be_g.init_state(seed=720 + i)
        lanes = np.arange(i * C2, (i + 1) * C2)
        pg.write_tenant(TenantSlot(i, lanes, C2, 3, 0, 720 + i, n_real=n),
                        be_g, st_i)
        pc.write_tenant(TenantSlot(i, lanes, C2, 3, 0, 720 + i, n_real=n),
                        be_c, type(st_i)(*map(to_cpu, st_i)))
    for _ in range(2):
        pg.run_quantum()
    for pl in (pg, pc):
        pl._upload()
    st = pg.state
    dr = pg._lane_draws(st, pg._lane_sweep)
    dr = type(dr)(*(t.clone() for t in dr))
    st_c = type(st)(*map(to_cpu, st))
    sep = {}
    for name, field in (("white_mh_lanes", "logu_w"),
                        ("hyper_mh_lanes", "logu_h")):
        dr_c = type(dr)(*map(to_cpu, dr))
        (g,) = capture([name], lambda: pg.sampler._sweep(st, dr, 0)).values()
        (c,) = capture([name], lambda: pc.sampler._sweep(st_c, dr_c, 0)
                       ).values()
        gname = name.replace("lanes", "grouped")
        ga, ca = lanes_grouped(name, g), lanes_grouped(name, c)
        info = sep[name] = {}
        lu = grouped_sep(gname, ga, others=(
            grouped_ll(gname, ca, torch.float32),), info=info)
        info["moved"] = int((lu != getattr(dr, field)).sum())
        dr = dr._replace(**{field: lu})
    cmp = trep["sweep_card_vs_cpu"] = card_vs_cpu(pg.sampler, pc.sampler,
                                                  st, dr, 0)
    cmp["separation"] = sep
    # the padded rows stay pinned on the card: z 0 and alpha 1 there
    pins = all(bool((lanes_flat(pg.state.z)[i * C2:(i + 1) * C2, n:] == 0)
                    .all() and (lanes_flat(pg.state.alpha)[
                        i * C2:(i + 1) * C2, n:] == 1).all())
               for i, n in enumerate(HET_NS))
    cmp["padded_rows_pinned"] = pins
    print(f"# heterogeneous pool sweep card-vs-cpu ({len(HET_NS) * C2} "
          f"lanes, n = {list(HET_NS)}): {json.dumps(cmp)}", flush=True)
    # tolerance as 11b: every chain's accept counts equal on draws clear
    # of every float32 tie, x to 1e-4 relative (b reported)
    if cmp["chains_acc_mismatch"] > 0 or cmp["x"][1] > 1e-4 or not pins:
        fail("a heterogeneous pool's sweep on the card disagrees with the "
             "CPU, or its padded rows moved")
    del pg, pc, st, st_c, dr

    # 21c. a compact8 tenant against the solo compact8 sampler on the
    # card: a 256-chain tenant beside another in a 512-lane pool, two
    # quanta, under "compact8" and under "full", and the solo sampler
    # (quantum-sized chunks) under both
    tier_fields = ("x", "b", "z", "theta", "alpha", "df", "pout",
                   "acc_white", "acc_hyper")
    res_of = dict(x="chain", b="bchain", z="zchain", theta="thetachain",
                  alpha="alphachain", df="dfchain", pout="poutchain")

    def rows_of(res, f):
        return res.stats[f] if f.startswith("acc_") else getattr(res,
                                                                 res_of[f])

    c8 = tb.TorchGibbs(tenant_mas[0], cfg_p, nchains=POOL_CHAINS,
                       device=dev, record="compact8")

    def as_tier(res):
        """A full-record result's rows through the compact8 casts on the
        card and back (record_tuple, then _materialize), as TorchGibbs
        turns a chunk around."""
        ns = SimpleNamespace(**{f: torch.from_numpy(np.ascontiguousarray(
            rows_of(res, f))).to(dev) for f in tier_fields})
        wire = tb.record_tuple(ns, c8._record_fields, c8._record_casts)
        return dict(zip(c8._record_fields,
                        c8._materialize([w.cpu() for w in wire])))

    def solo_tier(record):
        smp = tb.TorchGibbs(tenant_mas[0], cfg_p, nchains=POOL_CHAINS,
                            device=dev, chunk_size=POOL_QUANTUM,
                            tnt_block_size=None, record=record)
        return smp.sample(niter=2 * POOL_QUANTUM, seed=730)

    solo_c = {r: solo_tier(r) for r in ("full", "compact8")}
    served0 = list(served)
    reset_counts()

    def pair_run(record):
        s = ChainServer(template, cfg_p, nlanes=2 * POOL_CHAINS,
                        quantum=POOL_QUANTUM, record=record, device=dev)
        hs = [s.submit(TenantRequest(ma=tenant_mas[i],
                                     niter=2 * POOL_QUANTUM,
                                     nchains=POOL_CHAINS, seed=730 + i))
              for i in range(2)]
        drive(s)
        return hs[0].result(timeout=WAIT_S)

    pool_c = {r: pair_run(r) for r in ("full", "compact8")}
    cast_p, cast_s = as_tier(pool_c["full"]), as_tier(solo_c["full"])
    cc = trep["compact8_tenant"] = {
        "chains": POOL_CHAINS, "sweeps": 2 * POOL_QUANTUM,
        "pool_is_cast_of_full": {f: bool(eq(rows_of(pool_c["compact8"], f),
                                            cast_p[f]))
                                 for f in tier_fields},
        "solo_is_cast_of_full": {f: bool(eq(rows_of(solo_c["compact8"], f),
                                            cast_s[f]))
                                 for f in tier_fields}}
    agree, extra = {}, {}
    for f in tier_fields:
        m_full = rows_of(pool_c["full"], f) != rows_of(solo_c["full"], f)
        m_c8 = (rows_of(pool_c["compact8"], f)
                != rows_of(solo_c["compact8"], f))
        agree[f] = {"full": float(1.0 - m_full.mean()),
                    "compact8": float(1.0 - m_c8.mean())}
        extra[f] = int((m_c8 & ~m_full).sum())
    cc["pool_vs_solo_equal_share"] = agree
    cc["compact8_mismatch_where_full_agrees"] = extra
    print(f"# compact8 tenant vs the solo compact8 sampler: "
          f"{json.dumps(cc)}", flush=True)
    # tolerance: the pool's compact8 records are the compact8 casts of its
    # full records, bit for bit, as the solo sampler's are of its own; and
    # the compact8 tenant equals the solo compact8 sampler bit for bit
    # wherever its full records equal the solo full sampler's (on the
    # card the pool's B5-L and the solo's product sum in other orders,
    # so b, alpha and pout are not bitwise there under "full" either)
    if not (all(cc["pool_is_cast_of_full"].values())
            and all(cc["solo_is_cast_of_full"].values())
            and not any(extra.values())):
        fail("the pool's compact8 records are not the solo sampler's tier")
    del solo_c, pool_c, cast_p, cast_s

    # 21d. the tenant set with full records under "full" and "compact8",
    # in turns (full, compact8, compact8, full), pipelined: the bytes the
    # drain pulls a quantum and its host ms a quantum; every compact8
    # tenant the compact8 casts of the same tenant's full records
    tiers21 = {"full": [], "compact8": []}
    first21 = {}
    for record in ("full", "compact8", "compact8", "full"):
        s = ChainServer(template, cfg_p, nlanes=POOL_LANES,
                        quantum=POOL_QUANTUM, record=record, device=dev)
        hs = [s.submit(r) for r in tenant_set()]
        wall = drive(s)
        res = [h.result(timeout=WAIT_S) for h in hs]
        if record not in first21:
            first21[record] = res
        elif not all(same_rows(a, b) for a, b in zip(first21[record], res)):
            fail(f"two record={record!r} runs of the tenant set differ")
        summ = s.summary()
        tiers21[record].append({
            "quanta": s.quanta, "wall_s": wall,
            "ms_per_quantum": 1e3 * wall / s.quanta,
            "wire_bytes_per_quantum": s.pool.wire_bytes,
            "drain_host_ms_per_quantum": summ["host_ms"]["drain"]["mean"],
            "dispatch_host_ms_per_quantum":
                summ["host_ms"]["dispatch"]["mean"]})
        del s, hs, res
    counts21 = check_launches("pool_tiers", served[0] - served0[0],
                              served[1] - served0[1])
    cast_ok = all(
        all(eq(rows_of(c, f), as_tier(fr)[f]) for f in tier_fields)
        for c, fr in zip(first21["compact8"], first21["full"]))
    shapes_ok = all(finite_shaped(r, c_, n_) for r, (c_, n_) in zip(
        first21["compact8"], pool_rep["tenants"]))
    trep["tenant_set"] = {"turns": tiers21, "compact8_is_cast_of_full":
                          bool(cast_ok), "finite_shaped": bool(shapes_ok),
                          "launches": counts21}
    # the pull alone: one quantum's wire records of each tier copied to
    # pinned host memory on a side stream (CUDA events), an idle pool's
    pull_ms = {}
    for record in ("full", "compact8"):
        pl = SlotPool(template, cfg_p, nlanes=POOL_LANES,
                      quantum=POOL_QUANTUM, record=record, device=dev,
                      telemetry=False)
        recs, _, _ = pl.dispatch_quantum()
        side = torch.cuda.Stream(dev)
        ts = list(recs.values())
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        reps = 10
        with torch.cuda.stream(side):
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in ts]
            e0.record(side)
            for _ in range(reps):
                for b_, t in zip(bufs, ts):
                    b_.copy_(t, non_blocking=True)
            e1.record(side)
        e1.synchronize()
        pull_ms[record] = e0.elapsed_time(e1) / reps
        del pl, recs, ts, bufs
    trep["pull_ms_per_quantum"] = pull_ms
    for record in ("full", "compact8"):
        t_ = tiers21[record]
        print(f"# tiers 21d pool1024 {record}: "
              f"{t_[0]['wire_bytes_per_quantum'] / 1e6:.3f} MB pulled a "
              f"quantum ({pull_ms[record]:.4f} ms to pinned host), drain "
              f"host " + " / ".join(f"{r['drain_host_ms_per_quantum']:.3f}"
                                    for r in t_)
              + " ms a quantum, " + " / ".join(
                  f"{r['ms_per_quantum']:.2f}" for r in t_)
              + f" ms a quantum | {card}", flush=True)
    gist = {k: v for k, v in trep["tenant_set"].items() if k != "turns"}
    print(f"# tiers 21d tenant set: {json.dumps(gist)}", flush=True)
    if not (cast_ok and shapes_ok):
        fail("the compact8 tenant set is not the compact8 casts of the "
             "full one, or not finite and shaped")
    trep["seconds"] = time.perf_counter() - t21
    print(f"# phase 21: {trep['seconds']:.1f} s", flush=True)


    # --- 22. the profiling plane: stage timers, the server's stages, the run's
    # introspection -------------------------------------------------------
    from gibbs_student_t_tpu_torch.obs import introspect
    from gibbs_student_t_tpu_torch.obs.ledger import read_ledger
    from gibbs_student_t_tpu_torch.ops import timers

    t22 = time.perf_counter()
    prep = report["profiling"] = {"card": card}
    tmp22 = tempfile.mkdtemp(prefix="gst_chip_smoke_prof_")
    STAGES = timers.STAGE_NAMES
    S22 = PROF_SWEEPS
    print(f"# profiling plane | {card}", flush=True)
    # the hand-written kernels' entry functions, by the build's ptxas report
    kernel_fns = sorted({k["function"]
                         for k in introspect.build_record()["kernels"]})
    if not kernel_fns:
        fail("the build record lists no kernel entry function")

    def ours(name):
        """Whether a profiler device event is a hand-written kernel's."""
        return any(f in name for f in kernel_fns)

    def stage_delta(s0):
        """{stage: {"ms", "calls"}} since snapshot ``s0``, every bracket
        done (the card synchronized first)."""
        torch.cuda.synchronize()
        return timers.timers_delta_ms(s0, timers.timers_snapshot())

    def fresh_snapshot():
        torch.cuda.synchronize()
        return timers.timers_snapshot()

    try:
        # 22a. the flagship, timers off then on, from phase 5's state
        def flag_run(on):
            timers.timers_enable(on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = sampler.sample(niter=S22, seed=9, state=flagship_state,
                               start_sweep=ADAPT + MORE)
            torch.cuda.synchronize()
            return r, (time.perf_counter() - t0) * 1e3 / S22

        reset_counts()
        r_off, _ = flag_run(False)
        check_launches("timers_off", S22, chunks_of(sampler, S22))
        s0 = fresh_snapshot()
        reset_counts()
        r_on, _ = flag_run(True)
        check_launches("timers_on", S22, chunks_of(sampler, S22))
        d_on = stage_delta(s0)
        if not same(r_off, r_on):
            fail("the flagship's records differ with the stage timers on")
        if set(d_on) != set(STAGES) or any(
                v["calls"] != S22 for v in d_on.values()):
            fail(f"the flagship's stages did not all report once a sweep: "
                 f"{d_on}")
        prof_ev = {}
        for on in (False, True):
            prof_ev[on] = profile_counts(torch, lambda on=on: flag_run(on))
        mine = {on: {k: v for k, v in ev.items() if ours(k)}
                for on, ev in prof_ev.items()}
        counted = sum(launches_by_path["timers_on"].values())
        if (not mine[False] or mine[False] != mine[True]
                or sum(mine[True].values()) != counted):
            fail(f"the hand-written kernels' profiled launches differ with "
                 f"the stage timers on, or from the wrappers' {counted}: "
                 f"{mine}")
        others = {k: (prof_ev[False].get(k, 0), prof_ev[True].get(k, 0))
                  for k in set(prof_ev[False]) | set(prof_ev[True])
                  if prof_ev[False].get(k, 0) != prof_ev[True].get(k, 0)}
        turns = {False: [], True: []}
        for on in (False, True, True, False, False, True):
            turns[on].append(flag_run(on)[1])
        host = {("on" if k else "off"): v for k, v in turns.items()}
        med = {k: float(np.median(v)) for k, v in host.items()}
        # the sweep alone, the way a chunk issues it (no records, no pull),
        # in turns; then one bracket's host cost, empty
        keys9 = sampler._chain_keys(9)
        sw9 = torch.arange(ADAPT + MORE, ADAPT + MORE + S22, device=dev)

        def sweep_loop(on):
            timers.timers_enable(on)
            st_ = flagship_state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(S22):
                st_ = sampler._sweep(st_, sampler._draw(keys9, sw9[i], st_),
                                     sweep=ADAPT + MORE + i)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / S22

        loop = {False: [], True: []}
        for on in (False, True, True, False, False, True, True, False,
                   False, True):
            loop[on].append(sweep_loop(on))
        # a sweep's brackets, empty: draws alone, then the chain from
        # white_mh to resid, as _draw and _sweep open them
        x1 = torch.zeros(1, device=dev)
        chain = ("white_mh", "tnt", "schur", "hyper_mh", "bdraw_factor",
                 "solves", "resid")
        def empty_brackets():
            with timers.stage("draws", x1.device):
                pass
            b = None
            for name in chain:
                with timers.stage(name, x1.device, follows=b) as b:
                    pass

        bracket_us = {False: [], True: []}
        for on in (False, True, True, False):
            timers.timers_enable(on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BRACKET_SWEEPS):
                empty_brackets()
            torch.cuda.synchronize()
            bracket_us[on].append((time.perf_counter() - t0) * 1e6
                                  / BRACKET_SWEEPS)
        # their cost to the stream: issued behind a hold, between two
        # outer events
        stream_us = []
        for _ in range(2):
            timers.timers_enable(True)
            torch.cuda.synchronize()
            torch.cuda._sleep(HOLD_CYCLES)
            o0 = torch.cuda.Event(enable_timing=True)
            o1 = torch.cuda.Event(enable_timing=True)
            o0.record()
            for _ in range(BRACKET_STREAM_SWEEPS):
                empty_brackets()
            o1.record()
            o1.synchronize()
            stream_us.append(o0.elapsed_time(o1) * 1e3
                             / BRACKET_STREAM_SWEEPS)
        timers.timers_enable(False)
        fresh_snapshot()
        loop_med = {on: float(np.median(v)) for on, v in loop.items()}
        prep["flagship"] = {
            "bitwise": True,
            "stage_ms_per_sweep": {k: d_on[k]["ms"] / S22 for k in STAGES},
            "kernel_launches_per_sweep": sum(mine[True].values()) / S22,
            "device_events_per_sweep": {
                "off": sum(prof_ev[False].values()) / S22,
                "on": sum(prof_ev[True].values()) / S22},
            "other_device_events_differing": others,
            "host_ms_per_sweep_in_turns": host,
            "host_cost_share": med["on"] / med["off"] - 1.0,
            "sweep_loop_ms_in_turns": {"off": loop[False], "on": loop[True]},
            "sweep_loop_cost_share": loop_med[True] / loop_med[False] - 1.0,
            "brackets_host_us_per_sweep": {"off": bracket_us[False],
                                           "on": bracket_us[True]},
            "brackets_stream_us_per_sweep": stream_us}
        print(f"# profiling 22a flagship ({NCHAINS} chains, {S22} sweeps "
              f"from phase 5's state): records bitwise on/off, launches "
              f"equal ({prep['flagship']['kernel_launches_per_sweep']:.1f} "
              f"hand-written a sweep by the profiler); stage ms a sweep "
              + ", ".join(f"{k} {d_on[k]['ms'] / S22:.4f}" for k in STAGES)
              + f" | {card}", flush=True)
        print(f"# profiling 22a host ms a sweep in turns, off "
              + " / ".join(f"{v:.4f}" for v in host["off"]) + ", on "
              + " / ".join(f"{v:.4f}" for v in host["on"])
              + f"; medians {med['off']:.4f} / {med['on']:.4f} "
              f"({100 * prep['flagship']['host_cost_share']:+.2f} %); other "
              f"device events that differ: {others} | {card}", flush=True)
        print(f"# profiling 22a the sweep alone, ms a sweep in turns, off "
              + " / ".join(f"{v:.4f}" for v in loop[False]) + ", on "
              + " / ".join(f"{v:.4f}" for v in loop[True])
              + f"; medians {loop_med[False]:.4f} / {loop_med[True]:.4f} "
              f"({100 * prep['flagship']['sweep_loop_cost_share']:+.2f} %); "
              f"a sweep's 8 brackets, empty, host us off "
              + " / ".join(f"{v:.2f}" for v in bracket_us[False]) + ", on "
              + " / ".join(f"{v:.2f}" for v in bracket_us[True])
              + ", their stream us "
              + " / ".join(f"{v:.2f}" for v in stream_us)
              + f" | {card}", flush=True)

        # 22b. ens32: the stages' event ms against the profiler's device
        # time of the kernels each bracket launched
        # (after its adaptation, as phase 10c's timed window)
        ens = EnsembleGibbs(ens_pulsars(ENS_PULSARS), cfg_e,
                            nchains=ENS_CHAINS, device=dev, record="light")
        ens.sample(niter=ADAPT, seed=3)
        st_e = ens.last_state
        keys_e = ens._chain_keys(3)
        sw_e = torch.arange(ADAPT, ADAPT + S22, device=dev)

        def ens_loop(hold=False):
            # hold: the stream sleeps before each sweep, longer than the
            # host takes to issue the sweep, so the whole sweep is queued
            # when the stream reaches it and no bracket waits for the host
            st_ = st_e
            for i in range(S22):
                if hold:
                    torch.cuda._sleep(HOLD_CYCLES)
                st_ = ens._sweep(st_, ens._draw(keys_e, sw_e[i], st_),
                                 sweep=ADAPT + i)
            torch.cuda.synchronize()

        timers.timers_enable(True)
        ev_e = {}
        for hold in (False, True):
            s0 = fresh_snapshot()
            t0 = time.perf_counter()
            ens_loop(hold)
            if not hold:
                ens_wall = (time.perf_counter() - t0) * 1e3 / S22
            ev_e[hold] = {k: v["ms"] / S22
                          for k, v in stage_delta(s0).items()}
        snap = []
        pk = profile_stages(torch, lambda: ens_loop(True), tmp22,
                            warmup=lambda: x1.add_(1),
                            between=lambda: snap.append(fresh_snapshot()))
        ev_p = {k: v["ms"] / S22 for k, v in stage_delta(snap[0]).items()}
        timers.timers_enable(False)
        kern = {k: v / S22 for k, v in pk["ms"].items()}
        rows = {k: {"event_ms": ev_e[False].get(k),
                    "event_ms_held": ev_e[True].get(k),
                    "event_ms_profiled": ev_p.get(k),
                    "kernel_ms": kern.get(k),
                    "launches": pk["launches"].get(k, 0) / S22}
                for k in STAGES}
        prep["ens32"] = {"wall_ms_per_sweep": ens_wall, "stages": rows,
                         "unattributed_kernel_ms":
                             pk["unattributed_ms"] / S22,
                         "annotations": pk["annotations"]}
        for k in STAGES:
            r = rows[k]
            print(f"# profiling 22b ens32 {k}: event "
                  f"{r['event_ms'] or 0.0:.4f} ms a sweep, with the host "
                  f"held ahead {r['event_ms_held'] or 0.0:.4f} (profiled "
                  f"{r['event_ms_profiled'] or 0.0:.4f}), its kernels "
                  f"{r['kernel_ms'] or 0.0:.4f} ms ({r['launches']:.1f} "
                  f"launches)", flush=True)
        print(f"# profiling 22b ens32: wall {ens_wall:.4f} ms a sweep (the "
              f"sweep alone), {pk['unattributed_ms'] / S22:.4f} ms of device "
              f"time outside the stages (the hold's sleep kernel among it) "
              f"| {card}", flush=True)
        # the gate reads the events and the kernels of one run: the
        # profiled one, held
        for k in ("hyper_mh", "bdraw_factor"):
            r = rows[k]
            if not r["kernel_ms"] or not r["event_ms_profiled"] or not (
                    -0.02 <= r["event_ms_profiled"] / r["kernel_ms"] - 1.0
                    <= 0.15):
                fail(f"ens32's {k} stage reads {r['event_ms_profiled']} ms "
                     f"a sweep with the host held ahead, against "
                     f"{r['kernel_ms']} ms of its kernels in the same run "
                     f"(-2 % / +15 %)")
        del ens, st_e

        # 22c. pool1024 under ChainServer: phase 11d's tenant set with the
        # timers off and on in turns (off, on, on, off), the first on run
        # read over HTTP; then a profile of 4 quanta
        reset_counts()
        pq = [0, 0]      # pool sweeps and quanta of the phase's servers

        def set_run(on, http=False):
            # off: the default, which leaves the timers down
            s = pool_server(False, http_port=0 if http else None,
                            **({"kernel_timers": True} if on else {}))
            hs = [s.submit(r) for r in tenant_set()]
            live = {}

            def on_q(srv):
                if http and "status" not in live and srv.quanta >= 2:
                    live["status"] = http_get(srv.http.port, "/status")

            wall = drive(s, on_quantum=on_q)
            pq[0] += s.quanta * POOL_QUANTUM
            pq[1] += s.quanta
            return {"server": s, "handles": hs, "wall": wall, "live": live,
                    "results": [h.result(timeout=WAIT_S) for h in hs],
                    "rate": s.busy_chain_sweeps / wall}

        runs22 = []
        for i, on in enumerate((False, True, True, False, False, True)):
            runs22.append((on, set_run(on, http=(i == 1))))
        ref = runs22[0][1]["results"]
        if not all(same_rows(a, b) for _, r in runs22
                   for a, b in zip(r["results"], ref)):
            fail("a pool1024 tenant's records differ with the stage timers "
                 "on")
        on1 = runs22[1][1]
        srv_on = on1["server"]
        summ, stat = srv_on.summary(), srv_on.status()
        bad22 = []
        for label, block in (("summary", summ["stages"]),
                             ("status", stat["stages"])):
            errs = obs_schema.validate(json.loads(json.dumps(block)),
                                       schemas["stage_timings"],
                                       defs=schemas)
            if errs or set(block or ()) != set(STAGES):
                bad22.append((label, errs[:3], sorted(block or ())))
        share = sum(v["share_of_dispatch"] for v in summ["stages"].values())
        per_tenant = {}
        for h in on1["handles"]:
            for k, v in h.cost().get("stage_device_ms", {}).items():
                per_tenant[k] = per_tenant.get(k, 0.0) + v
        recon = all(abs(per_tenant.get(k, 0.0) - v["device_ms"])
                    <= 0.02 * v["device_ms"] + 0.01
                    for k, v in summ["stages"].items())
        pm = srv_on.flight.bundle("phase 22")
        flight_ok = (pm["kernel_timers"] is True
                     and set(pm["stage_totals_ms"] or ()) == set(STAGES)
                     and bool(pm["quanta"]) and all(
                         q["stage_device_ms"] for q in pm["quanta"]))
        code, body = on1["live"].get("status", (None, "{}"))
        http_st = json.loads(body)
        http_ok = (code == 200 and set(http_st.get("stages") or ())
                   == set(STAGES) and not obs_schema.validate(
                       http_st, schemas["serve_status"], defs=schemas))
        off_blank = all(r["server"].summary()["stages"] is None
                        and r["server"].kernel_timers is False
                        for on, r in runs22 if not on)
        # every closed server gave its hold on the flag back
        held = timers._holds
        rates = {("on" if on else "off"): [] for on in (True, False)}
        for on, r in runs22:
            rates["on" if on else "off"].append(r["rate"])
        # 4 quanta of 4 tenants under the profiler, serial: each stage's
        # event ms beside the device ms of the kernels it launched
        s = pool_server(False, kernel_timers=True)
        for i in range(4):
            s.submit(TenantRequest(ma=tenant_mas[i],
                                   niter=POOL_PROFILE_QUANTA * POOL_QUANTUM,
                                   nchains=POOL_CHAINS, seed=220 + i))
        pk = profile_stages(torch, lambda: drive(s), tmp22,
                            warmup=lambda: x1.add_(1))
        pq[0] += s.quanta * POOL_QUANTUM
        pq[1] += s.quanta
        check_launches("pool_prof", pq[0], pq[1])
        timers.timers_enable(False)
        ps = s.summary()
        nq = max(s.quanta, 1)
        prow = {k: {"event_ms_per_quantum_profiled":
                        ps["stages"][k]["device_ms"] / nq,
                    "kernel_ms_per_quantum": pk["ms"].get(k, 0.0) / nq,
                    "event_ms_per_quantum": summ["stages"][k][
                        "ms_per_quantum"],
                    "share_of_dispatch": summ["stages"][k][
                        "share_of_dispatch"]}
                for k in STAGES}
        prep["pool1024"] = {
            "stages": prow, "share_of_dispatch_sum": share,
            "reconciled": recon, "flight": flight_ok, "http_status": http_ok,
            "schema_problems": bad22,
            "busy_chain_sweeps_per_s_in_turns": rates,
            "dispatch_ms_per_quantum_profiled":
                ps["cost"]["dispatch_wall_ms"] / nq,
            "unattributed_kernel_ms_per_quantum": pk["unattributed_ms"] / nq}
        for k in STAGES:
            r = prow[k]
            print(f"# profiling 22c pool1024 {k}: event "
                  f"{r['event_ms_per_quantum']:.3f} ms a quantum "
                  f"({100 * (r['share_of_dispatch'] or 0.0):.1f} % of the "
                  f"dispatch wall; profiled "
                  f"{r['event_ms_per_quantum_profiled']:.3f}), its kernels "
                  f"{r['kernel_ms_per_quantum']:.3f} ms", flush=True)
        print(f"# profiling 22c pool1024: shares sum {share:.4f}, tenants "
              f"reconcile {recon}, flight {flight_ok}, /status {http_ok}; "
              f"busy chain-sweeps/s off "
              + " / ".join(f"{v:.0f}" for v in rates["off"]) + ", on "
              + " / ".join(f"{v:.0f}" for v in rates["on"])
              + f" | {card}", flush=True)
        if bad22 or not (0.0 < share <= 1.0) or not recon or not flight_ok \
                or not http_ok or not off_blank or held or timers._holds:
            fail(f"pool1024's stages: schema {bad22}, share sum {share}, "
                 f"reconciled {recon}, flight {flight_ok}, /status "
                 f"{http_ok}, default servers blank {off_blank}, holds on "
                 f"the flag after close {held} / {timers._holds}")
        del runs22, on1, srv_on, s

        # 22d. run_sims --introspect on the card, in a process of its own
        led = os.path.join(tmp22, "ledger.jsonl")
        cmd = [sys.executable, "-m",
               "gibbs_student_t_tpu_torch.drivers.run_sims", "--introspect",
               "--device", "cuda", "--models", "beta", "--nchains",
               str(NCHAINS), "--niter", str(S22), "--burn", "10",
               "--thetas", "0.1", "--seed", "5",
               "--simdir", os.path.join(tmp22, "sim"), "--outdirs",
               os.path.join(tmp22, "o1"), os.path.join(tmp22, "o2"),
               "--ledger", led]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                              text=True, timeout=CHILD_TIMEOUT_S)
        lines = [ln for ln in proc.stderr.splitlines()
                 if ln.startswith("  # ")]
        for ln in lines:
            print(f"# profiling 22d {ln.strip()}")
        if proc.returncode != 0:
            fail(f"run_sims --introspect exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        named = {}
        for ln in lines:
            if ln.startswith("  # kernel "):
                named[ln.split()[2]] = ln
        want = {"chol_fused", "tri_solve_T", "white_mh", "hyper_mh",
                "sweep_draws"}
        build_ln = [ln for ln in lines if ln.startswith(
            "  # build libgst_cuda.so: ")]
        (rec,) = read_ledger(led)
        errs = obs_schema.validate(rec, schemas["ledger_record"],
                                   defs=schemas)
        cuda = rec.get("cuda") or {}
        forms_ok = []
        for k in cuda.get("kernels", []):
            name, shape = k["kernel"], k["shape"]
            if name == "chol_fused":
                form, per = chol.launch_form(*shape)
                want_k = chol.form_meta(shape[1],
                                        per if form == "warp" else 0)
            elif name == "hyper_mh":
                form, per = hyper_mh.launch_form(shape[0], shape[1])
                want_k = {"form": form,
                          "per_block": per if form == "warp" else 0}
            elif name == "white_mh":
                want_k = white_mh.white_form(shape[1], shape[2])._asdict()
            else:
                continue
            forms_ok.append(all(k.get(f) == v for f, v in want_k.items()))
        intro = {"rc": proc.returncode, "lines": len(lines),
                 "kernels": sorted(named), "build_line": bool(build_ln),
                 "schema_problems": errs[:5],
                 "peak_bytes": cuda.get("peak_bytes"),
                 "programs": [p["label"] for p in cuda.get("programs", [])],
                 "forms_checked": len(forms_ok),
                 "forms_match": all(forms_ok) and bool(forms_ok),
                 "entry_functions": len(cuda.get("build", {}).get(
                     "kernels", [])),
                 "last_build": cuda.get("build", {}).get("last_build")}
        prep["introspect"] = intro
        print(f"# profiling 22d: {json.dumps(intro)} | {card}", flush=True)
        if (set(named) != want or not build_ln
                or not all("impl=cuda" in ln and "plain" not in ln
                           for ln in named.values())
                or errs or not isinstance(intro["peak_bytes"], int)
                or intro["peak_bytes"] <= 0 or not intro["forms_match"]
                or not intro["entry_functions"]):
            fail(f"run_sims --introspect: {json.dumps(intro)}")
    finally:
        timers.timers_enable(False)
        shutil.rmtree(tmp22, ignore_errors=True)
    prep["seconds"] = time.perf_counter() - t22
    print(f"# phase 22: {prep['seconds']:.1f} s", flush=True)

    # --- 23. the ensemble over a mesh -------------------------------------
    t23 = time.perf_counter()
    from gibbs_student_t_tpu_torch.parallel import gelman_rubin, make_mesh

    mrep = report["mesh"] = {"card": card}
    cfg_mesh = GibbsConfig(model="mixture", vary_df=True,
                           theta_prior="beta").with_adapt(
        MESH_ADAPT, adapt_cov=True)
    mesh_mas = ens_pulsars(ENS_PULSARS)
    GATED = ("chain", "bchain", "thetachain", "dfchain")
    HELD = GATED + ("zchain",)

    def mesh_run(path, mesh, device=None):
        """ens32 over ``mesh`` (or on ``device``) for MESH_SWEEPS sweeps
        in full records: the result, the last state, the covariance
        factors each adapting chunk starts from, the wall and the launch
        counts (``path``; a block's sweep counts as a sweep)."""
        e = EnsembleGibbs(mesh_mas, cfg_mesh, nchains=ENS_CHAINS,
                          chunk_size=MESH_CHUNK, record="full", mesh=mesh,
                          device=device)
        covs = []
        inner = e._pre_chunk

        def pre_chunk(states):
            out = inner(states)
            covs.append(e._join(out).mh_cov_chol.clone())
            return out

        e._pre_chunk = pre_chunk
        nblocks = 1 if mesh is None else len(e._blocks)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = e.sample(MESH_SWEEPS, seed=MESH_SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = check_launches(path, nblocks * MESH_SWEEPS,
                                nblocks * -(-MESH_SWEEPS // MESH_CHUNK))
        return r, e.last_state, covs, wall, counts

    def after(r, last, f, k):
        """Field ``f`` after ``k`` sweeps: row k, or the last state."""
        if k < MESH_SWEEPS:
            return getattr(r, f)[k]
        return getattr(last, {"chain": "x", "bchain": "b",
                              "thetachain": "theta",
                              "dfchain": "df"}[f]).cpu().numpy()

    def sweep_diffs(r, last, ref, ref_last):
        """Per sweep 1..MESH_SWEEPS: the largest absolute and relative
        difference of x, b, theta and df, and whether all four are bit for
        bit equal."""
        rows = []
        for k in range(1, MESH_SWEEPS + 1):
            a = [after(r, last, f, k) for f in GATED]
            b = [after(ref, ref_last, f, k) for f in GATED]
            rows.append({
                "sweep": k,
                "max_abs": max(float(np.abs(x - y).max())
                               for x, y in zip(a, b)),
                "max_rel": max(float((np.abs(x - y)
                                      / (np.abs(y) + MESH_ATOL)).max())
                               for x, y in zip(a, b)),
                "bitwise": all(np.array_equal(x, y) for x, y in zip(a, b))})
        return rows

    def gated(a_rows, b_rows):
        """Two results' rows within rtol MESH_RTOL / atol MESH_ATOL: x,
        theta and df after each sweep up to MESH_GATE_SWEEP, z bit for bit
        there, and b after MESH_B_SWEEP sweeps. Also the chains whose b
        after MESH_GATE_SWEEP sweeps is more than MESH_RTOL of its largest
        |b| away (reported)."""
        ok = all(np.allclose(a_rows[f][k], b_rows[f][k], rtol=MESH_RTOL,
                             atol=MESH_ATOL)
                 for f in ("chain", "thetachain", "dfchain")
                 for k in range(1, MESH_GATE_SWEEP + 1))
        ok &= all(np.array_equal(a_rows["zchain"][k], b_rows["zchain"][k])
                  for k in range(1, MESH_GATE_SWEEP + 1))
        ok &= np.allclose(a_rows["bchain"][MESH_B_SWEEP],
                          b_rows["bchain"][MESH_B_SWEEP], rtol=MESH_RTOL,
                          atol=MESH_ATOL)
        k = MESH_GATE_SWEEP
        db = np.abs(a_rows["bchain"][k] - b_rows["bchain"][k]).max(-1)
        b_apart = int((db > MESH_RTOL
                       * np.abs(b_rows["bchain"][k]).max(-1)).sum())
        return bool(ok), b_apart

    # 23a/b. a 1 x 1 mesh (first: it also warms the full records' pinned
    # buffers), mesh=None and a 2 x 2 mesh on the card
    r_11, s_11, _, w_11, _ = mesh_run(
        "mesh_1x1", make_mesh({"pulsar": 1, "chain": 1}, [dev]))
    r_none, s_none, cov_none, w_none, c_none = mesh_run(
        "mesh_none", None, device=dev)
    same_11 = (all(np.array_equal(getattr(r_none, f), getattr(r_11, f))
                   for f in ("chain", "bchain", "zchain", "thetachain",
                             "alphachain", "poutchain", "dfchain"))
               and all(np.array_equal(np.asarray(r_none.stats[k]),
                                      np.asarray(r_11.stats[k]))
                       for k in r_none.stats)
               and r_none.stats.keys() == r_11.stats.keys()
               and all(torch.equal(a, b) for a, b in zip(s_none, s_11)))
    mrep["a_one_by_one_bitwise"] = same_11
    print(f"# mesh 23a: 1 x 1 mesh on cuda:0 bit for bit mesh=None: "
          f"{same_11} (mesh=None {w_none:.3f} s, 1 x 1 {w_11:.3f} s for "
          f"{MESH_SWEEPS} sweeps) | {card}", flush=True)
    if not same_11:
        fail("the 1 x 1 mesh run differs from the mesh=None run")
    del r_11, s_11
    mesh22 = make_mesh({"pulsar": 2, "chain": 2}, [dev] * 4)
    r_22, s_22, cov_22, w_22, c_22 = mesh_run("mesh_2x2", mesh22)
    diffs = sweep_diffs(r_22, s_22, r_none, s_none)
    rows_none = {f: getattr(r_none, f) for f in HELD}
    gate_ok, b_apart = gated({f: getattr(r_22, f) for f in HELD},
                             rows_none)
    finite_22 = all(np.isfinite(getattr(r_22, f)).all() for f in GATED)
    # the covariance factor the second adapting chunk starts from (after
    # the first chunk), by pulsar; held where x was bit for bit equal
    # through that chunk
    x_same = np.array([np.array_equal(r_22.chain[:MESH_CHUNK + 1, p],
                                      r_none.chain[:MESH_CHUNK + 1, p])
                       for p in range(ENS_PULSARS)])
    cov_a, cov_b = cov_22[1].cpu(), cov_none[1].cpu()
    cov_close = [bool(torch.allclose(cov_a[p], cov_b[p], rtol=MESH_RTOL,
                                     atol=MESH_ATOL))
                 for p in range(ENS_PULSARS)]
    cov_bits = [bool(torch.equal(cov_a[p], cov_b[p]))
                for p in range(ENS_PULSARS)]
    cov_ok = all(c for c, same in zip(cov_close, x_same) if same)
    mrep["b_two_by_two"] = {
        "mesh": mesh22.shape, "blocks_on": str(dev),
        "gate_after_sweeps": MESH_GATE_SWEEP, "gate_ok": gate_ok,
        "chains_b_apart_at_gate_sweep": b_apart,
        "finite": finite_22, "per_sweep": diffs,
        "pulsars_x_bitwise_first_chunk": int(x_same.sum()),
        "cov_close_where_x_bitwise": cov_ok,
        "cov_bitwise_pulsars": int(sum(cov_bits)),
        "cov_bitwise_where_x_bitwise": int(sum(
            b for b, same in zip(cov_bits, x_same) if same)),
        "wall_s": {"mesh_none": w_none, "mesh_2x2": w_22},
        "ms_per_sweep": {"mesh_none": 1e3 * w_none / MESH_SWEEPS,
                         "mesh_2x2": 1e3 * w_22 / MESH_SWEEPS},
        "launches_per_sweep": {
            "mesh_none": sum(c_none.values()) / MESH_SWEEPS,
            "mesh_2x2": sum(c_22.values()) / MESH_SWEEPS}}
    for d in diffs:
        print(f"# mesh 23b sweep {d['sweep']}: max |dx,db,dtheta,ddf| "
              f"{d['max_abs']:.3e} (rel {d['max_rel']:.3e}), bitwise "
              f"{d['bitwise']}")
    b23 = mrep["b_two_by_two"]
    print(f"# mesh 23b: 2 x 2 mesh on [cuda:0] x 4 against mesh=None: gate "
          f"{gate_ok} (x, z, theta, df through sweep {MESH_GATE_SWEEP}, "
          f"b after {MESH_B_SWEEP}; b of {b_apart} of "
          f"{ENS_PULSARS * ENS_CHAINS} chains more than {MESH_RTOL} of its "
          f"scale apart after {MESH_GATE_SWEEP}); x bitwise through "
          f"the first chunk on {b23['pulsars_x_bitwise_first_chunk']}/"
          f"{ENS_PULSARS} pulsars, covariance factor there close "
          f"{cov_ok}, bitwise on {b23['cov_bitwise_where_x_bitwise']}; "
          f"{b23['ms_per_sweep']['mesh_none']:.3f} ms/sweep unsharded, "
          f"{b23['ms_per_sweep']['mesh_2x2']:.3f} ms/sweep 2 x 2; "
          f"launches a sweep {b23['launches_per_sweep']['mesh_none']:.1f} "
          f"/ {b23['launches_per_sweep']['mesh_2x2']:.1f} | {card}",
          flush=True)
    if not (gate_ok and finite_22 and cov_ok):
        fail(f"the 2 x 2 mesh run disagrees with mesh=None: "
             f"{json.dumps({k: v for k, v in b23.items() if k != 'per_sweep'})}")
    rows_22 = {f: getattr(r_22, f) for f in HELD}
    del r_22, s_22, cov_22

    # 23c-e. processes on the card: two gloo ranks under each DCN axis,
    # a one-rank NCCL group, and run_sims --ensemble, all at once
    tmp23 = tempfile.mkdtemp(prefix="gst_chip_smoke_mesh_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)

    def free_port():
        import socket

        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    children = {}
    try:
        for dcn in ("pulsar", "chain"):
            port = free_port()
            for rank in range(2):
                cfg_c = {"mode": "mesh", "port": port, "nproc": 2,
                         "rank": rank, "backend": "gloo", "dcn": dcn,
                         "pulsars": ENS_PULSARS, "chains": ENS_CHAINS,
                         "adapt": MESH_ADAPT, "sweeps": MESH_SWEEPS,
                         "chunk": MESH_CHUNK, "seed": MESH_SEED,
                         "gate_sweep": MESH_GATE_SWEEP,
                         "out": os.path.join(tmp23, f"{dcn}{rank}.npz")}
                children[(dcn, rank)] = subprocess.Popen(
                    [sys.executable, "-c", CHILD23, HERE, json.dumps(cfg_c)],
                    cwd=HERE, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
        children[("nccl", 0)] = subprocess.Popen(
            [sys.executable, "-c", CHILD23, HERE, json.dumps(
                {"mode": "nccl", "port": free_port(), "nproc": 1, "rank": 0,
                 "backend": "nccl"})],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        children[("run_sims", 0)] = subprocess.Popen(
            [sys.executable, "-m", "gibbs_student_t_tpu_torch.drivers.run_sims",
             "--ensemble", "4", "--device", "cuda", "--models", "beta",
             "--nchains", "64", "--niter", "10", "--burn", "2", "--thetas",
             "0.1", "--seed", "5", "--simdir", os.path.join(tmp23, "sim"),
             "--outdirs", os.path.join(tmp23, "o1"),
             os.path.join(tmp23, "o2")],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        outs = {}
        for key, proc in children.items():
            out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
            if proc.returncode != 0:
                fail(f"phase 23 child {key} exited {proc.returncode}: "
                     f"{err[-3000:]}")
            outs[key] = (out, err)
        # 23c. each rank's rows against its slice of 23b's unsharded run,
        # and R-hat over the two ranks against the host's
        crep = mrep["c_processes"] = {}
        for dcn in ("pulsar", "chain"):
            got = [json.loads(outs[(dcn, r)][0].strip().splitlines()[-1])
                   for r in range(2)]
            rows = [dict(np.load(os.path.join(tmp23, f"{dcn}{r}.npz")))
                    for r in range(2)]
            ok_rows, b_apart_c, same_22 = [], [], []
            seen = np.zeros((ENS_PULSARS, ENS_CHAINS), int)
            worst = 0.0
            for r in rows:
                ps = slice(int(r["pulsar_start"]), int(r["pulsar_stop"]))
                cs = slice(int(r["chain_start"]), int(r["chain_stop"]))
                seen[ps, cs] += 1
                mine = {f: r[f] for f in HELD}
                ref = {f: rows_none[f][:MESH_GATE_SWEEP + 1, ps, cs]
                       for f in HELD}
                ok_r, apart_r = gated(mine, ref)
                ok_rows.append(ok_r)
                b_apart_c.append(apart_r)
                # the same blocks as 23b's 2 x 2 mesh, in two processes
                same_22.append(all(np.array_equal(
                    mine[f], rows_22[f][:len(mine[f]), ps, cs])
                    for f in HELD))
                worst = max(worst, max(float(np.abs(
                    mine[f][MESH_GATE_SWEEP] - ref[f][MESH_GATE_SWEEP]).max())
                    for f in GATED))
            pooled = np.concatenate([r["chain"][:, 0, :, 0] for r in rows],
                                    axis=1)
            want = gelman_rubin(pooled)
            rh_ok = all(abs(g["rhat"] - want) <= 1e-5 * abs(want)
                        for g in got)
            crep[dcn] = {"rows_gate_ok": ok_rows,
                         "chains_b_apart_at_gate_sweep": b_apart_c,
                         "bitwise_the_2x2_mesh": same_22, "tiled_once":
                         bool((seen == 1).all()), "max_abs_diff_at_gate":
                         worst, "rhat": [g["rhat"] for g in got],
                         "gelman_rubin": want, "rhat_ok": rh_ok,
                         "backend": [g["backend"] for g in got],
                         "blocks": [g["blocks"] for g in got],
                         "child_s": [g["seconds"] for g in got],
                         "sample_s": [g["sample_s"] for g in got]}
            print(f"# mesh 23c dcn {{'{dcn}': 2}}: {json.dumps(crep[dcn])}",
                  flush=True)
            if not (all(ok_rows) and crep[dcn]["tiled_once"] and rh_ok
                    and all(g["backend"] == "gloo" for g in got)):
                fail(f"phase 23c under dcn {dcn}: "
                     f"{json.dumps(crep[dcn])}")
        # 23d. a one-rank NCCL group: R-hat of CUDA tensors
        nd = json.loads(outs[("nccl", 0)][0].strip().splitlines()[-1])
        mrep["d_nccl"] = nd
        nccl_ok = (nd["initialized"] and nd["backend"] == "nccl"
                   and abs(nd["rhat"] - nd["gelman_rubin"])
                   <= 1e-5 * abs(nd["gelman_rubin"]))
        print(f"# mesh 23d: {json.dumps(nd)} ok {nccl_ok}", flush=True)
        if not nccl_ok:
            fail(f"phase 23d: rhat_collective over NCCL: {json.dumps(nd)}")
        # 23e. run_sims --ensemble on the card: its 1 x 1 mesh
        err_e = outs[("run_sims", 0)][1]
        line = [ln for ln in err_e.splitlines()
                if ln.startswith("# ensemble:")]
        trees = [ln for ln in outs[("run_sims", 0)][0].splitlines()
                 if ln.strip()]
        mrep["e_run_sims"] = {"line": line, "trees": len(trees)}
        print(f"# mesh 23e: {line} {len(trees)} trees", flush=True)
        if (len(line) != 1 or "mesh {'pulsar': 1, 'chain': 1}" not in line[0]
                or len(trees) != 4):
            fail(f"phase 23e: run_sims --ensemble printed {line}, "
                 f"{len(trees)} trees")
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp23, ignore_errors=True)
    del r_none, s_none, cov_none, rows_none, rows_22
    mrep["seconds"] = time.perf_counter() - t23
    print(f"# phase 23: {mrep['seconds']:.1f} s | {card}", flush=True)

    # --- 24. the north-star posterior gate on the card ---------------------
    t24 = time.perf_counter()
    from gibbs_student_t_tpu_torch.drivers import posterior_gate as pgate
    from gibbs_student_t_tpu_torch.drivers.run_sims import model_configs

    grep = report["gate"] = {"card": card}
    gate_cfgs = {k: pgate.gate_config(c) for k, c in model_configs().items()}
    beta = gate_cfgs["beta"]
    ma_g = make_demo_model_arrays()
    gate_mas = ens_pulsars(GATE_ENS_PULSARS)
    niter_np, burn_np, thin_np = GATE_NP
    niter_j, burn_j, thin_j = GATE_J
    # each oracle's (model arrays, config): arm a's five models (uniform on
    # the ensemble's pulsar GATE_UNIFORM_PULSAR), and mixture/beta on the
    # ensemble's gated pulsars (arm d)
    gate_models = {k: (gate_mas[GATE_UNIFORM_PULSAR] if k == "uniform"
                       else ma_g, c) for k, c in gate_cfgs.items()}
    gate_models.update({f"ens{p}": (gate_mas[p], beta)
                        for p in range(GATE_ENS_GATED)})
    # 24o. the oracles first, one process each, the flagship's first; a
    # host with too few cores for one round shortens the other runs,
    # never the flagship's
    workers = max(1, min(GATE_POOL, (os.cpu_count() or 2) - 1))
    rounds = -(-len(gate_models) // workers)
    niter_other = (niter_np if rounds == 1
                   else max(GATE_NP_MIN, niter_np // rounds))
    tasks = {k: (*gate_models[k], niter_np if k == "beta" else niter_other,
                 burn_np, thin_np, GATE_SEED)
             for k in ["beta"] + [k for k in gate_models if k != "beta"]}
    grep["lengths"] = {
        "oracle_workers": workers, "cores": os.cpu_count(),
        "oracle": {k: [t[2], burn_np, thin_np] for k, t in tasks.items()},
        "kernel": [niter_j, burn_j, thin_j], "record_thin": GATE_THIN,
        "chains": NCHAINS, "ensemble": [GATE_ENS_PULSARS, GATE_ENS_CHAINS],
        "uniform_pulsar": GATE_UNIFORM_PULSAR}
    print(f"# gate: {workers} oracle processes on {os.cpu_count()} cores; "
          f"oracle sweeps/burn/thin {niter_np}/{burn_np}/{thin_np} "
          f"(beta), {niter_other} (the other six runs); kernel "
          f"{niter_j}/{burn_j}/{thin_j} at {NCHAINS} chains, arm d "
          f"{GATE_ENS_PULSARS} pulsars x {GATE_ENS_CHAINS}; uniform on the "
          f"ensemble's pulsar {GATE_UNIFORM_PULSAR}", flush=True)
    ex24, futs24 = pgate.start_oracles(tasks, workers)
    # every wrapper decides kernel or plain version through use_kernel:
    # while the arms run, a plain decision is counted (none may happen)
    plain_calls = {}
    real_use_kernel = _cuda.use_kernel

    def counted_use_kernel(t, what):
        on = real_use_kernel(t, what)
        if not on:
            plain_calls[what] = plain_calls.get(what, 0) + 1
        return on

    def gate_arm(path, runs, sweeps, chunks):
        """Run ``runs`` (each a callable returning a result) on the card:
        ``(results, wall s, launches by kernel)``, the launches checked as
        ``sweeps`` sweeps and ``chunks`` chunks of ``path``."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [run() for run in runs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, check_launches(path, sweeps, chunks)

    def solo_run(ma_k, c):
        smp = tb.TorchGibbs(ma_k, c, nchains=NCHAINS, device=dev,
                            chunk_size=GATE_CHUNK, record="compact",
                            record_thin=GATE_THIN)
        return lambda: smp.sample(niter=niter_j, seed=GATE_SEED + 1)

    chunks_j = -(-niter_j // GATE_CHUNK)
    arms = {}
    try:
        _cuda.use_kernel = counted_use_kernel
        # 24a. the five models at their defaults
        res, wall, counts = gate_arm(
            "gate_a", [solo_run(*gate_models[k]) for k in gate_cfgs],
            len(gate_cfgs) * niter_j, len(gate_cfgs) * chunks_j)
        arms["a"] = dict(results=dict(zip(gate_cfgs, res)), wall=wall,
                         counts=counts, sweeps=len(gate_cfgs) * niter_j)
        # 24b. the flagship as the bench runs it: covariance adaptation
        res, wall, counts = gate_arm(
            "gate_b", [solo_run(ma_g, beta.with_adapt(GATE_B_ADAPT,
                                                      adapt_cov=True))],
            niter_j, chunks_j)
        arms["b"] = dict(results={"beta": res[0]}, wall=wall,
                         counts=counts, sweeps=niter_j)
        # 24c. full MTM: B6 and the MTM hyper path
        res, wall, counts = gate_arm(
            "gate_c", [solo_run(ma_g, beta.with_mtm(
                MTM_TRIES, blocks=("white", "hyper")))],
            niter_j, chunks_j)
        arms["c"] = dict(results={"beta": res[0]}, wall=wall,
                         counts=counts, sweeps=niter_j)
        # 24d. the heterogeneous ensemble: the grouped kernels
        ens_g = EnsembleGibbs(gate_mas, beta, nchains=GATE_ENS_CHAINS,
                              device=dev, chunk_size=GATE_CHUNK,
                              record="compact", record_thin=GATE_THIN)
        res, wall, counts = gate_arm(
            "gate_d", [lambda: ens_g.sample(niter_j, seed=GATE_SEED + 1)],
            niter_j, chunks_j)
        arms["d"] = dict(results={f"ens{p}": res[0].select_pulsar(p)
                                  for p in range(GATE_ENS_GATED)},
                         wall=wall, counts=counts, sweeps=niter_j)
        del ens_g, res
        if plain_calls:
            fail(f"phase 24: plain versions ran on the card: {plain_calls}")
        # the oracles, as they finish
        t_wait = time.perf_counter()
        oracles = {}
        for k, f in futs24.items():
            left = GATE_WAIT_S - (time.perf_counter() - t_wait)
            try:
                oracles[k] = f.result(timeout=max(1.0, left))
            except Exception as exc:  # noqa: BLE001
                fail(f"phase 24: oracle {k} did not finish: {exc!r}")
        grep["oracle_wait_s"] = time.perf_counter() - t_wait
    finally:
        _cuda.use_kernel = real_use_kernel
        pgate.stop_oracles(ex24)
    grep["oracle_s"] = {k: o[1] for k, o in oracles.items()}
    for k, (_, secs) in oracles.items():
        print(f"# gate oracle {k}: {tasks[k][2]} sweeps in {secs:.1f} s "
              f"({tasks[k][2] / secs:.1f} sweeps/s, one of {workers} "
              f"processes)", flush=True)

    # 24g. the gate, arm by arm: every chain pooled, each quantity held to
    # a gap of at most 0.33 posterior sd and a KS p of at least 0.001
    sub = np.random.default_rng(0)
    failed = []
    grep["arms"] = {}
    for arm, a in arms.items():
        rows_arm = {}
        for k, r in a["results"].items():
            ma_k, cfg_k = gate_models[k]
            kept = pgate.keep_rows(r, burn_j, thin_j)
            rows = pgate.gate_rows(oracles[k][0], kept, cfg_k,
                                   ma_k.param_names, sub=sub)
            for row in rows:
                print(pgate.format_row(f"# gate {arm} {k}", row))
                if not row["ok"]:
                    failed.append((arm, k, row["quantity"]))
            rows_arm[k] = {"rows": rows, "oracle_s": oracles[k][1],
                           "diverged_chains": pgate.diverged_chains(r)}
        per_sweep = {n: c / a["sweeps"] for n, c in a["counts"].items()
                     if c}
        grep["arms"][arm] = {"models": rows_arm, "wall_s": a["wall"],
                             "sweeps": a["sweeps"],
                             "launches_per_sweep": per_sweep}
        print(f"# gate arm {arm}: {a['wall']:.1f} s for {a['sweeps']} "
              f"sweeps, launches a sweep "
              f"{json.dumps({n: round(v, 3) for n, v in per_sweep.items()})}"
              f", diverged chains "
              f"{ {k: m['diverged_chains'] for k, m in rows_arm.items()} }"
              f" | {card}", flush=True)
    del arms
    if failed:
        fail(f"phase 24: the posterior gate failed on the card: {failed}")

    # 24n. the north star, with nothing else running: the flagship's
    # chain-sweeps/s on the card (past its adaptation) over the oracle's
    # sweeps/s on the host (one process, one BLAS thread)
    smp_ns = tb.TorchGibbs(ma_g, beta.with_adapt(GATE_B_ADAPT,
                                                 adapt_cov=True),
                           nchains=NCHAINS, device=dev, chunk_size=GATE_CHUNK)
    reset_counts()
    smp_ns.sample(niter=GATE_B_ADAPT, seed=GATE_SEED + 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smp_ns.sample(niter=NS_KERNEL_SWEEPS, seed=GATE_SEED + 2,
                  state=smp_ns.last_state, start_sweep=GATE_B_ADAPT)
    torch.cuda.synchronize()
    ns_wall = time.perf_counter() - t0
    check_launches("gate_ns", GATE_B_ADAPT + NS_KERNEL_SWEEPS,
                   chunks_of(smp_ns, GATE_B_ADAPT, NS_KERNEL_SWEEPS))
    del smp_ns
    ex_ns, fut_ns = pgate.start_oracles(
        {"ns": (ma_g, beta, NS_ORACLE_SWEEPS, 0, 1, GATE_SEED)}, 1)
    try:
        ns_oracle_s = fut_ns["ns"].result(timeout=GATE_WAIT_S)[1]
    except Exception as exc:  # noqa: BLE001
        fail(f"phase 24: the north-star oracle did not finish: {exc!r}")
    finally:
        pgate.stop_oracles(ex_ns)
    card_rate = NCHAINS * NS_KERNEL_SWEEPS / ns_wall
    oracle_rate = NS_ORACLE_SWEEPS / ns_oracle_s
    grep["north_star"] = {
        "card_chain_sweeps_per_s": card_rate, "card_wall_s": ns_wall,
        "oracle_sweeps_per_s": oracle_rate, "oracle_s": ns_oracle_s,
        "ratio": card_rate / oracle_rate}
    print(f"# north star: the flagship ({NCHAINS} chains, adapted) "
          f"{card_rate:.0f} chain-sweeps/s on the card, the oracle "
          f"{oracle_rate:.1f} sweeps/s on the host: "
          f"{card_rate / oracle_rate:.0f}x | {card}", flush=True)
    # phase 24's runs as one path of the kernels line
    launches_by_path["gate"] = {
        n: sum(launches_by_path[p][n] for p in GATE_PATHS)
        for n in wrappers}
    for p in GATE_PATHS:
        del launches_by_path[p]
    grep["seconds"] = time.perf_counter() - t24
    print(f"# phase 24: {grep['seconds']:.1f} s | {card}", flush=True)

    # --- 25. the pool's constructor surface: thinning, the admission arms,
    # groups (pool1024) ---------------------------------------------------
    t25 = time.perf_counter()
    urep = report["constructor"] = {"card": card}
    tmp25 = tempfile.mkdtemp(prefix="gst_chip_smoke_ctor_")
    print(f"# constructor surface | {card}", flush=True)

    def thinned_of(a, b, t):
        """Result ``a``'s rows bitwise result ``b``'s rows ``[::t]``."""
        return all(eq(getattr(a, f), np.asarray(getattr(b, f))[::t])
                   for f in chains) and all(
            eq(a.stats[k], np.asarray(b.stats[k])[::t])
            for k in ("acc_white", "acc_hyper"))

    # 25a. the tenant set (compact8, pipelined) at full rate and at
    # record_thin=5, in turns (1, 5, 5, 1): each tenant's thinned rows its
    # full-rate rows [::5] bit for bit, launches a sweep equal; each run's
    # wire MB, drain host ms and ms a quantum
    thin_turns = {1: [], THIN25: []}
    first25 = {}
    reset_counts()
    served0 = list(served)
    for thin in (1, THIN25, THIN25, 1):
        s = ChainServer(template, cfg_p, nlanes=POOL_LANES,
                        quantum=POOL_QUANTUM, device=dev, record_thin=thin)
        c0 = {n: count(n) for n in wrappers}
        sw0 = served[0]
        hs = [s.submit(r) for r in tenant_set()]
        wall = drive(s)
        res = [h.result(timeout=WAIT_S) for h in hs]
        sweeps = served[0] - sw0
        if thin not in first25:
            first25[thin] = res
        elif not all(same_rows(a, b) for a, b in zip(first25[thin], res)):
            fail(f"two record_thin={thin} runs of the tenant set differ")
        summ = s.summary()
        thin_turns[thin].append({
            "quanta": s.quanta, "sweeps": sweeps, "wall_s": wall,
            "ms_per_quantum": 1e3 * wall / s.quanta,
            "wire_bytes_per_quantum": s.pool.wire_bytes,
            "drain_host_ms_per_quantum": summ["host_ms"]["drain"]["mean"],
            "launches_per_sweep": {n: (count(n) - c0[n]) / sweeps
                                   for n in wrappers if count(n) - c0[n]}})
        del s, hs, res
    counts25 = check_launches("pool_thin", served[0] - served0[0],
                              served[1] - served0[1])
    thin_ok = all(
        thinned_of(a, b, THIN25)
        and int(a.stats["record_thin"]) == THIN25
        and "record_thin" not in b.stats
        for a, b in zip(first25[THIN25], first25[1]))
    lps = [r["launches_per_sweep"] for t in (1, THIN25)
           for r in thin_turns[t]]
    lps_ok = all(d == lps[0] for d in lps)
    urep["thinning"] = {"turns": thin_turns, "rows_bitwise": bool(thin_ok),
                        "launches_per_sweep_equal": bool(lps_ok),
                        "launches": counts25}
    for t in (1, THIN25):
        t_ = thin_turns[t]
        print(f"# constructor 25a pool1024 compact8 record_thin={t}: "
              f"{t_[0]['wire_bytes_per_quantum'] / 1e6:.3f} MB a quantum, "
              "drain host " + " / ".join(
                  f"{r['drain_host_ms_per_quantum']:.3f}" for r in t_)
              + " ms a quantum, " + " / ".join(
                  f"{r['ms_per_quantum']:.2f}" for r in t_)
              + f" ms a quantum | {card}", flush=True)
    print(f"# constructor 25a: thinned rows bitwise the full-rate rows "
          f"[::{THIN25}] {thin_ok}, launches a sweep equal {lps_ok}: "
          f"{json.dumps({n: round(v, 4) for n, v in lps[0].items()})}"
          f" | {card}", flush=True)
    if not (thin_ok and lps_ok):
        fail("phase 25a: a thinned tenant is not its full-rate rows "
             f"[::{THIN25}], or thinning changed the launches a sweep")
    del first25

    # 25b. the admission arms: GST_SERVE_SCATTER 1 against 0 in turns
    # (1, 0, 0, 1), each a fresh pipelined server, on the JAX package's
    # tests/test_serve.py schedule at 1024 lanes: two tenants of 512 chains
    # admitted at the first boundary, a lane_nan fault re-drawn on one and
    # quarantined on the other, and a spooled third admitted mid-flight
    half = POOL_LANES // 2

    def admission_run(flag, k):
        with env_set("GST_SERVE_SCATTER", flag):
            s = ChainServer(template, cfg_p, nlanes=POOL_LANES,
                            quantum=POOL_QUANTUM, device=dev)
        if s.pool.scatter is not (flag == "1"):
            fail(f"GST_SERVE_SCATTER={flag} resolved to scatter="
                 f"{s.pool.scatter}")
        with faults.inject(
                faults.FaultSpec("lane_nan", tenant="R", after=1),
                faults.FaultSpec("lane_nan", tenant="Q", after=1)):
            hs = [s.submit(TenantRequest(
                      ma=tenant_mas[0], niter=3 * Q, nchains=half, seed=801,
                      name="R", on_divergence="reinit")),
                  s.submit(TenantRequest(
                      ma=tenant_mas[1], niter=4 * Q, nchains=half, seed=802,
                      name="Q", on_divergence="quarantine")),
                  s.submit(TenantRequest(
                      ma=tenant_mas[2], niter=2 * Q, nchains=half, seed=803,
                      name="L", spool_dir=os.path.join(tmp25, f"L{k}")))]
            wall = drive(s)
        res = [h.result(timeout=WAIT_S) for h in hs]
        summ = s.summary()
        return {"results": res, "wall_s": wall,
                "health": [hs[0].health["n_reinits"],
                           hs[1].health["n_quarantined"]],
                "admission": summ["admission"], "backend": summ["backend"]}

    arms25 = {"1": [], "0": []}
    for k, flag in enumerate(("1", "0", "0", "1")):
        arms25[flag].append(admission_run(flag, k))
    ref25 = arms25["1"][0]["results"]
    arms_bitwise = all(
        all(same_rows(a, b) for a, b in zip(run["results"], ref25))
        for flag in arms25 for run in arms25[flag])
    faults_ok = all(run["health"][0] >= 1 and run["health"][1] >= 1
                    for flag in arms25 for run in arms25[flag])
    adm = {flag: [run["admission"] for run in arms25[flag]]
           for flag in arms25}
    bytes_ok = (all(a["admits"] == 3 for f_ in adm for a in adm[f_])
                and max(a["bytes_total"] for a in adm["1"])
                < min(a["bytes_total"] for a in adm["0"]))
    urep["admission"] = {
        "arms": {flag: [{k: v for k, v in run.items() if k != "results"}
                        for run in arms25[flag]] for flag in arms25},
        "bitwise": bool(arms_bitwise), "faults_applied": bool(faults_ok),
        "scatter_moves_less": bool(bytes_ok)}
    for flag in ("1", "0"):
        for run in arms25[flag]:
            a = run["admission"]
            ap = a["apply_ms"]
            print(f"# constructor 25b GST_SERVE_SCATTER={flag}: "
                  f"{a['admits']} admits, {a['bytes_per_admit'] / 1e6:.4f}"
                  f" MB an admission ({a['bytes_total'] / 1e6:.4f} MB), "
                  f"admission apply ms p50 {ap['p50']:.3f} p90 "
                  f"{ap['p90']:.3f} p99 {ap['p99']:.3f} max "
                  f"{ap['max']:.3f}, run {run['wall_s']:.2f} s, backend "
                  f"{json.dumps(run['backend'])} | {card}", flush=True)
    print(f"# constructor 25b: arms bitwise {arms_bitwise}, faults applied "
          f"{faults_ok}, the scatter moves less {bytes_ok} | {card}",
          flush=True)
    if not (arms_bitwise and faults_ok and bytes_ok):
        fail("phase 25b: the admission arms differ, a fault was not "
             "applied, or the scatter did not move fewer bytes")
    del arms25, ref25

    # 25c. a tenant of 20 chains in a group=32 pool (32 lanes) beside a
    # 256-chain neighbour, and the same two in a group=16 pool (the same
    # lanes): bitwise. Against TorchGibbs.sample the start row is held bit
    # for bit; the later rows are reported (the pool's lanes kernels and
    # the solo sampler's are other kernels, phase 11c)
    def group_run(group):
        s = ChainServer(template, cfg_p, nlanes=POOL_LANES,
                        quantum=POOL_QUANTUM, device=dev, record="full",
                        group=group)
        seen = []

        def grab(srv_):
            if not seen and srv_.quanta:
                seen.append({t["name"]: (t["lane0"], t["lane_groups"])
                             for t in srv_.status()["tenants"]})
        hs = [s.submit(TenantRequest(ma=tenant_mas[3], niter=2 * Q,
                                     nchains=20, seed=811, name="g")),
              s.submit(TenantRequest(ma=tenant_mas[4], niter=2 * Q,
                                     nchains=POOL_CHAINS, seed=812,
                                     name="n"))]
        drive(s, on_quantum=grab)
        return [h.result(timeout=WAIT_S) for h in hs], seen[0]

    (g32, n32), lanes32 = group_run(32)
    (g16, n16), lanes16 = group_run(16)
    solo_g = tb.TorchGibbs(tenant_mas[3], cfg_p, nchains=20, device=dev,
                           chunk_size=Q, tnt_block_size=None, record="full")
    rs_g = solo_g.sample(niter=2 * Q, seed=811)
    groups_ok = (same_rows(g32, g16) and same_rows(n32, n16)
                 and lanes32 == {"g": (0, 1), "n": (32, POOL_CHAINS // 32)}
                 and lanes16 == {"g": (0, 2),
                                 "n": (32, POOL_CHAINS // 16)})
    start_ok = all(eq(getattr(g32, f)[0], getattr(rs_g, f)[0])
                   for f in chains)
    urep["groups"] = {
        "lanes": {"group32": lanes32, "group16": lanes16},
        "bitwise_group16": bool(groups_ok), "start_row_bitwise_solo":
            bool(start_ok),
        "solo_rows_bitwise": {f: int(sum(eq(a, b) for a, b in zip(
            getattr(g32, f), getattr(rs_g, f)))) for f in chains},
        "solo_x_max_rel_err": rel_err(torch.as_tensor(g32.chain),
                                      torch.as_tensor(rs_g.chain))[:2]}
    print(f"# constructor 25c group=32: {json.dumps(urep['groups'])} | "
          f"{card}", flush=True)
    if not (groups_ok and start_ok):
        fail("phase 25c: a group=32 tenant differs from the same tenant of "
             "a group=16 pool, or its start from the solo sampler's")
    del g32, n32, g16, n16, solo_g, rs_g
    shutil.rmtree(tmp25, ignore_errors=True)
    urep["seconds"] = time.perf_counter() - t25
    print(f"# phase 25: {urep['seconds']:.1f} s | {card}", flush=True)

    # --- 26. dtype=float64 on the card (the flagship, ens32) ---------------
    t26 = time.perf_counter()
    f64 = torch.float64
    frep = report["float64"] = {"card": card}
    cfg64 = GibbsConfig(model="mixture", vary_df=True,
                        theta_prior="beta").with_adapt(F64_ADAPT,
                                                       adapt_cov=True)

    # 26e. the refusal rule: on CUDA a float64 path with a kernel that has
    # no float64 form yet raises at construction
    refused = frep["refusals"] = {}
    for what, build in (
            ("TOA-blocked reduction (B5)", lambda: tb.TorchGibbs(
                ma, cfg64, nchains=64, device=dev, tnt_block_size=64,
                dtype=f64)),
            ("2,000 TOAs (B3's cluster form)", lambda: tb.TorchGibbs(
                make_demo_model_arrays(n=2000, components=5), cfg64,
                nchains=64, device=dev, dtype=f64)),
            ("white MTM (B6)", lambda: tb.TorchGibbs(
                ma, cfg64.with_mtm(MTM_TRIES, blocks=("white",)),
                nchains=64, device=dev, dtype=f64)),
            ("SlotPool (the lanes entries)", lambda: serve_pool.SlotPool(
                ma, GibbsConfig(model="mixture"), nlanes=64, device=dev,
                dtype=f64))):
        try:
            build()
            refused[what] = None
        except NotImplementedError as exc:
            refused[what] = str(exc)
    print(f"# float64 26e refusals: {json.dumps(refused)}", flush=True)
    if None in refused.values():
        fail("phase 26: a float64 path without its kernels ran on CUDA")

    # 26a. each float64 kernel against its float64 plain version on the
    # card, on inputs captured from the float64 flagship and ens32
    smp64 = tb.TorchGibbs(ma, cfg64, nchains=NCHAINS, device=dev,
                          chunk_size=F64_CHUNK, record="full", dtype=f64)
    ens64 = EnsembleGibbs(ens_pulsars(ENS_PULSARS), cfg64,
                          nchains=ENS_CHAINS, device=dev, record="light",
                          chunk_size=F64_CHUNK, dtype=f64)
    base_names = ["chol_fused", "tri_solve_T", "white_mh", "hyper_mh",
                  "white_mh_grouped", "hyper_mh_grouped", DRAWS]

    def run64(smp, seed):
        """Two float64 sweeps of ``smp``; the flagship's then its
        chunk-end log-posterior and ``lnlikelihood`` at a chain's x."""
        sweeps = run_capture(smp, seed, 2)

        def run():
            sweeps()
            if smp is smp64:
                st = smp.init_state(seed=seed)
                smp._logpost_chain(st)
                smp.lnlikelihood(st.x[0].cpu().numpy())
        return run

    cap64 = {"flagship_f64": split_draws(capture(base_names, run64(smp64, 7)),
                                         "flagship_f64"),
             "ens32_f64": split_draws(capture(base_names, run64(ens64, 7)),
                                      "ens32_f64")}
    for path, capt in cap64.items():
        want = sorted(n[:-4] for n, (_, _, ps, _) in F64_KERNELS.items()
                      if ps[F64_PATHS.index(path)] and n != DRAWS + "_f64")
        if sorted({k[0] for k in capt}) != want:
            fail(f"phase 26: the {path} sweep reached {sorted(capt)}")
        if any(a[0].dtype != f64 for k, a in capt.items()
               if k[0] != DRAWS):
            fail(f"phase 26: the {path} sweep's operands are not float64")
    print(f"# float64 captured: "
          f"{ {p: sorted(c) for p, c in cap64.items()} }", flush=True)
    for path, capt in cap64.items():
        for (name, shape), args in sorted(capt.items()):
            out_k = wrappers[name][2](*args)
            out_p = plains[name](*args)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(out_k, out_p)]
            rec = {"path": path, "shape": list(shape),
                   "max_abs_err": max(e[0] for e in errs),
                   "max_rel_err": max(e[1] for e in errs),
                   "nonfinite_mismatch": sum(e[2] for e in errs)}
            if name.startswith(("white_mh", "hyper_mh")):
                # the decisions as integer counts, every chain
                steps = mh_steps(name, args)
                n_k, n_p = (torch.round(o[1].double() * steps).long()
                            for o in (out_k, out_p))
                rec["accepts"] = int(n_k.sum())
                rec["chains_acc_mismatch"] = int((n_k != n_p).sum())
                # tolerance: every chain's accept count equal and x to
                # 1e-12 (identical decisions give x bit for bit; float64
                # ties are ulps of rsqrt, log and exp away)
                ok = (rec["chains_acc_mismatch"] == 0
                      and rec["max_rel_err"] <= 1e-12)
            else:
                # tolerance: 1e-9 relative on every output (rsqrt of a
                # double is not correctly rounded on the card)
                ok = rec["max_rel_err"] <= 1e-9
            rec["ok"] = bool(ok and rec["nonfinite_mismatch"] == 0)
            parity.setdefault(name + "_f64", []).append(rec)
            print(f"# parity {name}_f64 {list(shape)}: {json.dumps(rec)}",
                  flush=True)
            if not rec["ok"]:
                fail(f"phase 26: {name}'s float64 kernel disagrees with its "
                     f"plain version at {shape}")
        # D1: the float64 kernel against its float64 plain version on the
        # card (uniforms bit for bit, the rest to 1e-12), and rounded to
        # float32, its float32 draws bit for bit
        keys_d, sw_d, sh_d, tab_d = args_d = draw_args[path]
        out_k = tab_d.views(rng.sweep_draws(*args_d), keys_d.shape[:-1])
        out_p = tab_d.views(rng.sweep_draws_plain(*args_d),
                            keys_d.shape[:-1])
        d32 = rng.sweep_draws(keys_d, sw_d, sh_d.float(), tab_d)
        d64 = rng.sweep_draws(keys_d, sw_d, sh_d.float().double(), tab_d)
        torch.cuda.synchronize()
        unif = [f.name for f in tab_d.fields if f.kind == rng.UNIFORM]
        errs = {k: rel_err(out_k[k], out_p[k]) for k in out_k}
        n32 = torch.isnan(d32)
        rec = {"path": path, "shape": [*keys_d.shape[:-1], tab_d.width],
               "uniforms_bitwise": all(torch.equal(out_k[k], out_p[k])
                                       for k in unif),
               "max_abs_err": max(e[0] for e in errs.values()),
               "max_rel_err": max(e[1] for e in errs.values()),
               "nonfinite_mismatch": sum(e[2] for e in errs.values()),
               "rounded_bitwise_f32": bool(
                   torch.equal(n32, torch.isnan(d64))
                   and torch.equal(d64.float()[~n32], d32[~n32]))}
        rec["ok"] = bool(rec["uniforms_bitwise"] and rec["max_rel_err"]
                         <= 1e-12 and rec["nonfinite_mismatch"] == 0
                         and rec["rounded_bitwise_f32"])
        parity.setdefault(DRAWS + "_f64", []).append(rec)
        print(f"# parity {DRAWS}_f64 {rec['shape']}: {json.dumps(rec)}",
              flush=True)
        if not rec["ok"]:
            fail(f"phase 26: D1's float64 form disagrees on {path}")
        del out_k, out_p, d32, d64

    # 26c. the float64 kernels' times beside the float32 kernels' on the
    # same operands rounded, in turns (32, 64, 64, 32), their bounds (8
    # bytes an element, FP64 operations), plain versions and library calls
    def as32(args):
        return tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                     else a for a in args)

    for path, capt in cap64.items():
        for (name, shape), args in sorted(capt.items()):
            fn, a32 = wrappers[name][2], as32(args)
            t32a, t64a, t64b, t32b = (timed(fn, a, 50)
                                      for a in (a32, args, args, a32))
            byts, ops = work(name, args)
            byts *= 2                     # work() counts 4 bytes an element
            lib = library(name, args)
            row = dict(
                path=path, shape=list(shape), ms=(t64a + t64b) / 2,
                f32_ms=(t32a + t32b) / 2,
                plain_ms=timed(plains[name], args, 3, queue_ahead=False),
                library_ms=timed(lib[0], lib[1], 50) if lib else None,
                bound_ms=max(byts / HBM_BYTES_PER_S, ops / FP64_FLOPS) * 1e3,
                bound_by="bytes" if byts / HBM_BYTES_PER_S
                >= ops / FP64_FLOPS else "operations", bytes=byts, flops=ops)
            if name in ("chol_fused", "hyper_mh", "hyper_mh_grouped"):
                B_, m_ = batch_size(name.replace("_grouped", ""), args)
                row["form"] = list(
                    chol.launch_form(B_, m_, f64) if name == "chol_fused"
                    else hyper_mh.launch_form(B_, m_, f64, args[0].shape[-1],
                                              len(args[10])))
            timing.setdefault(name + "_f64", []).append(row)
            print(f"# time {name}_f64 {list(shape)} ({path}): "
                  f"{json.dumps(row)}", flush=True)
        args_d = draw_args[path]
        row = draw_row(path, args_d, {"library_ms": None})
        keys_d, sw_d, sh_d, tab_d = args_d
        B_ = keys_d.numel() // 2
        row["bytes"] = byts = 8 * (keys_d.numel() + sw_d.numel()
                                   + sh_d.numel() + B_ * tab_d.width)
        row["byte_bound_ms"] = byts / HBM_BYTES_PER_S * 1e3
        fp64_ms = row["floor_ms_by_class"]["fp64"]
        row["bound_ms"] = max(row["byte_bound_ms"], fp64_ms)
        row["bound_by"] = ("bytes" if row["byte_bound_ms"] >= fp64_ms
                           else "operations")
        row["first_design_ms"] = None
        row["f32_ms"] = timed(rng.sweep_draws, as32(args_d), 50)
        timing.setdefault(DRAWS + "_f64", []).append(row)
        print(f"# time {DRAWS}_f64 {row['shape']} ({path}): "
              f"{json.dumps(row)}", flush=True)
    frep["ptxas"] = [
        {k: r[k] for k in ("function", "registers", "spill_stores",
                           "spill_loads", "stack_bytes", "symbol")}
        for r in _cuda.parse_ptxas(_cuda.ptxas_report)
        if re.search(r"I(?:L[a-z]+\d+E)*dE", r["symbol"])]
    for r in frep["ptxas"]:
        print(f"# ptxas float64 {r['function']} {r['symbol'][-40:]}: "
              f"{r['registers']} registers, {r['spill_stores']} B spill "
              f"stores, {r['spill_loads']} B spill loads", flush=True)
    del cap64

    # the main paths, every count reset just before each; a plain
    # decision on the card is counted (none may happen)
    plain64 = {}
    real_use = _cuda.use_kernel

    def counted_use(t, what):
        on = real_use(t, what)
        if not on:
            plain64[what] = plain64.get(what, 0) + 1
        return on

    def main64(path, smp):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smp.sample(niter=F64_ADAPT, seed=1)
        res = smp.sample(niter=F64_MORE, seed=1, state=smp.last_state,
                         start_sweep=F64_ADAPT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = check_launches(path, F64_ADAPT + F64_MORE,
                                chunks_of(smp, F64_ADAPT, F64_MORE))
        st = smp.last_state
        ok = (all(getattr(st, f).dtype == f64 and bool(
                  torch.isfinite(getattr(st, f)).all())
                  for f in ("x", "b", "alpha", "theta", "df"))
              and res.chain.dtype == np.float64
              and bool(np.isfinite(res.chain).all()))
        return {"wall_s": wall, "finite_float64": bool(ok),
                "launches": {n: c for n, c in counts.items() if c}}

    def wall_ms(smp):
        """ms a sweep of ``F64_MORE`` sweeps after 5 to warm."""
        smp.sample(niter=5, seed=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smp.sample(niter=F64_MORE, seed=2, state=smp.last_state,
                   start_sweep=5)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / F64_MORE

    ens32_32 = EnsembleGibbs(ens_pulsars(ENS_PULSARS), cfg64,
                             nchains=ENS_CHAINS, device=dev, record="light",
                             chunk_size=F64_CHUNK)
    smp32 = tb.TorchGibbs(ma, cfg64, nchains=NCHAINS, device=dev,
                          chunk_size=F64_CHUNK, record="full")
    paths64 = frep["paths"] = {}
    try:
        _cuda.use_kernel = counted_use
        for path, s64, s32 in (("flagship_f64", smp64, smp32),
                               ("ens32_f64", ens64, ens32_32)):
            rec = paths64[path] = main64(path, s64)
            if not rec["finite_float64"]:
                fail(f"phase 26: the {path} run is not finite float64")
            walls = [wall_ms(s) for s in (s32, s64, s64, s32)]
            rec["wall_ms_per_sweep"] = {"float64": (walls[1] + walls[2]) / 2,
                                        "float32": (walls[0] + walls[3]) / 2}
            for label, s, w in (("float64", s64, rec["wall_ms_per_sweep"][
                    "float64"]), ("float32", s32, rec["wall_ms_per_sweep"][
                        "float32"])):
                prof = profile(f"{path[:-4]} {label}", s,
                               F64_PROFILE_SWEEPS, w)
                rec[label] = {k: prof[k] for k in (
                    "device_ms_per_sweep", "launches_per_sweep",
                    "idle_share", "wall_ms_per_sweep")}
            print(f"# float64 path {path}: {json.dumps(rec)} | {card}",
                  flush=True)
        if plain64:
            fail(f"phase 26: plain versions ran on the card: {plain64}")
    finally:
        _cuda.use_kernel = real_use
    del ens32_32, smp32, ens64

    # 26b. float64 flagship sweeps, the card against the CPU, each side
    # drawing its own numbers from the same seed and state
    g64 = tb.TorchGibbs(ma, cfg64, nchains=F64_CPU_CHAINS, device=dev,
                        dtype=f64)
    c64 = tb.TorchGibbs(ma, cfg64, nchains=F64_CPU_CHAINS, device="cpu",
                        dtype=f64)
    keys_g, sw_g = keyed(g64, 11, F64_CPU_SWEEPS)
    keys_c, sw_c = keys_g.cpu(), sw_g.cpu()
    st_g = g64._prop_cov_update(g64.init_state(seed=11))
    st_c = type(st_g)(*map(to_cpu, st_g))
    nw, nh = cfg64.mh.n_white_steps, cfg64.mh.n_hyper_steps
    sweeps64, equal_through = [], 0
    for i in range(F64_CPU_SWEEPS):
        st_g = g64._sweep(st_g, g64._draw(keys_g, sw_g[i], st_g), sweep=i)
        st_c = c64._sweep(st_c, c64._draw(keys_c, sw_c[i], st_c), sweep=i)
        g = type(st_g)(*map(to_cpu, st_g))
        rec = {"sweep": i,
               "chains_acc_white": int((torch.round(g.acc_white * nw)
                                        != torch.round(st_c.acc_white * nw))
                                       .sum()),
               "chains_acc_hyper": int((torch.round(g.acc_hyper * nh)
                                        != torch.round(st_c.acc_hyper * nh))
                                       .sum()),
               "chains_z": int((g.z != st_c.z).any(-1).sum()),
               "chains_df": int((g.df != st_c.df).sum()),
               **{f + "_rel": rel_err(getattr(g, f), getattr(st_c, f))[1]
                  for f in ("x", "theta", "b", "alpha")}}
        rec["equal"] = not any(rec[k] for k in (
            "chains_acc_white", "chains_acc_hyper", "chains_z", "chains_df"))
        equal_through += rec["equal"] and equal_through == i
        sweeps64.append(rec)
    frep["card_vs_cpu"] = {"chains": F64_CPU_CHAINS, "sweeps": sweeps64,
                           "decisions_equal_through": equal_through}
    print(f"# float64 26b card-vs-cpu ({F64_CPU_CHAINS} chains): decisions "
          f"equal through sweep {equal_through} of {F64_CPU_SWEEPS}; "
          f"{json.dumps(sweeps64[0])}", flush=True)
    # tolerance: the first sweep's decisions equal on every chain (x, z,
    # df as integer counts), x and theta to 1e-10
    if (not sweeps64[0]["equal"] or sweeps64[0]["x_rel"] > 1e-10
            or sweeps64[0]["theta_rel"] > 1e-10):
        fail("phase 26: a float64 sweep on the card disagrees with the CPU")
    del g64, c64, st_g, st_c

    # 26d. the float64 flagship's arm of phase 24 against its mixture/beta
    # oracle run, under its thresholds
    smp_g64 = tb.TorchGibbs(ma_g, beta, nchains=NCHAINS, device=dev,
                            chunk_size=GATE_CHUNK, record="compact",
                            record_thin=GATE_THIN, dtype=f64)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_g = smp_g64.sample(niter=niter_j, seed=GATE_SEED + 1)
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    check_launches("gate_f64", niter_j, chunks_j)
    rows = pgate.gate_rows(oracles["beta"][0],
                           pgate.keep_rows(res_g, burn_j, thin_j), beta,
                           ma_g.param_names, sub=np.random.default_rng(0))
    for row in rows:
        print(pgate.format_row("# gate float64 beta", row))
    frep["gate"] = {"rows": rows, "wall_s": gwall, "sweeps": niter_j,
                    "float64": bool(res_g.chain.dtype == np.float64),
                    "diverged_chains": pgate.diverged_chains(res_g)}
    print(f"# float64 26d gate: {gwall:.1f} s for {niter_j} sweeps, "
          f"diverged chains {frep['gate']['diverged_chains']} | {card}",
          flush=True)
    if not frep["gate"]["float64"] or not all(r["ok"] for r in rows):
        fail("phase 26: the float64 flagship fails the posterior gate")
    del smp_g64, res_g, smp64
    frep["seconds"] = time.perf_counter() - t26
    print(f"# phase 26: {frep['seconds']:.1f} s | {card}", flush=True)

    # the redesigned kernels beside the first design and the library call
    # (reported, not gated)
    for name in REDESIGNED:
        for r in timing[name] + other_forms.get(name, []):
            first, lib_ms = r["first_design_ms"], r["library_ms"]
            form = f", {r['form']}" if "form" in r else ""
            print(f"# {name} {r['shape']} ({r['path']}{form}): "
                  f"{r['ms']:.4f} ms, {r['ms'] / r['bound_ms']:.1f}x its "
                  f"bound"
                  + (f", first design {first} ms ({first / r['ms']:.1f}x)"
                     if first else "")
                  + (f", library call {lib_ms:.4f} ms "
                     f"({lib_ms / r['ms']:.2f}x)" if lib_ms else ""))

    # --- the kernels line: one entry per kernel, launches summed over the
    # runs (per run in launches_by_path), times the mean over the call
    # shapes the paths launch (each listed in per_shape)
    kernels_line = []
    for name, meta in KERNELS.items():
        rows = timing[name]
        k = len(rows)
        lib_ms = [r["library_ms"] for r in rows]
        kernels_line.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": sum(c[name] for c in launches_by_path.values()),
            "launches_by_path": {p: c[name]
                                 for p, c in launches_by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in parity[name]),
            "ms": sum(r["ms"] for r in rows) / k,
            "plain_ms": sum(r["plain_ms"] for r in rows) / k,
            "bound_ms": sum(r["bound_ms"] for r in rows) / k,
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": (None if None in lib_ms else sum(lib_ms) / k),
            "per_shape": [{f: r[f] for f in ("path", "shape", "ms",
                                             "ungrouped_ms",
                                             "ensemble_form_ms", "plain_ms",
                                             "bound_ms", "library_ms")
                           if f in r}
                          for r in rows]})
    report["timing"] = timing
    report["kernels"] = kernels_line

    try:
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
                  "w") as fh:
            json.dump(report, fh, indent=1)
    except OSError as exc:
        print(f"# could not write chiprun_out/chip_smoke.json: {exc}")

    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
