"""Smoke run of flink_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits nonzero):

  1. device   — requires CUDA; prints the card's name and power limit as
                nvidia-smi reports them.
  2. build    — compiles the kernels G1-G28 from flink_tpu_torch/csrc with
                nvcc (one process a source, all started together), and the
                spill store (host C++) with g++.
  3. kernels  — runs each kernel at the shapes its job gives it and holds it
                against its plain PyTorch version on the same inputs, on
                ``main`` and ``edge`` inputs, exactly (the data is
                integer-valued). G1-G4 at the north-star job's shapes
                (C = 1M keys, R = 8 ring panes, k = 1, B = 262,144 lanes,
                F = 2 fire lanes, max parallelism 128); G1-G3, G5, G6 and G8
                at the sparse-key job's (C = 2^21 slots, R = 12, k = 5 panes
                a window, slide 2,000, probe length 64), G3 there fed the
                slots G5 gives (C for a lane with none) and G1's edge lanes
                late by the k-pane test or behind the ring's horizon; G7 and
                G9 at the churn job's overflow ring (RING_LANES lanes) and
                compaction (2^21 slots, R = 12). G5 may place a contested
                key at another slot than its plain version, so it is held to
                the table's invariants: equal ok and n_new, the same keys
                each once, each within 64 slots of its chain's start where
                lookup finds it, and equal per-key values after a G3 pass
                (kernels against plain versions). G9, whose re-insert is
                G5's CAS walk, is held to the new table's invariants, its
                row move and ring export equal to the plain ones on its own
                slot map, and the same logical cells (plane + ring) as the
                plain version. G7's edge ring fills and loses lanes; G8's
                edge table has no free slot; G9's edge table leaves live
                keys without a slot. ``table_edge_checks`` holds G5, G8 and
                G9 at the shapes their walks and folds make risky (keys up
                to 63 deep at every sector phase, slots cleared by
                remove_slots in front of them, chains that wrap at C, P = 1,
                2, 16, 64, C = 8, B = 0 and 1, views; G9's dead, full,
                failing, R = 1, min / max and Wc = 3 planes), calls A, B, A
                on one scratch and the device operations a call;
                ``fire_session_edge_checks`` holds G4 and G11 at theirs
                (G4: C off its tiles, due and quiet lanes mixed, every
                lane quiet, k = 5 with missing panes, W = 1, 2, 3 and 16,
                add, min, max, re-fire lanes, random floats summed alike
                on two runs; G11: one key over many scan tiles, sessions
                cut at tile edges, B = 0, wrapping ticks, a watermark
                that closes nothing and one that closes every slot),
                calls A, B, A on one scratch and the device operations a
                call, counted in a CUDA graph of one call (G4 one kernel
                on each read path, G11 at most three, no fill or copy);
                ``fire_session_op_split`` gives each device operation of
                G4 (north star, a quiet call, max k = 5, W = 2, fresh)
                and G11 (the sessions job's main case, the DCN shape)
                with its device time (the fire_session_split line); a
                "table_split" line gives each device operation of G5, G8 and
                G9 at their main shapes (and G5 cold, G5 and G8 on absent
                keys) with its device time. After the DCN shapes,
                ``ring_exchange_edge_checks`` holds G7 and G26 at the
                shapes their single launches make risky (G7: B = 0, 1,
                one lane either side of a 2,048-lane tile edge, a taken
                lane at each end of 40 tiles, a ring that fills exactly,
                one full on entry, one that fills mid-tile, every lane
                masked and none, an unaligned mask, W = 1, 2 and a
                count; G26: n = 1, 2, 4, 8, 256, a maxp no power of two,
                cap = 8, one key, no valid lane, W = 2, a ragged batch,
                B = 0, 1 and 2^20), calls A, B, A on one scratch and
                counts each call's device operations in a CUDA graph
                (one kernel, no fill or copy); ``ring_exchange_op_split``
                gives each device operation of G7 (main, W = 2, no lane
                masked) and G26 (the north star's and the DCN window
                job's slices) with its device time (the
                ring_exchange_split line). Then
                ``count_cep_edge_checks`` holds G12 (B = 1 and one lane
                either side of a 1,024-lane tile edge; N = 1, 10, a tile
                +- 1 and above B; one key in every lane, a key over three
                tiles with a window across each edge, fires at tile ends;
                old counts multiples of N or not, `touched` set or not;
                dead lanes, random floats, counts that wrap) and G20 (S =
                2, 3, 15; Q = 2, 9, 126; one, several and all buckets
                stale; one row, an odd row count, an unaligned carry, a
                carry past 2^31 floats) bit for bit, calls A, B, A and
                counts each call's device operations in a CUDA graph (one
                kernel); ``count_cep_op_split`` gives each device operation
                of G20 (one stale bucket and all nine, each beside
                ``index_fill_``) and G12 (the windowcount batch, one key
                in every lane) (the count_cep_split line). A
                "hash_table" line says how
                deep the sparse job's 1M keys sit in their probe chains once
                all have arrived. Times kernel, plain version and, where one
                PyTorch call computes the same function, that call, with
                CUDA events, beside the bound the card's 3.35 TB/s sets on
                the bytes moved. G10-G13 at the keyed jobs' shapes (C = 2^22
                slots, B = 262,144 lanes): G10 on slot keys (the wordcount
                batch's Zipf ranks) and (slot, tick) keys (a sessions
                batch), its edge inputs one key in every lane, dead lanes,
                ticks over the whole int32 range; its permutation also
                equal to torch.sort(stable=True)'s, which is its library
                time (the session key's too); and on the shapes its
                tiling, digit plan and scratch make risky
                (``sort_edge_checks``: n at and around a tile, n = 1,
                bits 1 to 63, constant low, middle and top digits, equal
                and descending keys, dead lanes, a 51-bit session key,
                calls in a row on one scratch, one device kernel a call
                by torch.profiler). G11 on the sessions job's state 17 s
                in (main) and on random open sessions (edge: several
                sessions of one key in a batch, out-of-order ticks,
                merges, supersession, dead lanes, a watermark jump
                closing ~40 % of them); G12 with
                N = 10, edge one key in every lane; G13 edge one key in
                every lane. G14, G15 and G2's split clear at both sketch
                jobs' shapes (C = 2^14, W = 4,096: HyperLogLog p = 12,
                R = 12, k = 5; Count-Min 4 x 1,024, R = 8, k = 2, Q = 3),
                main inputs from a window of the jobs' traffic, edge
                inputs with hashes of rank 33 - p, a fifth of the lanes on
                one key and register, lanes with no slot, dead and
                too-old lanes, random registers, a pane rotated out of
                the ring, and a Count-Min without a query (raw rows, W =
                64); exact but for HyperLogLog's float estimates, held to
                rtol 1e-6. Then (``reduce_kernel_phase``) the modes of the
                reduces, bit for bit (a fire's float lane sums at rtol
                1e-5): G3 max at the maxprice job's shapes (C = 2^21, R =
                12, k = 5; edge: min, a fifth of the lanes on one hot
                slot, negative values, +-0.0, NaN, the lateness fresh
                marking) and W = 2 at the mean job's (C = 2^20, R = 8);
                G2 with the -/+FLT_MAX neutrals, W = 2, the split float
                plane and its fresh rows; G4 and G6 with max (edge: min)
                at k = 5, W = 2 and the fresh mask of re-fire lanes; G9
                on a max plane (edge: a min plane, chains of 2); G1 with
                lateness; G7 with W = 2; G2's fresh_rows, G6's fire_pack
                and G16's rep_gather / rep_set at the late-reduce job's
                shapes (C = 2^21, R = 8, 2F = 4 lanes). Then
                (``telemetry_kernel_phase``) the skew telemetry and the
                flight recorder, exactly: G1 with the key-group fill at
                the north star's and the sparse job's batches (maxp 128;
                edge: maxp 32,768, every lane on one key, dead, late and
                purged lanes), timed beside G1 without the fill and
                torch.bincount over G1's kg; G17 kg_occupancy at the north
                star's state (direct, packed sum, C = 1M, R = 8), the
                sparse job's (hash, C = 2^21, R = 12, half the slots
                empty), the distinct job's split plane and the
                late-reduce job's fresh cells (edge: maxp 32,768, every
                slot on one key), its bound the bytes this data needs (the
                touch cells up to a slot's first touched row, an alive
                slot's key); G18 slot_stats and its companion on a
                north-star slot (edge: the first advance from the MIN
                sentinel, a jump past 2^20 ticks, negative watermarks, a
                watermark that stays, kg-fill off with 2F lanes, the
                end-of-stream jump; each also in the chained drain's
                deferred mode). Then (``cep_kernel_phase``) the
                count NFA of device CEP, bit for bit (every count below
                2^24): G19 cep_scan at the cep job's shape (16,384 lanes
                of 1,000 keys, D = 3, capacity 2^16), the cep-within job's
                (8,192 lanes, the port's default batch, of 1M keys, D =
                20, capacity 2^22), the same at 262,144 lanes (a stress
                case), one segment of 262,144 lanes at D = 20 (the
                non-keyed stream), and the largest D, 128 (15 stages, a
                hot key, dead lanes); G19 must refuse D = 129; G20
                cep_expire over
                carry [2^22 + 1, 20] with one stale bucket. Library time:
                none (no PyTorch call computes a segmented matrix-product
                scan). Then (``chain_kernel_phase``) the chained stages'
                kernels, bit for bit: G21 chain_pack at the chained job's
                real second drain (the stage-0 fires of 1 s windows 2 and
                3, ~865,000 keys each, in its [16, 2, 1M] arena) into an
                edge of 2^22 lanes, and on an over-full edge (2^20 lanes),
                every plane invalid, every plane empty, counts above C,
                W = 2 values and the end-of-stream watermark clamp; it must
                refuse 1,025 planes; its library time is none (no PyTorch
                call packs prefix-compacted planes). G22 fire_columns on
                that drain's [16, 2] fires (edge: 3 live slots of 16, 4
                lanes a slot), its library time Tensor.sum(dim=1) over the
                counts; stage_record at a stage-1 fire (edge: the first
                advance from the MIN sentinel, the flush, an over-full
                edge). Then (``res_kernel_phase``) G1's residency mode,
                tiered state's divert, bit for bit: at the north star's
                batch with half the key groups resident (main), all
                resident (which must equal G1 without the mask) and none
                (every live lane cold), at maxp 32,768 on G1's edge
                lanes, and at the tiered job's own shape (32,768 Zipf
                lanes, maxp 64, the TierManager's initial 5-of-64 mask,
                without and with the fill); timed beside G1 without the
                mask, its library time res.index_select(0, kg) over G1's
                kg. Then (``library_kernel_phase``) the batch libraries'
                kernels, exactly (integer-valued sums under 2^24; NaN
                against NaN for an add): G23 scatter_ids at TPC-H Q1's
                shape (SUM of l_discount x 100 over SF1's 6,001,215
                lineitem rows into 4 groups, int64 ids), with the count
                column (AVG), MIN and MAX of l_extendedprice, into Q18's
                1,500,000 orders, at KMeans' W = 16 with counts (2^20
                points, 64 centers), 2^25 lanes into community
                detection's 2^24 cells, and edge lanes (NaN, +-0,
                negative and out-of-range ids, int32 ids, add, min and
                max with counts and the touched-row flag, 7 and 2^20
                rows); its library time index_add_ (scatter_reduce_ amin
                for MIN); G24 sorted_probe at the DataSet join's shape
                (1,000,000 probes, a fifth missing, into SF1's 10,000
                supplier keys; edge: the first and last key, below and
                above every key, +-2^62, one build key, none), its
                library time torch.searchsorted; G25 row_argmin at KMeans'
                [2^20, 64] (edge: ties, NaN, all-equal rows, K = 1, 100),
                its library time torch.argmin over the materialised
                distance; row_argmax at community detection's first
                superstep at V = 4,096 (edge: NaN, zero and negative
                rows; ``argmax_edge_checks``: K from 1 to 4,097 on the
                warp and block paths, float4 and scalar loads, NaN first,
                last and inside a float4, ties across warps and load
                slots, labels and scores bit for bit), its library time
                torch.max(m, 1). G23's shared
                path also on its risky shapes (``scatter_edge_checks``: W
                = 3 through an offset view with N not a multiple of a
                chunk, G (W + 1) at its shared limit and past it, each
                path asserted, and KMeans' shape on random floats twice,
                bit for bit the same). G6 on its tiling's risky shapes
                (``fire_edge_checks``: C at a tile +- 1 and +- 2, one
                emitting slot in the last tile, every lane emitting every
                slot, no lane due, min, max, a fresh plane, W = 2, 3 and
                16 at k = 64, fire_pack with W = 3 and without rows, two
                calls on one scratch, one device kernel a call by
                torch.profiler); its library times torch.masked_select of
                the due lanes' payload by the emitted mask (one call),
                beside nonzero + index_select (fire_compact) and one
                lane's index_select of precomputed indices (fire_pack).
                G28 remove_slots, which no path calls (as in the
                reference), on a 2^21-slot table with half its slots
                cleared (main) and on masked-off lanes, slots out of range
                and in [-C, 0), repeated slots, int32 and int64 slots and
                no lane (edge), its library time index_fill_. G2 on the
                shapes its 16-byte stores make risky
                (``clear_edge_checks``: Wc = 3 rows off 16-byte alignment
                with an evicted row, every row, no row, the last row, a
                +FLT_MAX neutral, the fresh plane alone, split planes
                with a vector neutral, fresh rows on their own mask, int32
                rows not a multiple of 4 words, one device kernel a call
                by torch.profiler). G19 on the shapes its tiles and
                look-back make risky (``cep_edge_checks``: segments ending
                a lane before, at and after a tile boundary, a hot key
                through every tile, pieces of one lane, S = 1, Q = 1, dead
                lanes across tiles, B below a tile and ragged, D = 128 at
                S = 2, 15 and 127, S = 4, batches for its 128- and
                256-lane tiles, calls in a row on one scratch, one device
                kernel a call by torch.profiler). G1 on the shapes its
                4-lane groups, its multiply-shift divide and its tagged
                last-block fold make risky (``route_edge_checks``: B = 0,
                1, 3, 1,001, a view one lane in, every lane invalid or
                late, one owned key group, negative ticks down to
                INT32_MIN at slides 1, 7 and 1,000, maxp 100 and 32,768,
                each alone, with the fill, the residency mask and both;
                calls A, B, A on one scratch; one device kernel a call).
                G3 on the shapes its 4-lane groups and vector reductions
                make risky (``update_edge_checks``: B = 1, 3 and odd, a
                view one lane in, W = 1, 2 at both 8-byte phases, 3 and
                16, count, a hot cell under add, min and max with signed
                zeros and NaN, a fresh plane, no-slot lanes counted and
                not; one device kernel a call).
  4. e2e      — the north-star job (1M integer keys, 2,000 events/ms, 5 s
                tumbling-window sum, batches of 262,144, ring depth 16,
                2 fires per step, 30M events = 3 windows) through the port's
                public API with ``state.backend.overflow-ring: 0``; the
                sink's count and value sum must equal a numpy reference, and
                G1-G4 must have launched. Then the telemetry run: the same
                job with observability.drain-stats on (every drain read),
                kg-stats on (occupancy at every fire boundary): the flight
                recorder's totals must hold the 30M events and no drop,
                its fired keys the drains' fires (``metrics.fires`` less
                the watermark-only advances'), its panes plus those of
                the watermark-only advances the stream's; the occupancy
                must equal numpy's bincount of the live keys' key groups
                at its last refresh, the fill the sampled batches' lanes;
                G1's fill, G17 and G18 must have launched; its events/s
                print beside the run without telemetry.
  5. sparse   — nexmark q5's HOP(2 s, 10 s) count per key over the same
                traffic with the 1M keys mapped to sparse 64-bit ids
                (splitmix64), state capacity 2^21 (a load of 0.48) probed 64
                slots deep, the overflow ring unset (auto-sized), into a
                sink that keeps every row: the auto layout must resolve to
                hash; the row count must equal numpy's distinct (key,
                window) count, the values must sum to 5 x 30M, no record may
                drop, every row of the keys whose id is 0 mod 1024 must
                equal numpy's, the steps must have gone to the lookup-only
                fast step once the key population stopped growing, and G1,
                G2, G3, G5, G6, G7 and G8 must have launched.
  6. churn    — the same query over auction ids that churn: at event time
                t ms the id is splitmix64(100 t + u), u uniform in
                [0, 250,000); 60M events (30 s), capacity 2^21 probed 64
                deep, the ring unset. Dead ids fill the table, records
                whose id finds no slot spill to the ring and the host
                stores, and the table compacts. Every (id, window, count)
                row must equal numpy's; the live ids must stay under 0.7
                of capacity and the distinct ids reach 1.5x it; at least
                two compactions and a non-empty spill; nothing dropped;
                G1-G3, G5, G6, G7 and G9 launched.

  7. sessions — nexmark q11's SESSION(dateTime, 10 s) count(*) per bidder:
                1M sparse bidder ids (splitmix64 of an index); at t ms the
                index is (50 t + u) mod 1M, u uniform in [0, 250,000) by a
                hash of the event index, so each bidder bids in a 5 s burst
                every 20 s; 40M events (20 s), monotonous watermarks,
                capacity 2^22, as EventTimeSessionWindows.with_gap(10,000)
                .count(). Every (id, start, end, count) row must equal
                numpy's sessionization; nothing late or dropped; G5, G10,
                G11 launched. A "session_table" line says how deep the ids
                sit in their chains of 16.
  8. wordcount — Flink's streaming WordCount, key_by(word).sum(value):
                word ranks by the inverse Zipf(1.0, 1M) CDF at
                splitmix64(event index) / 2^64, ids splitmix64(rank), value
                1; 15M events (30M cut to keep the script's wall),
                capacity 2^22. Every one of the 15M rows, in input
                order, must equal numpy's running count of its word;
                G5, G10, G13 launched.
  9. windowcount — Flink's WindowWordCount as count_window(10).sum(value)
                on the same stream (the example's slide of 5 cut: the
                reference's count_window has no slide). The (id, ordinal)
                rows must equal numpy's floor(count / 10) windows per word,
                each worth 10; G5, G10, G12 launched.
 10. distinct — nexmark q16's count(distinct bidder) per channel over
                nexmark-flink's bid stream: channel one of 4 hot channels
                with probability 1/2, else uniform over 10,000 others
                (integer ids 0..10,003); bidder splitmix64 of a uniform
                index in [0, 1M); 2,000 events/ms, each draw a hash of the
                event's index. key_by(channel).time_window(10 s, 2 s)
                .distinct_count(bidder, precision=12), capacity 2^14
                probed 64 deep, 30M events (15 s): 3.2 GB of registers.
                Every (channel, window, estimate) row must equal numpy's
                HyperLogLog of the same hashes (the estimate at rtol
                1e-6), the median relative error against the exact
                distinct count over the 4 hot and every 64th cold channel
                must be under 3 %, nothing dropped, the layout hash; G1,
                G2, G5, G14, G15 launched. A "distinct_table" line says how
                deep the 10,004 channels sit in their chains.
 11. countmin — BASELINE #3's Count-Min as bench_configs.py runs it,
                keyed by channel: time_window(8 s, 4 s).count_min(auction,
                depth=4, width=1024, query=[1, 2, 3]) on the same stream,
                auction Zipf(1.3) mod 100,000; 30M events, 2.1 GB of
                registers. Every (channel, window, [3] estimates) row must
                equal numpy's Count-Min exactly and be at least the exact
                count; G1, G2, G5, G14, G15 launched.

 12. maxprice — nexmark q7's MAX(price) keyed per auction as q5 keys it:
                key_by(auction).time_window(10 s, 2 s).max(price), auctions
                splitmix64 of a uniform index in [0, 1M), price nexmark's
                round(10^(6u) * 100) as float32, 30M events, capacity 2^21
                probed 64 deep (hash layout, spill tier). Every (auction,
                window, max) row must equal numpy's; G1-G3, G5-G7
                launched.
 13. mean     — key_by(bidder).time_window(10 s).mean(price) over 1M
                integer bidders, capacity 1M (the direct layout's [C*R, 3]
                plane), 30M events; every row within rtol 1e-5 of numpy's
                float64 mean; G1-G3, G6, G7 launched.
 14. late-reduce — the north star's traffic with 5 % of it moved back by
                up to 3 s, a 500 ms watermark bound, time_window(5 s)
                .allowed_lateness(2 s).reduce(a + b), hash layout,
                capacity 2^21, 30M events: each (key, window)'s last row
                equals numpy's sum of the records not beyond the lateness,
                the late drops equal numpy's count, and the windows with
                re-fire rows are exactly those a late-but-allowed record
                reached; G1, G2, fresh_rows, G5, G10, G16, fire_pack
                launched.
 15. cep      — BASELINE #5 as bench_configs.py:264-287 runs it:
                from_collection of its 400,000 events (seed 3; names a, b,
                x, y at 0.05, 0.05, 0.45, 0.45; 1,000 keys), key_by(key),
                begin("a").followed_by("b") in processing time, batches of
                16,384, select(1.0) into a CountingSink. The count must
                equal numpy's closed form (for each b, the earlier a's of
                its key), detected == extracted; G5, G10, G19 launched.
 16. cep-within — the Flink 1.2 CEP documentation's Getting Started
                pattern, keyed and in event time: start (id == 42) next
                middle (SubEvent, volume >= 10) followedBy end (name ==
                "end") within 10 s (S = 3, Q = 9, D = 20), over 2M events
                at 100 a ms from a columnar GeneratorSource through
                to_elements (1M sparse splitmix64 keys; id uniform in
                [0, 64), SubEvent p 0.5, volume uniform in [0, 20), end p
                0.1, up to 16 ms out of order behind a 16 ms bounded
                watermark; each draw a hash of the event's index salted
                by ``--seed``, default 8), capacity 2^22, the port's
                default batch. No record dropped, detected == extracted ==
                rows; every key's rows, in order, equal to numpy's
                enumeration of its matches (key, start, middle and end
                event), and each of 10,000 sampled keys' rows equal to the
                copied host NFA's over its events in timestamp order on
                pane-quantised timestamps; G5, G10, G19, G20 launched.
 17. chained  — a per-second rollup of the north star, two chained keyed
                window stages in one drain: key_by(key).time_window(1 s)
                .sum(value).key_by(r.key).time_window(5 s).sum(r.value),
                the north star's traffic (1M integer keys, 30M events,
                batches of 262,144, ring depth 16, F = 2), direct layout at
                capacity 1M, no overflow ring, an edge of 2^22 lanes
                (pipeline.stages.exchange-lanes). The 1 s windows nest in
                the 5 s ones, so every one of its ~3M rows must equal
                numpy's 5 s count of that (key, window); nothing dropped;
                G1-G3, G6 and G21 launched. Then again with
                observability.drain-stats on (every drain read): the
                recorder's stage row must carry every stage-0 row across
                the edge (numpy's distinct (key, 1 s window) pairs), drop
                none and peak at most at the edge's width; G18, G22
                launched.
 18. chained-sparse — the same rollup over the sparse job's splitmix64
                ids, hash layout at capacity 2^21 probed 64 deep: the row
                count and value sum equal numpy's, every row of the ids 0
                mod 1024 equal to numpy's, nothing dropped, and G5
                launched in both stages (once a stage-0 slot plus once a
                drain).
 19. checkpoint — the north star (its keys, traffic, batches, direct
                layout and no overflow ring) into a sink that keeps every
                row, as the reference's run_checkpoint_overhead cell
                (bench_configs.py:380) at the north star's width, in turns:
                checkpoints off; sync-full every 32 batches into a
                temporary directory; again with a step.drain fault at
                the drain dispatch whose read first emits window 2 (the
                restore returns to the cut before it) and again with an
                ingest.producer fault at the producer's 51st prep, each
                with restart-strategy fixed-delay (1 attempt, delay 0).
                The scan drain, the producer thread ahead of every cut.
                Each run's events/s, checkpoints, mean and max sync_ms and
                bytes; the crashed runs' seconds from the fault to the
                first dispatch after the restore. Every run's (key,
                window) -> value map must equal numpy's, and a window a
                crashed run emits twice must carry the same value both
                times (the drain crash's count is printed, and must be
                above 0 unless a cut fell between window 2's emission and
                the crash, which the line says); G1-G3, G6 launched.
 20. tiered   — the reference's own cell, bench_configs.py:2508
                run_tiered, at its shape: max parallelism 64 and a budget
                of 5 resident key groups, 4,096 keys drawn Zipf(2.5) with
                seed 7, batches of 32,768, a 1 s tumbling sum, ts =
                (index // 4,096) * 125 ms, capacity 2^14 in the hash layout
                with the auto-sized overflow ring, 8M events (about 244
                windows); all-resident and tiered in turns, then tiered
                with observability.drain-stats and kg-stats on (faults and
                heat fed). Each run's events/s, p99 fire latency, the
                tiers report and the host seconds in the swaps, the
                tiered / all-resident ratio beside the reference's
                >= 0.6 criterion (information only). Every row must equal
                numpy's and every tiered run must demote and promote; G1
                with the mask, G2, G3, G5, G6, G7 launched.
 21. ingest   — the window runner's dispatch modes and its producer
                thread. The north star (after the e2e run, which is
                ``auto``) in each mode: ``auto`` (the split path: an
                update step a batch, the fire steps at each crossing, the
                producer polling, encoding and staging ahead), ``on``
                (the scan drain), ``while`` (the while-drain, max_slots
                32) and ``auto`` with ``pipeline.prefetch: off``; each
                with its count and sum against numpy, events/s, p99 fire
                latency, drains or steps, ring publish refusals, and the
                card's idle share from a second, profiled run; G1-G4
                launched in each. The telemetry, checkpoint and tiered
                runs pin ``on`` (the recorder and the step.drain seam
                exist only on the drains). bench_configs.py:459
                run_ingest_pipeline at its shape (2^20 keys, capacity
                2^21, batches of 131,072, 10 s windows; 15M events, its
                30M cut to keep the script's wall):
                prefetch off, on, and on with sync-full cuts every 8
                batches (its incremental and async cuts raise: item 13),
                count and sum against numpy, the ratios.
                bench_configs.py:1912 run_while_drain at its shape (B =
                512, C = 4,096, ring 9, 4 fire lanes, 4 batches a pane,
                512 batches): the scan drain at D = 32 against the
                while-drain at 64 slots, events/s (best of two after a
                warm run), dispatches, p99 fire visibility, every fired
                window's keys and sum against numpy's. A producer thread
                publishing 512 batches of 8,192 lanes into a 16-slot
                device ring while the step loop retires slots from
                write-cursor snapshots: every slot retired once, each
                read (after its copy event) holding its own batch.
 22. megastep — K-step dispatch fusion (``pipeline.steps-per-dispatch``)
                and its controller. First (``mega_kernel_phase``) the
                megasteps against K = 8 sequential single steps at the
                north star's shapes (C = 1M, R = 8, F = 2, B = 262,144,
                direct sum), over 8 batches that cross the first window's
                end half-way: the plain megastep against 8 update steps,
                the fused-fire megastep (reduced and compact) against 8
                update-then-fire steps, every state field and every
                sub-step's fires bit-equal, and the wall of one call each
                (best of 3). Then the north star with
                ``pipeline.resident-loop: off`` at K = 1, at K = 8 with
                fused fire and at K = 8 with ``pipeline.fused-fire: off``
                (count and sum against numpy, events/s, p99 fire latency,
                megasteps and fused-fire megasteps, the card's idle share
                from a second, profiled run; G1-G4 launched), and ``auto``
                at K = 8, which must run the scan drain (drains, no
                megastep). Then the north star with ``controller.enabled:
                true`` on ``on`` (the recorder and key-group heat on) and
                on ``off`` at K = 8: rows against numpy, the controller's
                cycles, actions, reverts, actuators and ledger on one
                line, the doctor's findings on the next.
                bench_configs.py:1306 run_device_update_ceiling's
                fire_grid (B = 512, C = 4,096, ring 9, 4 fire lanes, 4
                batches a pane, 256 batches a cell where the bench takes
                1,024 x K), K in {1, 4, 8}, dup in {0, 0.5}: ``split``
                (groups broken at each crossing, the reduced fire step and
                its blocking read) against ``fused`` (fused-fire megasteps,
                read one dispatch late), events/s and host us a batch
                (one timed run after a warm run), every window fired against
                numpy's (keys, sum).
 23. libraries — the batch libraries through the port's public API, the
                data from seed 13 with numpy, one line a workload (wall
                seconds, rows / edges / points a second, G23-G25
                launches, the card's busy ms and idle share from
                torch.profiler), every result checked in float64:
                TPC-H Q1 in SQL over an SF1 lineitem with dbgen's value
                distributions (4 groups, COUNT exact, the sums within
                rtol 1e-3: both packages accumulate in float32) and
                Q18's inner aggregate (GROUP BY l_orderkey, 1,500,000
                groups, every sum exact); the DataSet word count
                (group_by(0).sum(1)) over 1,000,000 Zipf(1.0) words,
                every count exact, and an inner join of 1,000,000 probe
                rows (a fifth missing) against SF1's 10,000 supplier
                keys, which the plan ships broadcast-hash onto G24, every
                pair exact; Gelly at Graph500 scale 20, edge factor 16
                (Kronecker A, B, C = 0.57, 0.19, 0.19, labels permuted,
                made undirected by doubling: 2^25 edges, uniform(0, 1)
                weights): page_rank (5 iterations) against a float64
                power iteration at rtol 1e-3, connected_components
                against scipy's (minimum vertex id) exactly,
                single_source_shortest_paths from the vertex of highest
                degree against scipy's dijkstra at rtol 1e-5, hits (5
                iterations, unit non-negative vectors), the degrees
                exactly, and at scale 12 (V = 4,096) triangle_count
                against scipy exactly and community_detection; FlinkML:
                KMeans over 2^20 points of 64 blobs (D = 16, K = 64, 5
                iterations), every assignment equal to a float64 Lloyd
                from the same seeding; KNN (Q = 4,096, k = 10) against
                numpy on 64 sampled queries; MultipleLinearRegression at
                N = 2^20, D = 64 recovering its coefficients within
                0.05; ALS at MovieLens-1M's dimensions (6,040 users,
                3,706 items, 1,000,209 synthetic ratings, F = 10, 5
                iterations), its regularised risk falling from the
                initial factors'.
 24. sharded — the shard mesh (parallelism 4; ``force_device_count(4)``
                puts the four shards on the one card, a ``sharded_mesh``
                line says so, and their collectives are copies within
                it): G26 exchange_pack and G27 shard_sum against their
                plain versions in phase 3 (``shard_kernel_phase``; G26
                at one source shard's slice of the north star's batch,
                65,536 lanes, n = 4, cap 32,768, and edge inputs: one key
                in every lane, no valid lane, W = 2, a ragged batch, n =
                8; G27 at the rolling job's B = 262,144 over 4 shards,
                and edge: W = 2, no valid lane, 8 shards, lanes valid on
                several shards), exactly; then the north star at full
                size (30M events) in the default mode (the adaptive
                exchange, the split path), and at 10M events on
                ``all_to_all``, ``mask``, the sharded drain (``on``), the
                sharded while-drain, the exchange drain (``on`` with
                ``data-parallel: off``) and K = 4 megasteps with fused
                fire on and off, each one's count and sum against numpy,
                nothing dropped, its route counts and events/s; the
                sparse job (10M events, the hash layout) every row
                against numpy; the rolling WordCount (10M words) every
                output against numpy, through G27; and the checkpoint
                job crashed at a sharded drain and restarted, every row
                against numpy.
 25. sharded_keyed — every other keyed job kind at parallelism 4, the
                four shards again on the one card: in phase 3
                (``sharded_keyed_kernel_phase``) G1's owner mask on the
                cep and cep-within jobs' batches (16,384 and 8,192
                lanes; edge: a fifth of the lanes on one key, dead
                lanes) for each of the four shard ranges, G27 at CEP's
                float32 [B] delta shape over four disjoint owner masks
                (timed beside torch.stack(...).sum(0)) and G21 on one
                shard's stack of the chained job's second drain (edge:
                an over-full edge), exactly, and G11's check compares
                its ``marks`` too; then, each job once under
                torch.profiler recording the card (events/s and the
                card's idle share from that run): nexmark q11 sessions
                and WindowWordCount (10M events each; G1's owner mask,
                G5, G10, G11 / G12 a shard), the cep job (400,000
                events) and cep-within (2M; the sharded count NFA, G27's
                delta sum), the chained rollup (10M) on the mask drain
                and on the sharded chained drain, the late-reduce job
                (20M: its first window fires while late records still
                come) and the north star with the flight recorder on
                every shard (10M; a report row a shard, their events
                every record, the live keys per key group against
                numpy's); every row against numpy (CEP key by key and
                against the host NFA on a sample of keys).
 26. dcn      — the sharded broadcast join through ``broadcast_join(...,
                ctx)`` over 4 forced shards (1,000,000 probes, half
                missing, into 10,000 build keys; every lane against
                numpy, one G24 launch a shard), and the cross-process
                plane (``flink_tpu_torch/runtime/
                dcn.py``): in phase 3 (``dcn_kernel_phase``) the sharded
                broadcast join (K21 sharded: 1,000,000 probes into
                10,000 build keys over 4 forced shards, each shard's G24
                against its plain version, edge: the single-shard edge
                probes with invalid lanes; the whole join timed beside
                one torch.searchsorted over the same probes), G26 at
                the window job's shard slice (131,072 lanes, n = 4, cap
                65,536), and the keyed jobs' kernels at the lanes their
                workers give shard 0, driven round by round from each
                builder's own source (round 3, and the last round): G10
                and G11 at the sessions job's (524,288 gathered lanes, C
                = 2^18), G10 and G19 at the cep job's (32,768, C =
                2^16), G10 and G13 at the rolling job's (262,144
                exchanged, C = 2^20), all exactly; then two worker
                processes of
                ``python -m flink_tpu_torch.runtime.dcn`` on the one
                card, two forced shards each (n = 4), over a Gloo group
                on localhost, nvidia-smi sampling the card's utilization
                every 100 ms (the lockstep window run also under
                torch.profiler recording the card): the window job (the
                north star's 1M keys, 5 s tumbling sum, 262,144 lanes a
                host, 4M events a host, the hosts' streams interleaved
                at 500 events a ms: 16 s, three windows firing before
                its end) lockstep and resident at ring depth 8, the
                resident job stopped after a complete checkpoint that
                holds emitted rows and restored (its rows exactly once,
                the cut's rows replayed), nexmark
                q11 sessions, a rolling sum over the north star's keys
                (2M events a host each) and BASELINE #5's pattern
                without within (the cep job's 400,000 events); every
                row against numpy (CEP key by key), each job's events/s,
                the Gloo bytes a host sends per round and the card's
                idle share, and each kernel of its path launched by the
                workers. The kernels are built before the workers start
                (they load the library, never build it).

Every event-time window job's line (north star, telemetry, sparse, churn,
distinct, countmin, maxprice, mean, late-reduce, the three chained runs,
the checkpoint and tiered runs) carries its fire latency:
p50 and p99 over its windows, from a drain's dispatch (or a watermark
crossing) to the emission, with the sample count.

Each path's launch counters are set to 0 just before it runs and read just
after. A line {"phase": "phase_seconds", ...} gives each phase's wall
(by the numbers above; 21 holds the north star's dispatch modes, run
right after phase 4) and the walls of phase 3's and phase 23's parts.
Then one line {"kernels": [...]} (launches summed over every path,
every run of the checkpoint, tiered, megastep and controller jobs counted;
G19's shapes other than cep-within's nested in its entry; G21's edge
cases nested in its entry; G1's fill and its residency mode nested in
G1's entry, numbers from phase 3; G14 and G15 at the distinct job's
shapes, the countmin job's in phase 3's line; the new modes nested under
their kernel in phase 3's line), and last {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

adds, before those two lines, a profile of seventeen of the jobs (all
but telemetry and chained-stats; checkpoint with its checkpoints on,
tiered with its budget): the generator's host time alone, the host's top
functions (and, for the CEP jobs, the cumulative seconds of the element
conversion, the reorder buffer, the predicates, batch_gaps, the count
NFA's advance, replay and prune; for the chained jobs, of the key encode,
the drains, their stage tails, the fires' reads and emits and the
flushes; for the checkpoint job, of the cut, its staging, extraction,
spill fold, write and restore; for the tiered job, of the maintenance
pass, the swaps and their staging, folds, fetches and rebuilds), and the
card's busy time and idle share from torch.profiler.

    python3 chip_smoke.py --seed N

salts the cep-within job's events and its sample of keys with N, and

    python3 chip_smoke.py --log PATH

also appends every JSON line to PATH.

    python3 chip_smoke.py --stress N

builds the kernels, then runs every phase-3 check of G4, G11, G7, G26,
G12 and G20 N times over (a "stress" line a round), their operation
splits once and a probe of whether a store of part of a 32-byte sector
makes the card read it (the sector_probe line), and stops: no other phase
and no contract line.
"""

import ctypes
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch import StreamExecutionEnvironment, native
from flink_tpu_torch.cep.device import DevicePatternSpec
from flink_tpu_torch.core.config import Configuration, CoreOptions
from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashtable, segment, session_windows, sketches
from flink_tpu_torch.ops.cuda import EMPTY_WORD, PANE_NONE
from flink_tpu_torch.ops.hashing import probe_hash, route_hash, splitmix64
from flink_tpu_torch.metrics.latency import weighted_percentile
from flink_tpu_torch.ops.window_kernels import ReduceSpec, fire_row_buffers
from flink_tpu_torch.runtime import checkpoint as ckpt_mod
from flink_tpu_torch.runtime.executor import MON_EVERY, OVF_LAG, panes_crossed
from flink_tpu_torch.runtime.sinks import ColumnarCollectSink, CountingSink
from flink_tpu_torch.runtime.sources import GeneratorSource
from flink_tpu_torch.runtime.tiers import TierManager
from flink_tpu_torch.testing import faults

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate

# the north-star job (bench.py, BASELINE.json)
N_KEYS = 1_000_000
WINDOW_MS = 5_000
EVENTS_PER_MS = 2_000
BATCH = 262_144
RING_DEPTH = 16
FIRES_PER_STEP = 2
MAX_PARALLELISM = 128
TOTAL_EVENTS = 30_000_000
RING_PANES = 8                # the executor's auto-sized ring at k = 1
SPIN_CYCLES = 50_000_000      # ~25 ms of spinning at the H100's boost clock

# the sparse-key job: nexmark q5's HOP(dateTime, 2 s, 10 s) count per key
SPARSE_SIZE_MS, SPARSE_SLIDE_MS = 10_000, 2_000
SPARSE_CAPACITY = 1 << 21     # a load of 0.48 for 1M keys
SPARSE_RING = 12              # the executor's auto ring at k = 5
# the churn job: nexmark q5's HOP(2 s, 10 s) count with auction ids that
# churn — 100 new ids a millisecond, bids spread over the 250,000 newest
CHURN_TOTAL = 60_000_000      # 30 s of event time
CHURN_IDS_PER_MS = 100
CHURN_LIVE = 250_000
CHURN_CAPACITY = 1 << 21
CHURN_SEED = 77 << 40
# the executor's auto-sized overflow ring at this batch and ring depth
RING_LANES = ((-(-MON_EVERY // RING_DEPTH) * RING_DEPTH * (OVF_LAG + 1)
               + 4 + RING_DEPTH) * BATCH + 8192)
# the sessions job: nexmark q11's SESSION(dateTime, 10 s) count(*) per
# bidder, 1M sparse bidder ids, 40M events (20 s) at EVENTS_PER_MS
SESSION_GAP_MS = 10_000
SESSION_BIDDERS = 1_000_000
SESSION_ACTIVE = 250_000      # bidders bidding at any one time
SESSION_RATE = 50             # bidder indices the burst advances per ms
SESSION_SALT = 0x5E55
SESSION_TOTAL = 40_000_000
SESSION_WARM_BATCHES = 130    # the G11 main case: 17 s into the stream
# the wordcount and windowcount jobs: Flink's streaming WordCount and
# WindowWordCount over a Zipf(1.0) stream of a 1M-word vocabulary
N_WORDS = 1_000_000
WORD_TOTAL = 15_000_000       # 30M cut to keep the script's wall
COUNT_N = 10                  # WindowWordCount's countWindow(10, 5), cut
KEYED_CAPACITY = 1 << 22      # the three jobs' state slots (probe 16)
# the sketch jobs (BASELINE config #3): nexmark's bid stream
BID_TOTAL = 30_000_000        # 15 s of event time
BID_HOT, BID_COLD = 4, 10_000 # BidGenerator's hot channels and the rest
BID_BIDDERS = 1_000_000
BID_AUCTIONS = 100_000
BID_ZIPF_S, BID_ZIPF_HEAD = 1.3, 1 << 16
BID_SALT_CHANNEL, BID_SALT_BIDDER, BID_SALT_AUCTION = 0xC4A, 0xB1D, 0xA0C
SKETCH_CAPACITY = 1 << 14     # 10,004 channels: load 0.61
SKETCH_PROBE_LEN = 64         # some 60 of the 10,004 channels sit 16+ deep
DISTINCT_SIZE_MS, DISTINCT_SLIDE_MS = 10_000, 2_000
DISTINCT_RING = 12            # the executor's auto ring at k = 5
HLL_P = 12
CMS_SIZE_MS, CMS_SLIDE_MS = 8_000, 4_000
CMS_RING = 8                  # the executor's auto ring at k = 2
CMS_DEPTH, CMS_WIDTH, CMS_QUERY = 4, 1024, [1, 2, 3]
# state.probe-len: once the 1M keys have arrived (a load of 0.48), 334-338
# of them sit 16 or more slots from their chain's start, 3-4 sit 32 or
# more, the deepest 38 (the hash_table line of two runs on an NVIDIA H100
# 80GB HBM3, 700 W; see PERF.md). Strict capacity fails the job on any key
# that finds no slot, so 16 or 32 slots would fail it; 64 hold every key.
PROBE_LEN = 64


LOG = []          # ``--log PATH``: every JSON line is also appended there


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    for path in LOG:
        with open(path, "a") as f:
            f.write(line + "\n")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def gen_batch(offset, n, n_keys=N_KEYS, events_per_ms=EVENTS_PER_MS):
    """bench.py's generator: keys by a multiplicative hash of the offset,
    event time = offset / rate, every value 1."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    keys = (idx * 2862933555777941757) % n_keys
    return keys, idx // events_per_ms, np.ones(n, np.float32)


def time_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call. A spin kernel holds the card while the
    host enqueues all ``reps`` calls, so the events bracket device work
    only, not the host's launch overhead (a call that synchronises inside,
    as some plain versions do, still counts its host time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(a, b) -> float:
    """The largest difference of two tensors (or of two lists of them);
    for integer tensors the number of elements that differ, and infinity
    for tensors of different shapes."""
    pairs = zip(a, b) if isinstance(a, (tuple, list)) else [(a, b)]
    err = 0.0
    for x, y in pairs:
        if x.shape != y.shape:
            return float("inf")
        if not x.is_floating_point():
            err = max(err, float((x != y).sum()))
            continue
        d = (x.double() - y.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------ phase 3

def _t(a, dev, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def lane_inputs(dev, C, B, slide, kind, seed=0):
    """G1/G3 lane inputs at the main path's shapes. ``main``: one batch of
    the north-star generator that crosses a window boundary, with the
    watermark and purge cursor the executor holds there. ``edge``: data
    that reaches every branch — invalid lanes, late lanes (watermark and
    purge cursor), too-old lanes behind a far-ahead pane, keys past
    capacity or with a nonzero high word, negative ticks."""
    rng = np.random.default_rng(seed)
    if kind == "main":
        offset = WINDOW_MS * EVENTS_PER_MS - B // 2
        keys, ts, vals = gen_batch(offset, B, C)
        hi = np.zeros(B, np.uint32)
        lo = keys.astype(np.uint32)
        valid = np.ones(B, bool)
        wm = int(ts[0]) - 1
        purged = -1
    else:
        hi = np.where(rng.random(B) < 0.01, 1, 0).astype(np.uint32)
        lo = rng.integers(0, C + C // 20, B).astype(np.uint32)
        pane = rng.integers(-2, 3, B)
        pane[rng.random(B) < 0.01] = 7          # drives max_pane ahead
        ts = pane * slide + rng.integers(0, slide, B)
        vals = rng.integers(1, 9, B).astype(np.float32)
        valid = rng.random(B) < 0.95
        wm = slide // 2 - 1 - 2 * slide          # panes <= -2 are late
        purged = -2
    return {
        "hi": _t(hi.view(np.int32), dev, torch.int32),
        "lo": _t(lo.view(np.int32), dev, torch.int32),
        "ts": _t(ts.astype(np.int32), dev, torch.int32),
        "values": _t(vals.astype(np.float32), dev, torch.float32),
        "valid": _t(valid, dev, torch.bool),
        "watermark": torch.tensor(wm, dtype=torch.int32, device=dev),
        "purged_through": torch.tensor(purged, dtype=torch.int32,
                                       device=dev),
    }


def sparse_lane_inputs(dev, B, kind, seed=0):
    """G1/G3 lane inputs at the sparse-key job's shapes (slide 2,000 ticks,
    k = 5, R = 12). ``main``: one batch of its generator that crosses a
    pane boundary past the first window, with the watermark the executor
    holds there. ``edge``: keys the table holds, new keys and the key -1
    (== EMPTY, never placed); invalid lanes; panes -7 .. 3 against a
    watermark in pane 0, so that panes <= -5 are late by the window's
    k-pane test (pane + k - 1 <= watermark pane - 1), panes -4 .. -1 are
    not (they would be at k = 1), and the purge cursor covers -6; 1 % of
    the lanes at pane 10 drive the ring ahead, so that panes <= -2 fall
    behind its 12-pane horizon and drop as too old."""
    rng = np.random.default_rng(seed)
    slide = SPARSE_SLIDE_MS
    if kind == "main":
        offset = 6 * slide * EVENTS_PER_MS - B // 2
        keys, ts, vals = gen_batch(offset, B)
        ids = sparse_ids(keys)
        valid = np.ones(B, bool)
        wm = int(ts[0]) - 1
        purged = -1
    else:
        ids = sparse_ids(rng.integers(0, N_KEYS + N_KEYS // 10, B))
        ids[rng.random(B) < 0.01] = -1
        pane = rng.integers(-7, 4, B)
        pane[rng.random(B) < 0.01] = 10
        ts = pane * slide + rng.integers(0, slide, B)
        vals = rng.integers(1, 9, B).astype(np.float32)
        valid = rng.random(B) < 0.95
        wm = slide // 2 - 1
        purged = -6
    hi, lo = id_halves(ids, dev)
    return {
        "hi": hi, "lo": lo,
        "ts": _t(ts.astype(np.int32), dev, torch.int32),
        "values": _t(vals.astype(np.float32), dev, torch.float32),
        "valid": _t(valid, dev, torch.bool),
        "watermark": torch.tensor(wm, dtype=torch.int32, device=dev),
        "purged_through": torch.tensor(purged, dtype=torch.int32,
                                       device=dev),
    }


def packed_plane(dev, C, R, density, seed=1):
    """A pane plane with integer values and touch counts in a ``density``
    share of the (row, key) cells."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    touch = (torch.rand(R * C, generator=g) < density).float()
    val = torch.randint(1, 9, (R * C,), generator=g).float() * touch
    cnt = touch * torch.randint(1, 4, (R * C,), generator=g)
    return torch.stack([val, cnt], 1).to(dev)


def _zero_i32(dev):
    return torch.zeros((), dtype=torch.int32, device=dev)


def case_route_lanes(inp, C, R, maxp, slide, k=1):
    args = (inp["hi"], inp["lo"], inp["ts"], inp["valid"], inp["watermark"],
            inp["purged_through"])
    kw = dict(slide=slide, k=k, maxp=maxp, kg_start=0, kg_end=maxp - 1)
    B = inp["hi"].shape[0]
    return {
        "got": kernels.route_lanes(*args, **kw),
        "want": kernels.route_lanes_plain(*args, **kw),
        "run": lambda: kernels.route_lanes(*args, **kw),
        "plain": lambda: kernels.route_lanes_plain(*args, **kw),
        "library": None,
        # hi, lo, ts, valid in; pane, kg, live out
        "bytes": B * (4 + 4 + 4 + 1 + 4 + 4 + 1),
    }


def case_scatter_update(inp, C, R, maxp, slide, k=1, table=None):
    """The direct layout's lanes (a sum) when ``table`` is None; else the
    hash layout's (a count) with the slots G5 gives them in a copy of
    ``table``, C for a lane that found none, as the sparse job's update
    does: only lanes inside the ring's horizon look up or claim."""
    pane, kg, live, stats = kernels.route_lanes_plain(
        inp["hi"], inp["lo"], inp["ts"], inp["valid"], inp["watermark"],
        inp["purged_through"], slide=slide, k=k, maxp=maxp, kg_start=0,
        kg_end=maxp - 1)
    dev = pane.device
    max_pane = torch.maximum(torch.tensor(PANE_NONE, dtype=torch.int32,
                                          device=dev), stats[1])
    acc0 = packed_plane(dev, C, R, 0.5)
    a1, a2 = acc0.clone(), acc0.clone()
    dirty1 = torch.zeros(maxp, dtype=torch.bool, device=dev)
    dirty2 = dirty1.clone()
    d1, d2 = _zero_i32(dev), _zero_i32(dev)
    hi, lo = inp["hi"], inp["lo"]
    if table is None:
        # the direct layout's slot: the key where it fits [0, C), else none
        slot = torch.where((hi == 0) & (lo >= 0) & (lo < C), lo, C)
        values = inp["values"]
    else:
        inside = live & (pane >= max_pane - (R - 1))
        slot, _ok, _n = kernels.hash_upsert(table.clone(), hi, lo, inside,
                                            probe_len=PROBE_LEN)
        values = None
    lanes = (pane, kg, live, slot, values, max_pane)
    kernels.scatter_update(a1, dirty1, d1, *lanes, C=C, R=R)
    kernels.scatter_update_plain(a2, dirty2, d2, *lanes, C=C, R=R)
    ok = live & (pane >= max_pane - (R - 1)) & (slot < C)
    idx = 2 * (torch.remainder(pane.long(), R) * C + slot.long())[ok]
    lib_idx = torch.cat([idx, idx + 1])
    ones = torch.ones(int(ok.sum()), device=dev)
    lib_val = torch.cat([ones if values is None else values[ok], ones])
    B = pane.shape[0]
    return {
        "got": (a1, dirty1, d1), "want": (a2, dirty2, d2),
        "run": lambda: kernels.scatter_update(a1, dirty1, d1, *lanes, C=C,
                                              R=R),
        "plain": lambda: kernels.scatter_update_plain(a2, dirty2, d2,
                                                      *lanes, C=C, R=R),
        # the same value + marker scatter in one call (no drop counting)
        "library": lambda: a2.view(-1).index_add_(0, lib_idx, lib_val),
        # pane, kg, live, slot, values in; each touched (value, marker)
        # cell read and written once
        "bytes": B * (4 + 4 + 1 + 4 + (4 if values is not None else 0))
        + int(torch.unique(idx).numel()) * 8 * 2,
    }


def case_clear_rows(dev, C, R, kind):
    """``main``: a pane crossing registers one new ring row (stale, not
    evicted). ``edge``: two rows, one of them evicted with unfired data."""
    acc0 = packed_plane(dev, C, R, 0.9)
    clear = torch.zeros(R, dtype=torch.bool, device=dev)
    evicted = torch.zeros(R, dtype=torch.bool, device=dev)
    clear[1] = True
    if kind == "edge":
        clear[5] = evicted[5] = True
    rows = clear.nonzero().reshape(-1)
    a1, a2 = acc0.clone(), acc0.clone()
    d1, d2 = _zero_i32(dev), _zero_i32(dev)
    kernels.clear_rows(a1, clear, evicted, d1, C=C, R=R)
    kernels.clear_rows_plain(a2, clear, evicted, d2, C=C, R=R)
    return {
        "got": (a1, d1), "want": (a2, d2),
        "run": lambda: kernels.clear_rows(a1, clear, evicted, d1, C=C, R=R),
        "plain": lambda: kernels.clear_rows_plain(a2, clear, evicted, d2,
                                                  C=C, R=R),
        # the same row clear in one call (no eviction count)
        "library": lambda: a2.view(R, C * 2).index_fill_(0, rows, 0.0),
        # flagged rows written, evicted rows' touch column read, masks read
        "bytes": int(clear.sum()) * C * 8 + int(evicted.sum()) * C * 4
        + 2 * R,
    }


def case_fire_reduced(dev, C, R, F, kind):
    """``main``: a tumbling boundary, one due lane of F. ``edge``: a
    sliding window (k = 2), two due lanes, one of them missing a pane."""
    acc0 = packed_plane(dev, C, R, 0.99)
    k = 1 if kind == "main" else 2
    pane_ids = torch.full((R,), PANE_NONE, dtype=torch.int32, device=dev)
    for q in (40, 41, 42):
        pane_ids[q % R] = q
    ends = [41, 42] if kind == "main" else [42, 44]
    p_f = torch.tensor((ends * F)[:F], dtype=torch.int32, device=dev)
    lane_ok = torch.zeros(F, dtype=torch.bool, device=dev)
    lane_ok[: 1 if kind == "main" else 2] = True
    args = (acc0, pane_ids, p_f, lane_ok)
    n_rows = int(sum(
        int(pane_ids[(int(p) - j) % R]) == int(p) - j
        for p, ok in zip(p_f.tolist(), lane_ok.tolist()) if ok
        for j in range(k)))
    due_row = acc0.view(R, C, 2)[ends[0] % R]
    return {
        "got": kernels.fire_reduced(*args, C=C, R=R, k=k),
        "want": kernels.fire_reduced_plain(*args, C=C, R=R, k=k),
        "run": lambda: kernels.fire_reduced(*args, C=C, R=R, k=k),
        "plain": lambda: kernels.fire_reduced_plain(*args, C=C, R=R, k=k),
        "args": args,
        "library": None,
        # a yardstick for the W = 1 read, a part only: one Tensor.sum over
        # the due row's [C, 2] plane (no touch test, no count)
        "yardsticks": {"read_sum": lambda: due_row.sum()},
        # each present row of each due lane read once, pane_ids, lane outs
        "bytes": n_rows * C * 8 + R * 4 + F * (4 + 1 + 4 + 4),
    }


# ------------------------------------------------- phase 3, G5 and G6

def sparse_ids(keys: np.ndarray) -> np.ndarray:
    """The sparse-key job's fixed bijection: dense key -> 64-bit id."""
    return splitmix64(keys).view(np.int64)


def id_halves(ids: np.ndarray, dev):
    w = np.ascontiguousarray(ids).view(np.uint64)
    hi = (w >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return _t(hi, dev, torch.int32), _t(lo, dev, torch.int32)


def wrapping_ids(C, n, seed):
    """ids whose probe chain starts within PROBE_LEN - 1 slots of the end,
    so that it wraps at C."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        ids = rng.integers(-(2**62), 2**62, 1 << 20, dtype=np.int64)
        w = ids.view(np.uint64)
        base = probe_hash((w >> np.uint64(32)).astype(np.uint32),
                          (w & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        out.extend(ids[(base & np.uint32(C - 1)) > C - PROBE_LEN].tolist())
    return np.array(out[:n], np.int64)


def table_invariants(table, C, probe_len=PROBE_LEN) -> None:
    """Each key once, within ``probe_len`` of its chain's start, where
    lookup finds it."""
    used = table != EMPTY_WORD
    words = table[used]
    check(torch.unique(words).numel() == words.numel(),
          "a table holds a key twice")
    hi, lo = kernels.split_words(words)
    slot, found = hashtable.lookup(table, hi, lo, probe_len=probe_len)
    check(bool(found.all()), "lookup misses a placed key")
    check(bool((slot.long() == torch.nonzero(used).reshape(-1)).all()),
          "lookup finds a key at another slot than the one it holds")
    base = probe_hash(hi, lo) & (C - 1)
    check(bool(((slot.long() - base) % C < probe_len).all()),
          "a key sits outside its probe chain")


def keyed_columns(table, acc, C, R):
    """The plane's [R, 2] column of every used slot, ordered by key word."""
    used = torch.nonzero(table != EMPTY_WORD).reshape(-1)
    order = torch.argsort(table[used])
    return table[used][order], acc.view(R, C, 2)[:, used[order]]


def full_table(dev, C, B, report=True):
    """The sparse job's table once every key has arrived: the 1M ids at a
    load of 0.48, placed by G5. With ``report``, emits how deep the keys
    sit in their probe chains: a key at depth d needs a chain longer than
    d."""
    table = hashtable.create(C, dev)
    for off in range(0, N_KEYS, B):
        h, l = id_halves(sparse_ids(np.arange(off, min(off + B, N_KEYS))),
                         dev)
        kernels.hash_upsert(table, h, l, torch.ones_like(h, dtype=torch.bool),
                            probe_len=PROBE_LEN)
    if not report:
        return table
    used = torch.nonzero(table != EMPTY_WORD).reshape(-1)
    hi, lo = kernels.split_words(table[used])
    depth = (used - (probe_hash(hi, lo) & (C - 1))) % C
    emit({"phase": "hash_table", "keys": int(used.numel()),
          "load": used.numel() / C, "probe_len": PROBE_LEN,
          "max_depth": int(depth.max()),
          "keys_at_depth_16_or_more": int((depth >= 16).sum()),
          "keys_at_depth_32_or_more": int((depth >= 32).sum())})
    return table


def case_hash_upsert(dev, C, B, kind, full):
    """``main``: checked on the sparse job's first batch into an empty table
    (every lane claims); timed on a later batch against the full table, the
    steady state of the job (every key resident, load 0.48). ``edge``: a
    table at a load of 0.24, lanes of the key -1 (== EMPTY), duplicate-heavy
    lanes, chains that wrap at C, invalid lanes. ``full``: the table of
    full_table."""
    rng = np.random.default_rng(7)
    table0 = hashtable.create(C, dev)
    if kind == "main":
        ids = sparse_ids(gen_batch(0, B)[0])
        valid = np.ones(B, bool)
    else:
        pre = sparse_ids(np.arange(N_KEYS // 2, dtype=np.int64))
        for off in range(0, len(pre), B):
            h, l = id_halves(pre[off:off + B], dev)
            kernels.hash_upsert_plain(
                table0, h, l, torch.ones_like(h, dtype=torch.bool),
                probe_len=PROBE_LEN)
        ids = sparse_ids(rng.integers(0, N_KEYS, B))
        ids[:4096] = sparse_ids(rng.integers(0, 16, 4096))  # duplicates
        ids[4096:4160] = wrapping_ids(C, 4, 3).repeat(16)
        ids[rng.random(B) < 0.01] = -1
        valid = rng.random(B) < 0.95
    hi, lo = id_halves(ids, dev)
    valid_t = _t(valid, dev, torch.bool)
    t1, t2 = table0.clone(), table0.clone()
    s1, ok1, n1 = kernels.hash_upsert(t1, hi, lo, valid_t,
                                      probe_len=PROBE_LEN)
    s2, ok2, n2 = kernels.hash_upsert_plain(t2, hi, lo, valid_t,
                                            probe_len=PROBE_LEN)
    # the set invariants
    check(bool((ok1 == ok2).all()), "hash_upsert: ok differs")
    check(int(n1) == int(n2), f"hash_upsert: n_new {int(n1)} != {int(n2)}")
    check(bool((s1[~ok1] == C).all()), "hash_upsert: a failed lane has a slot")
    check(bool((torch.sort(t1).values == torch.sort(t2).values).all()),
          "hash_upsert: the tables hold other keys")
    table_invariants(t1, C)
    key = kernels.key_words(hi, lo)
    check(bool((t1[s1[ok1].long()] == key[ok1]).all()),
          "hash_upsert: a lane's slot holds another key")
    check(not bool(ok1[key == EMPTY_WORD].any()), "the key -1 was placed")
    # equal per-key values after a G3 pass over each version's slots: the
    # kernels' (G5 then G3) against the plain versions'
    R = SPARSE_RING
    pane = torch.zeros(B, dtype=torch.int32, device=dev)
    kg = torch.zeros(B, dtype=torch.int32, device=dev)
    vals = _t(rng.integers(1, 9, B).astype(np.float32), dev, torch.float32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    planes = []
    for table, slot, g3 in ((t1, s1, kernels.scatter_update),
                            (t2, s2, kernels.scatter_update_plain)):
        acc = torch.zeros(C * R, 2, device=dev)
        g3(acc, None, _zero_i32(dev), pane, kg, valid_t, slot, vals, zero,
           C=C, R=R)
        planes.append(keyed_columns(table, acc, C, R))
    err = max_abs_err(planes[0][1], planes[1][1])
    check(bool((planes[0][0] == planes[1][0]).all()) and err == 0.0,
          f"hash_upsert: per-key values differ after G3 (err {err})")
    # the timing: the main path's steady state, every key in the table
    if kind == "main":
        t1 = full.clone()
        t2 = full.clone()
        hi, lo = id_halves(sparse_ids(gen_batch(5 * B, B)[0]), dev)
    s_run, ok_run, n_run = kernels.hash_upsert(t1, hi, lo, valid_t,
                                               probe_len=PROBE_LEN)
    check(kind != "main" or (bool(ok_run.all()) and int(n_run) == 0),
          "hash_upsert: a key of the full table went missing")
    cand = kernels.probe_chain(hi, lo, C=C, probe_len=PROBE_LEN)
    depth = (s_run.long() - cand[:, 0]) % C
    on_chain = ok_run[:, None] & (
        torch.arange(PROBE_LEN, device=dev)[None, :] <= depth[:, None])
    n_words = int(torch.unique(cand[on_chain]).numel())
    return {
        "err": max(err, float((ok1 != ok2).sum()), abs(int(n1) - int(n2))),
        "run": lambda: kernels.hash_upsert(t1, hi, lo, valid_t,
                                           probe_len=PROBE_LEN),
        "plain": lambda: kernels.hash_upsert_plain(t2, hi, lo, valid_t,
                                                   probe_len=PROBE_LEN),
        "library": None,
        # hi, lo, valid in; slot, ok out; each table word on a chain up to
        # its key read once
        "bytes": B * (4 + 4 + 1 + 4 + 1) + n_words * 8,
    }


def case_fire_compact(dev, C, kind, table):
    """``main``: the sparse job's fire — one due lane of F = 2, a k = 5
    window over a hash table of 1M keys, 98 % of them touched in each pane.
    ``edge``: the direct layout's identity table, two due lanes, one of
    them missing a pane, 30 % touched."""
    R, k, F = SPARSE_RING, SPARSE_SIZE_MS // SPARSE_SLIDE_MS, FIRES_PER_STEP
    pane_ids = torch.tensor([q for q in range(40, 40 + R)],
                            dtype=torch.int32, device=dev)
    pane_ids = pane_ids[torch.argsort(torch.remainder(pane_ids, R))]
    g = torch.Generator(device="cpu").manual_seed(5)
    if kind == "main":
        density, ends, n_due = 0.98, [48, 49], 1
        used = (table != EMPTY_WORD).cpu()
    else:
        table = torch.arange(C, dtype=torch.int64, device=dev)
        density, ends, n_due = 0.3, [48, 50], 2
        used = torch.ones(C, dtype=torch.bool)
        pane_ids[46 % R] = PANE_NONE
    touch = (torch.rand(R, C, generator=g) < density) & used[None, :]
    val = torch.randint(1, 9, (R, C), generator=g).float() * touch
    acc = torch.stack([val.reshape(-1), touch.reshape(-1).float()], 1).to(dev)
    p_f = torch.tensor(ends, dtype=torch.int32, device=dev)
    lane_ok = torch.tensor([f < n_due for f in range(F)], device=dev)
    args = (acc, pane_ids, p_f, lane_ok, table)
    rows1 = tuple(torch.empty(F, C, dtype=d, device=dev)
                  for d in (torch.int32, torch.int32, torch.float32))
    rows2 = tuple(torch.empty_like(r) for r in rows1)
    c1, v1 = kernels.fire_compact(*args, *rows1, C=C, R=R, k=k)
    c2, v2 = kernels.fire_compact_plain(*args, *rows2, C=C, R=R, k=k)
    got, want = [c1, v1], [c2, v2]
    for f in range(F):
        n = int(c2[f])
        got += [r[f, :n] for r in rows1]
        want += [r[f, :n] for r in rows2]
    # the library yardsticks: the compaction alone, of the due lane's
    # precomputed dense emit mask and (hi, lo, value) payload, as one call
    # (masked_select) and as nonzero + index_select
    emit, vals = kernels._eval_fire_lanes_plain(acc, pane_ids, p_f, lane_ok,
                                                C=C, R=R, k=k)
    hi, lo = kernels.split_words(table)
    payload = torch.stack([hi, lo, vals[0, :, 0].view(torch.int32)], 1)
    mask0 = emit[0]
    keep0 = mask0[:, None]
    n_rows = int(c2.sum())
    n_present = sum(int(pane_ids[(e - j) % R]) == e - j
                    for e, ok in zip(ends, lane_ok.tolist()) if ok
                    for j in range(k))
    return {
        "got": got, "want": want,
        "run": lambda: kernels.fire_compact(*args, *rows1, C=C, R=R, k=k),
        "plain": lambda: kernels.fire_compact_plain(*args, *rows2, C=C, R=R,
                                                    k=k),
        "library": lambda: torch.masked_select(payload, keep0),
        "yardsticks": {"nonzero_index_select": lambda: payload.index_select(
            0, torch.nonzero(mask0).reshape(-1))},
        # each present row of each due lane read once, the key word of each
        # emitted slot, 12 B per emitted row written, pane_ids, lane outs
        "bytes": n_present * C * 8 + n_rows * (8 + 12) + R * 4
        + F * (4 + 1 + 4 + 4),
    }


# ------------------------------------------------- phase 3, G7-G9

def ring_of(dev, O, fill, seed=9):
    """An overflow ring of O lanes holding ``fill`` earlier lanes."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ring = (torch.randint(-2**31, 2**31 - 1, (O,), generator=g,
                          dtype=torch.int32),
            torch.randint(-2**31, 2**31 - 1, (O,), generator=g,
                          dtype=torch.int32),
            torch.randint(-5, 20, (O,), generator=g, dtype=torch.int32),
            torch.randint(1, 9, (O,), generator=g).float(),
            torch.tensor(fill, dtype=torch.int32))
    return tuple(t.to(dev) for t in ring)


def clone_ring(ring):
    return tuple(t.clone() for t in ring)


def case_ring_append(dev, B, kind):
    """``main``: the ring at the jobs' auto size (RING_LANES) after a few
    drains, 1 % of a batch's lanes with no slot, a count. ``edge``: a ring
    of B/2 lanes 3/4 full and half the lanes masked, a sum: the ring fills,
    and the lanes past it are lost and counted."""
    g = torch.Generator(device="cpu").manual_seed(3)
    share, O, fill, count = ((0.01, RING_LANES, 40_000, True) if kind == "main"
                             else (0.5, B // 2, 3 * B // 8, False))
    mask = (torch.rand(B, generator=g) < share).to(dev)
    hi, lo = (torch.randint(-2**31, 2**31 - 1, (B,), generator=g,
                            dtype=torch.int32).to(dev) for _ in range(2))
    pane = torch.randint(0, 15, (B,), generator=g, dtype=torch.int32).to(dev)
    vals = None if count else torch.randint(1, 9, (B,), generator=g).float(
    ).to(dev)
    ring0 = ring_of(dev, O, fill)
    r1, r2 = clone_ring(ring0), clone_ring(ring0)
    l1, l2 = _zero_i32(dev), _zero_i32(dev)
    kernels.ring_append(r1, l1, mask, hi, lo, pane, vals)
    kernels.ring_append_plain(r2, l2, mask, hi, lo, pane, vals)
    n = int(mask.sum())
    check(kind == "main" or int(l1) == fill + n - O,
          f"ring_append: {int(l1)} lanes lost, not {fill + n - O}")
    lanes = torch.stack([hi, lo, pane, (vals if vals is not None else
                                        torch.ones(B, device=dev)).view(
                                            torch.int32)], 1)
    # the timing appends to a copy; the ring stays far from full
    rt, lt = clone_ring(ring0), _zero_i32(dev)
    rp, lp = clone_ring(ring0), _zero_i32(dev)
    return {
        "got": list(r1) + [l1], "want": list(r2) + [l2],
        "run": lambda: kernels.ring_append(rt, lt, mask, hi, lo, pane,
                                           vals),
        "plain": lambda: kernels.ring_append_plain(rp, lp, mask, hi, lo,
                                                   pane, vals),
        # the compaction of the masked lanes' four words, in lane order
        "library": lambda: torch.masked_select(lanes, mask[:, None]),
        # the mask read once, each taken lane read and written (16 B each)
        "bytes": B * 1 + n * (16 + 16) + 8,
    }


def case_remove_slots(dev, kind):
    """G28 against its plain version, bit for bit. ``main``: a table of 2^21
    random key words (the sparse job's capacity), about half its slots
    cleared by 2^20 lanes of distinct int32 slots. ``edge``: 2^16 lanes,
    a third masked off, slots past C, below -C and in [-C, 0) (which count
    from the end, as the reference's indexing wraps them), a quarter of
    the lanes repeating others' slots, as int32 and as int64 slots; and no
    lane at all. The library time: index_fill_ of the cleared slots."""
    C = SPARSE_CAPACITY
    g = torch.Generator().manual_seed(28)
    table = torch.randint(-2**62, 2**62, (C,), generator=g,
                          dtype=torch.int64).to(dev)
    if kind == "main":
        B = C // 2
        slots = torch.randperm(C, generator=g)[:B].to(torch.int32).to(dev)
        mask = torch.ones(B, dtype=torch.bool, device=dev)
        runs = [(slots, mask)]
    else:
        B = 1 << 16
        s64 = torch.randint(-C - 100, C + 100, (B,), generator=g)
        s64[:B // 4] = s64[B // 4:B // 2]
        mask = (torch.rand(B, generator=g) < 0.67).to(dev)
        s64 = s64.to(dev)
        runs = [(s64.to(torch.int32), mask), (s64, mask),
                (s64[:0].to(torch.int32), mask[:0])]
    err = 0.0
    for sl, m in runs:
        t1, t2 = table.clone(), table.clone()
        kernels.remove_slots(t1, sl, m)
        kernels.remove_slots_plain(t2, sl, m)
        err += bits_err(t1, t2)
    sl, m = runs[0]
    if kind == "main":
        cleared = int((t1 != table).sum())
        check(cleared == B, f"remove_slots: {cleared} slots cleared, not {B}")
    at = sl.long()
    at = torch.where(at < 0, at + C, at)
    fill = at[m & (at >= 0) & (at < C)]
    tk, tp, tl = table.clone(), table.clone(), table.clone()
    return {
        "err": err,
        "run": lambda: kernels.remove_slots(tk, sl, m),
        "plain": lambda: kernels.remove_slots_plain(tp, sl, m),
        "library": lambda: tl.index_fill_(0, fill, EMPTY_WORD),
        # a lane's slot and mask read, each cleared word written
        "bytes": sl.numel() * (sl.element_size() + 1) + fill.numel() * 8,
    }


def full_to_the_brim(dev, C, B):
    """A table with no free slot: G5 places fresh ids until every slot is
    taken (each chain full, so an absent key walks all 64 slots)."""
    table = hashtable.create(C, dev)
    off = 50 * N_KEYS
    for _ in range(40):
        if not bool((table == EMPTY_WORD).any()):
            return table
        h, l = id_halves(sparse_ids(np.arange(off, off + B)), dev)
        off += B
        kernels.hash_upsert(table, h, l, torch.ones_like(h, dtype=torch.bool),
                            probe_len=PROBE_LEN)
    raise RuntimeError("the table kept a free slot")


def case_hash_lookup(dev, C, B, kind, full):
    """``main``: the sparse job's fast step, a batch of its generator
    against the full table of full_table (every key present). ``edge``: a
    table with no free slot, lanes of present keys, absent keys, the key
    -1 and invalid lanes."""
    rng = np.random.default_rng(12)
    if kind == "main":
        table = full
        ids = sparse_ids(gen_batch(7 * B, B)[0])
        valid = np.ones(B, bool)
    else:
        table = full_to_the_brim(dev, C, B)
        words = table.cpu().numpy()
        ids = np.where(rng.random(B) < 0.5, words[rng.integers(0, C, B)],
                       sparse_ids(rng.integers(90 * N_KEYS, 91 * N_KEYS, B)))
        ids[rng.random(B) < 0.01] = -1
        valid = rng.random(B) < 0.95
    hi, lo = id_halves(ids, dev)
    valid_t = _t(valid, dev, torch.bool)
    got = kernels.hash_lookup(table, hi, lo, valid_t, probe_len=PROBE_LEN)
    want = kernels.hash_lookup_plain(table, hi, lo, valid_t,
                                     probe_len=PROBE_LEN)
    check(kind == "edge" or int(got[2]) == 0,
          "hash_lookup: a key of the full table went missing")
    check(kind == "main" or 0 < int(got[2]) < B,
          "hash_lookup: the edge batch found all or none of its keys")
    # each table word on a chain up to the key (or the whole chain of an
    # absent key on the brimful table) read once
    slot = got[0].long()
    cand = kernels.probe_chain(hi, lo, C=C, probe_len=PROBE_LEN)
    depth = torch.where(got[1], (slot - cand[:, 0]) % C, PROBE_LEN - 1)
    on_chain = valid_t[:, None] & (
        torch.arange(PROBE_LEN, device=dev)[None, :] <= depth[:, None])
    return {
        "got": got, "want": want,
        "run": lambda: kernels.hash_lookup(table, hi, lo, valid_t,
                                           probe_len=PROBE_LEN),
        "plain": lambda: kernels.hash_lookup_plain(table, hi, lo, valid_t,
                                                   probe_len=PROBE_LEN),
        "library": None,
        # hi, lo, valid in; slot, found out; each chain word read once
        "bytes": B * (4 + 4 + 1 + 4 + 1)
        + int(torch.unique(cand[on_chain]).numel()) * 8,
    }


def churned_state(dev, C, R, probe_len, n_keys, alive_share, seed):
    """A hash table as the churn job holds it before a compaction: G5
    placed ``n_keys`` ids (those past their chains left out), and a plane
    in which ``alive_share`` of the placed keys have touched cells in some
    of the R rows while the rest are dead. Returns (table, acc, pane_ids,
    alive bool [C])."""
    table = hashtable.create(C, dev)
    for off in range(0, n_keys, 1 << 18):
        n = min(1 << 18, n_keys - off)
        h, l = id_halves(sparse_ids(np.arange(off, off + n) + seed * 10**9),
                         dev)
        kernels.hash_upsert(table, h, l, torch.ones_like(h, dtype=torch.bool),
                            probe_len=probe_len)
    g = torch.Generator(device="cpu").manual_seed(seed)
    used = (table != EMPTY_WORD).cpu()
    alive = used & (torch.rand(C, generator=g) < alive_share)
    touch = (torch.rand(R, C, generator=g) < 0.45) & alive[None, :]
    touch[torch.randint(0, R, (C,), generator=g), torch.arange(C)] |= alive
    val = torch.randint(1, 9, (R, C), generator=g).float() * touch
    acc = torch.stack([val.reshape(-1), touch.reshape(-1).float()], 1)
    pane_ids = torch.arange(40, 40 + R, dtype=torch.int32)
    pane_ids = pane_ids[torch.argsort(torch.remainder(pane_ids, R))]
    return table, acc.to(dev), pane_ids.to(dev), alive.to(dev)


def logical_cells(table, acc, ring, C, R, pane_ids, neutral=0.0):
    """The (key word, pane, W values) cells of a plane [C*R, W + 1] (touch
    column != ``neutral``) and the filled ring lanes, sorted by key then
    pane, as three tensors."""
    Wc = acc.shape[1]
    a3 = acc.view(R, C, Wc)
    r, c = torch.nonzero(a3[:, :, -1] != neutral, as_tuple=True)
    n = int(ring[4])
    keys = torch.cat([table[c], kernels.key_words(ring[0][:n], ring[1][:n])])
    panes = torch.cat([pane_ids[r], ring[2][:n]])
    vals = torch.cat([a3[r, c, :-1], ring[3][:n].reshape(n, Wc - 1)])
    order = torch.argsort(panes, stable=True)
    order = order[torch.argsort(keys[order], stable=True)]
    return keys[order], panes[order], vals[order]


def case_compact_table(dev, C, R, kind):
    """``main``: the churn job's compaction, 2^21 slots probed 64 deep that
    G5 filled with 1.9M ids, 70 % of them alive, the rest dead.
    ``edge``: the same table 80 % alive, rebuilt with chains 2 slots long,
    so that thousands of alive keys find no slot in the new table and move
    to the ring. Held to:
    the new table's set invariants; alive keys = placed + exported, once
    each; the move equal to the plain move on G9's own slot map, the ring
    equal to the plain export on it; and the same logical cells (plane +
    ring) as the plain version, whichever keys each placed."""
    probe, share = (PROBE_LEN, 0.7) if kind == "main" else (2, 0.8)
    table, acc, pane_ids, alive = churned_state(dev, C, R, PROBE_LEN,
                                                1_900_000, share, 4)
    ring0 = ring_of(dev, RING_LANES, 1000)
    r1, r2 = clone_ring(ring0), clone_ring(ring0)
    l1, l2 = _zero_i32(dev), _zero_i32(dev)
    acc1, tab1, slot1, ok1 = kernels.compact_table(acc, table, pane_ids, r1,
                                                   l1, R=R, probe_len=probe)
    acc2, tab2, _slot2, _ok2 = kernels.compact_table_plain(
        acc, table, pane_ids, r2, l2, R=R, probe_len=probe)
    placed = tab1 != EMPTY_WORD
    check(int(placed.sum()) == int(ok1.sum()),
          "compact_table: the new table holds other keys than it placed")
    table_invariants(tab1, C, probe)
    check(bool((ok1 <= alive).all()), "compact_table: placed a dead key")
    check(bool((torch.sort(tab1[placed]).values
                == torch.sort(table[ok1]).values).all()),
          "compact_table: the placed keys are not the ok slots' keys")
    exported = int(r1[4]) - int(ring0[4])
    want_moved = kernels.compact_move_plain(acc, slot1, ok1, C=C, R=R)
    r3, l3 = clone_ring(ring0), _zero_i32(dev)
    kernels.compact_export_plain(acc, table, pane_ids, alive, ok1, r3, l3,
                                 C=C, R=R)
    check(kind == "main" or exported > 0,
          "compact_table: no alive key failed in the edge table")
    cells1 = logical_cells(tab1, acc1, r1, C, R, pane_ids)
    cells2 = logical_cells(tab2, acc2, r2, C, R, pane_ids)
    # the library yardstick: the move alone, as one index_copy_ of the
    # alive keys' precomputed columns into a cleared plane
    src = acc.view(R, C, 2)[:, ok1]
    dst_idx = slot1[ok1].long()
    lib_out = torch.zeros(R, C, 2, device=dev)
    # the timed calls share one ring: the main table exports nothing
    ring_t, lost_t = clone_ring(ring0), _zero_i32(dev)
    return {
        "got": [acc1, *r1, l1, *cells1], "want": [want_moved, *r3, l3,
                                                  *cells2],
        "run": lambda: kernels.compact_table(
            acc, table, pane_ids, ring_t, lost_t, R=R, probe_len=probe),
        "plain": lambda: kernels.compact_table_plain(
            acc, table, pane_ids, ring_t, lost_t, R=R, probe_len=probe),
        "library": lambda: lib_out.index_copy_(1, dst_idx, src),
        # the plane and the table read once; the new plane and the new
        # table written once; 16 B per exported ring lane
        "bytes": C * R * 8 * 2 + C * 8 * 2 + exported * 16,
        "exported": exported,
    }


def op_split(dev, calls) -> dict:
    """Each device operation that one call makes, by torch.profiler over
    ``calls`` (one call's closures, all alike): {name: [operations a call,
    device us a call]}, kernels, memsets and copies alike."""
    from torch.profiler import ProfilerActivity, profile as profiler

    if dev.type != "cuda":
        return {}
    torch.cuda.synchronize()
    with profiler(activities=[ProfilerActivity.CUDA]) as prof:
        for run in calls:
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rec = out.setdefault(e.name[:70], [0.0, 0.0])
        rec[0] += 1.0 / len(calls)
        rec[1] += e.time_range.elapsed_us() / len(calls)
    return out


def ops_a_call(dev, calls, tries=3) -> dict:
    """op_split of ``calls``, taken again when the profiler recorded no
    device operation (a capture that comes back empty now and then); {}
    when it never records one."""
    for _ in range(tries):
        ops = op_split(dev, calls)
        if ops:
            return ops
    return {}


_GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType


def graph_ops(dev, run) -> dict:
    """The device operations that one call of ``run`` enqueues, by kind
    ({"kernel": n, "memset": n, "memcpy": n, "other": n}): the call is
    captured into a CUDA graph on a side stream (relaxed mode, after one
    call there that sets up its scratch and allocations; the captured
    kernels never run) and the graph's nodes are counted by libcuda's
    cuGraphGetNodes and cuGraphNodeGetType. Unlike a profiler's capture
    it cannot come back empty: a failed capture raises."""
    cu = ctypes.CDLL("libcuda.so.1")
    vp, ref = ctypes.c_void_p, ctypes.byref
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        run()
    s.synchronize()
    graph = vp()
    with torch.cuda.stream(s):
        rc = cu.cuStreamBeginCapture_v2(vp(s.cuda_stream), ctypes.c_int(2))
        check(rc == 0, f"graph_ops: stream capture failed to begin ({rc})")
        try:
            run()
        finally:
            rc = cu.cuStreamEndCapture(vp(s.cuda_stream), ref(graph))
    check(rc == 0 and graph.value,
          f"graph_ops: stream capture failed ({rc})")
    out = {"kernel": 0, "memset": 0, "memcpy": 0, "other": 0}
    try:
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(graph, None, ref(n)) == 0,
              "graph_ops: cuGraphGetNodes failed")
        nodes = (vp * n.value)()
        check(cu.cuGraphGetNodes(graph, nodes, ref(n)) == 0,
              "graph_ops: cuGraphGetNodes failed")
        for node in nodes:
            t = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(vp(node), ref(t)) == 0,
                  "graph_ops: cuGraphNodeGetType failed")
            out[_GRAPH_NODE_KINDS.get(t.value, "other")] += 1
    finally:
        cu.cuGraphDestroy(graph)
    torch.cuda.current_stream(dev).wait_stream(s)
    return out


def table_op_split(dev, B=BATCH, reps=8) -> dict:
    """The device operations of G5, G8 and G9 at their main shapes, each
    with its device time (op_split), beside the call's time_ms: G5 in the
    sparse job's steady state (every key resident) and cold (its first
    batch into an empty table, every lane claiming), G5 and G8 on a batch
    of absent keys (every chain read to its end), G8 on the sparse job's
    fast step, G9 at the churn job's compaction on a sum and a max plane.
    """
    C, R = SPARSE_CAPACITY, SPARSE_RING
    full = full_table(dev, C, B, report=False)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    steady = id_halves(sparse_ids(gen_batch(5 * B, B)[0]), dev)
    first = id_halves(sparse_ids(gen_batch(0, B)[0]), dev)
    absent = id_halves(sparse_ids(np.arange(B) + 90 * N_KEYS), dev)
    colds = [hashtable.create(C, dev) for _ in range(reps + 24)]
    table, acc, pane_ids, _alive = churned_state(dev, C, R, PROBE_LEN,
                                                 1_900_000, 0.7, 4)
    touched = acc[:, 1] != 0
    acc_max = torch.where(touched[:, None], torch.stack(
        [acc[:, 0] - 4.5, torch.zeros_like(acc[:, 0])], 1), -FLT_MAX)
    ring, lost = ring_of(dev, RING_LANES, 1000), _zero_i32(dev)

    def upsert(t, hl):
        return lambda: kernels.hash_upsert(t, *hl, ones, probe_len=PROBE_LEN)

    def lookup(hl):
        return lambda: kernels.hash_lookup(full, *hl, ones,
                                           probe_len=PROBE_LEN)

    def compact(a, neutral):
        return lambda: kernels.compact_table(a, table, pane_ids, ring, lost,
                                             R=R, probe_len=PROBE_LEN,
                                             neutral=neutral)

    cold_iter = iter(colds)
    runs = {
        "hash_upsert steady": upsert(full.clone(), steady),
        "hash_upsert cold": lambda: kernels.hash_upsert(
            next(cold_iter), *first, ones, probe_len=PROBE_LEN),
        "hash_upsert absent, brimful table": upsert(
            full_to_the_brim(dev, C, B), absent),
        "hash_lookup steady": lookup(steady),
        "hash_lookup absent": lookup(absent),
        "compact_table sum": compact(acc, 0.0),
        "compact_table max": compact(acc_max, -FLT_MAX),
    }
    out = {}
    for name, run in runs.items():
        ms = time_ms(run)
        out[name] = {"ms": ms, "ops": op_split(dev, [run] * reps)}
    check(int(ring[4]) == 1000 and int(lost) == 0,
          "compact_table exported cells at the churn job's main shape")
    return out


EDGE_DEPTHS = (0, 15, 16, 17, 31, 32, 33, 63)
EDGE_C = 1 << 12


def chain_starts(ids: np.ndarray, C: int) -> np.ndarray:
    w = ids.view(np.uint64)
    return probe_hash((w >> np.uint64(32)).astype(np.uint32),
                      (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                      ) & np.uint32(C - 1)


def ids_at(C: int, bases, per: int, seed: int) -> dict:
    """``per`` distinct ids whose chains start at each of ``bases``."""
    rng = np.random.default_rng(seed)
    out = {int(b): [] for b in bases}
    while any(len(v) < per for v in out.values()):
        ids = rng.integers(-(2**62), 2**62, 1 << 20, dtype=np.int64)
        starts = chain_starts(ids, C)
        for b, v in out.items():
            if len(v) < per:
                v.extend(ids[starts == b][:per - len(v)].tolist())
    return out


def depth_chains(C, regions, seed):
    """A table holding, for each (base, depth) of ``regions``, a key whose
    chain starts at base and that sits ``depth`` deep behind other keys,
    and a second key of that base that is absent. Returns (table words,
    the present keys, the absent keys)."""
    rng = np.random.default_rng(seed)
    found = ids_at(C, [b for b, _ in regions], 2, seed)
    table = np.full(C, -1, np.int64)
    fillers = rng.integers(1, 2**62, C, dtype=np.int64)
    present, absent = [], []
    for b, d in regions:
        for j in range(d):
            table[(b + j) % C] = fillers[(b + j) % C]
        table[(b + d) % C] = found[b][0]
        present.append(found[b][0])
        absent.append(found[b][1])
    return table, np.array(present), np.array(absent)


def edge_lanes(present, absent, seed, n_extra=0, pool=None):
    """Lanes of present keys, absent keys twice (duplicates), a few of the
    key -1, about 8 % invalid, shuffled; ``n_extra`` more drawn from
    ``pool``."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([present, absent, absent, np.full(5, -1, np.int64)])
    if n_extra:
        ids = np.concatenate([ids, rng.choice(pool, n_extra)])
    ids = ids[rng.permutation(len(ids))]
    return ids, rng.random(len(ids)) >= 0.08


def hold_upsert(dev, table0, ids, valid, P, exact=True, hl=None):
    """G5 on (table0, lanes) against its plain twin. Always: the lanes whose
    key was present find it at its slot in both; every ok lane's slot holds
    its key; no key placed twice; a failed lane's chain holds neither EMPTY
    nor its key; n_new counts the ok lanes whose key was absent; old keys
    stay.
    ``exact``: ok, n_new and the table's keys as a set also equal the plain
    twin's (placements of new keys may differ). Returns (elements that
    differ, the kernel's outputs)."""
    C = table0.shape[0]
    hi, lo = hl if hl is not None else id_halves(ids, dev)
    v = _t(valid, dev, torch.bool)
    t1, t2 = table0.clone(), table0.clone()
    s1, ok1, n1 = kernels.hash_upsert(t1, hi, lo, v, probe_len=P)
    s2, ok2, n2 = kernels.hash_upsert_plain(t2, hi, lo, v, probe_len=P)
    s0, f0, _ = kernels.hash_lookup_plain(table0, hi, lo, v, probe_len=P)
    key = kernels.key_words(hi, lo)
    err = float((s1[f0] != s0[f0]).sum() + (s2[f0] != s0[f0]).sum())
    err += float((~ok1[f0]).sum())
    err += float((t1[s1[ok1].long()] != key[ok1]).sum())
    err += float((s1[~ok1] != C).sum())
    placed = t1[t1 != table0]
    err += float(placed.numel() - torch.unique(placed).numel())
    err += float((t1[table0 != EMPTY_WORD] != table0[table0 != EMPTY_WORD]
                  ).sum())
    err += abs(int(n1) - int((ok1 & v & ~f0).sum()))
    fail = v & ~ok1 & (key != EMPTY_WORD)
    if bool(fail.any()):
        cand = kernels.probe_chain(hi[fail], lo[fail], C=C, probe_len=P)
        words = t1[cand]
        err += float(((words == EMPTY_WORD)
                      | (words == key[fail][:, None])).any(dim=1).sum())
    if exact:
        err += float((ok1 != ok2).sum()) + abs(int(n1) - int(n2))
        err += float((torch.sort(t1).values != torch.sort(t2).values).sum())
    return err, (s1, ok1, n1, t1)


def hold_lookup(dev, table, ids, valid, P, hl=None):
    """G8 against its plain twin, bit for bit."""
    hi, lo = hl if hl is not None else id_halves(ids, dev)
    v = _t(valid, dev, torch.bool)
    got = kernels.hash_lookup(table, hi, lo, v, probe_len=P)
    want = kernels.hash_lookup_plain(table, hi, lo, v, probe_len=P)
    return bits_err(list(got), list(want)), got


def compact_edge_state(dev, C, R, Wc, neutral, n_keys, alive_share, seed,
                       offset=False):
    """A plane [C*R, Wc] over a table of ``n_keys`` ids placed by the plain
    G5 (probe 64), ``alive_share`` of them with touched cells (the marker
    1 for a sum, 0 for min and max), the rest the neutral; ``offset``: the
    plane as a view one cell into a larger tensor (off 16-byte
    alignment)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = hashtable.create(C, "cpu")
    h, l = id_halves(sparse_ids(np.arange(n_keys) + seed * 10**7), "cpu")
    kernels.hash_upsert_plain(table, h, l,
                              torch.ones_like(h, dtype=torch.bool),
                              probe_len=PROBE_LEN)
    used = table != EMPTY_WORD
    alive = used & (torch.rand(C, generator=g) < alive_share)
    touch = (torch.rand(R, C, generator=g) < 0.4) & alive[None, :]
    touch[torch.randint(0, R, (C,), generator=g), torch.arange(C)] |= alive
    vals = torch.randint(-9, 9, (R, C, Wc - 1), generator=g).float()
    acc = torch.full((R, C, Wc), float(neutral))
    acc[touch] = torch.cat([vals[touch], torch.full(
        (int(touch.sum()), 1), 1.0 if neutral == 0 else 0.0)], 1)
    acc = acc.reshape(C * R, Wc)
    pane_ids = torch.arange(40, 40 + R, dtype=torch.int32)
    if offset:
        acc = torch.cat([acc.new_zeros(1, Wc), acc]).to(dev)[1:]
    return table.to(dev), acc.to(dev), pane_ids.to(dev)


def hold_compact(dev, table, acc, pane_ids, R, P, neutral, ring0):
    """G9 against its plain twin: the new table's set invariants; every
    placed key alive and its slot holding it; the move equal to the plain
    move on G9's own slot map, the ring and ``lost`` equal to the plain
    export on it; and, where neither loses a cell, the same logical cells
    (plane + ring) as the plain version. Returns (elements that differ,
    the kernel's outputs and ring)."""
    C = table.shape[0]
    kw = dict(R=R, probe_len=P, neutral=neutral)
    r1, r2, r3 = clone_ring(ring0), clone_ring(ring0), clone_ring(ring0)
    l1, l2, l3 = _zero_i32(dev), _zero_i32(dev), _zero_i32(dev)
    acc1, tab1, slot1, ok1 = kernels.compact_table(acc, table, pane_ids, r1,
                                                   l1, **kw)
    acc2, tab2, _s2, _ok2 = kernels.compact_table_plain(
        acc, table, pane_ids, r2, l2, **kw)
    alive = kernels.compact_alive_plain(acc, C=C, R=R, neutral=neutral)
    table_invariants(tab1, C, P)
    err = float((ok1 & ~alive).sum()) + float((slot1[~ok1] != C).sum())
    err += float((tab1[slot1[ok1].long()] != table[ok1]).sum())
    err += abs(int((tab1 != EMPTY_WORD).sum()) - int(ok1.sum()))
    err += bits_err(acc1, kernels.compact_move_plain(acc, slot1, ok1, C=C,
                                                     R=R, neutral=neutral))
    kernels.compact_export_plain(acc, table, pane_ids, alive, ok1, r3, l3,
                                 C=C, R=R, neutral=neutral)
    err += bits_err(list(r1) + [l1], list(r3) + [l3])
    if int(l1) == 0 and int(l2) == 0:
        err += bits_err(list(logical_cells(tab1, acc1, r1, C, R, pane_ids,
                                           neutral)),
                        list(logical_cells(tab2, acc2, r2, C, R, pane_ids,
                                           neutral)))
    return err, (acc1, tab1, slot1, ok1, r1, l1)


def table_edge_checks(dev) -> dict:
    """G5, G8 and G9 on the shapes their walks, worklist, folds and passes
    make risky, each against its plain twin (hold_upsert, hold_lookup,
    hold_compact). G5 and G8: keys 0, 15, 16, 17, 31, 32, 33 and 63 deep
    in their chains at every sector phase, each chain's second key absent
    (at depth 63 a full chain that fails), duplicates, the key -1, invalid
    lanes, at P = 1, 2, 16 and 64; the same with a slot cleared by
    remove_slots in front of each key 15 or more deep (the kernels find the
    key behind it and the absent key takes the hole); chains that wrap at C
    at each of the 16 phases of a 128-byte line; C = 8 at P = 64 and 2; B
    = 0, 1, 1,001 and a view one lane in; every lane new; half new with
    duplicates. G9 (C = 2^10 and 2^12): every key dead; every key alive
    under capacity; alive keys failing at probe 2 into a ring that fills,
    lost counted; R = 1; min and max neutrals; mean's Wc = 3; a plane off
    16-byte alignment. Then calls A, B, A on one scratch, each kernel, and
    the device operations a call (torch.profiler): G5 one kernel, G8 one,
    G9 four operations with its memset. Returns {kernel: record}."""
    C = EDGE_C
    regions = [(128 * k + (5 * k) % 16, EDGE_DEPTHS[k // 4])
               for k in range(32)]
    words, present, absent = depth_chains(C, regions, 61)
    table = _t(words, dev, torch.int64)
    holes = table.clone()
    hole_slots = [(b + d // 2) % C for b, d in regions if d >= 15]
    kernels.remove_slots(holes, _t(np.array(hole_slots), dev, torch.int32),
                         torch.ones(len(hole_slots), dtype=torch.bool,
                                    device=dev))
    ids, valid = edge_lanes(present, absent, 62)
    g5, g8, labels = [], [], []

    def both(label, tab, ids, valid, P, exact=True, hl=None):
        e5, _ = hold_upsert(dev, tab, ids, valid, P, exact, hl)
        e8, got = hold_lookup(dev, tab, ids, valid, P, hl)
        check(e5 == 0.0 and e8 == 0.0,
              f"hash_upsert / hash_lookup ({label}) differ from their plain "
              f"twins: {e5} / {e8} elements")
        g5.append(e5)
        g8.append(e8)
        labels.append(label)
        return got

    for P in (1, 2, 16, 64):
        both(f"depths P={P}", table, ids, valid, P)
        got = both(f"holes P={P}", holes, ids, valid, P, exact=P != 16)
    key = kernels.key_words(*id_halves(ids, dev))
    deep = torch.isin(key, _t(present[[d >= 15 for _, d in regions]], dev,
                              torch.int64))
    check(bool(got[1][deep & _t(valid, dev, torch.bool)].all()),
          "hash_lookup: a key behind a cleared slot was not found")
    for p in range(16):
        base = C - 1 - p
        w, pr, ab = depth_chains(C, [(base, 20)], 70 + p)
        i2, v2 = edge_lanes(pr, ab, 90 + p)
        for P in (16, 64):
            both(f"wrap phase {p} P={P}", _t(w, dev, torch.int64), i2, v2, P)
    rng = np.random.default_rng(5)
    small = hashtable.create(8, dev)
    three = sparse_ids(np.arange(3) + 7_000_000)
    kernels.hash_upsert_plain(small, *id_halves(three, dev),
                              torch.ones(3, dtype=torch.bool, device=dev),
                              probe_len=64)
    new4 = sparse_ids(np.arange(4) + 8_000_000)
    i8 = np.concatenate([three, new4, new4, [-1]])
    both("C=8 P=64", small, i8, np.ones(len(i8), bool), 64)
    i8b = np.concatenate([three, sparse_ids(np.arange(9) + 8_000_000)])
    both("C=8 P=2 (contested)", small, i8b, np.ones(len(i8b), bool), 2,
         exact=False)
    pool = np.concatenate([present, absent])
    for B in (0, 1, 1001):
        ib, vb = edge_lanes(present, absent, 100 + B, n_extra=B, pool=pool)
        both(f"B={B}", table, ib[:B], vb[:B], 64)
    big_hi, big_lo = id_halves(np.concatenate([[7], ids]), dev)
    both("view one lane in", table, ids, valid, 64,
         hl=(big_hi[1:], big_lo[1:]))
    empty = hashtable.create(C, dev)
    fresh = sparse_ids(np.arange(2500) + 9_000_000)
    i_new = np.concatenate([fresh, fresh[:1000]])
    both("every lane new", empty, i_new, np.ones(len(i_new), bool), 64)
    half = hashtable.create(C, dev)
    kernels.hash_upsert_plain(half, *id_halves(fresh[:1500], dev),
                              torch.ones(1500, dtype=torch.bool, device=dev),
                              probe_len=64)
    i_half = np.concatenate([fresh[:1500], fresh[1500:], fresh[1500:2000]])
    i_half = i_half[rng.permutation(len(i_half))]
    both("half new with duplicates", half, i_half,
         rng.random(len(i_half)) >= 0.05, 64)
    # A, B, A on one scratch
    ones = np.ones(len(i_half), bool)
    _e, a1 = hold_upsert(dev, half, i_half, ones, 64)
    hold_upsert(dev, empty, i_new, np.ones(len(i_new), bool), 64)
    _e, a2 = hold_upsert(dev, half, i_half, ones, 64)
    up_again = (float((a1[1] != a2[1]).sum()) + abs(int(a1[2]) - int(a2[2]))
                + bits_err(torch.sort(a1[3]).values,
                           torch.sort(a2[3]).values))
    _e, b1 = hold_lookup(dev, holes, ids, valid, 64)
    hold_lookup(dev, table, i_new, np.ones(len(i_new), bool), 16)
    _e, b2 = hold_lookup(dev, holes, ids, valid, 64)
    lk_again = bits_err(list(b1), list(b2))
    check(up_again == 0.0 and lk_again == 0.0,
          f"hash_upsert / hash_lookup: calls A, B, A on one scratch disagree "
          f"({up_again} / {lk_again} elements)")
    hl_half = id_halves(i_half, dev)
    v_half = _t(ones, dev, torch.bool)
    steady = half.clone()
    kernels.hash_upsert(steady, *hl_half, v_half, probe_len=64)
    n5, seen5 = launches_a_call(dev, [lambda: kernels.hash_upsert(
        steady, *hl_half, v_half, probe_len=64)] * 4)
    check(n5 in (None, 1) and all("upsert_kernel" in k for k in seen5),
          f"G5: {n5} device kernels a call, not one: {seen5}")
    n8, seen8 = launches_a_call(dev, [lambda: kernels.hash_lookup(
        steady, *hl_half, v_half, probe_len=64)] * 4)
    check(n8 in (None, 1) and all("lookup_kernel" in k for k in seen8),
          f"G8: {n8} device kernels a call, not one: {seen8}")
    # G9
    g9, labels9 = [], []
    specs = [  # (label, C, R, Wc, neutral, keys, alive share, probe, fill, O)
        ("every key dead", 1 << 10, 6, 2, 0.0, 700, 0.0, 64, 10, 4096),
        ("every key alive", 1 << 10, 6, 2, 0.0, 700, 1.0, 64, 10, 4096),
        ("fail at probe 2, ring fills", EDGE_C, 8, 2, 0.0, 3600, 0.9, 2, 500,
         2000),
        ("fail at probe 2, ring has room", EDGE_C, 8, 2, 0.0, 3600, 0.9, 2,
         10, 1 << 16),
        ("R=1", 1 << 10, 1, 2, 0.0, 700, 0.8, 64, 10, 4096),
        ("max neutral, probe 2", EDGE_C, 4, 2, -FLT_MAX, 3600, 0.8, 2, 10,
         1 << 15),
        ("min neutral", 1 << 10, 4, 2, FLT_MAX, 700, 0.8, 64, 10, 4096),
        ("mean Wc=3, probe 2", EDGE_C, 4, 3, 0.0, 3600, 0.8, 2, 10, 1 << 15),
        ("plane off 16-byte alignment, probe 2", EDGE_C, 4, 2, 0.0, 3600,
         0.8, 2, 10, 1 << 15),
    ]
    runs9, lost_seen = {}, 0
    for i, (label, C9, R, Wc, nt, n, share, P, fill, O) in enumerate(specs):
        t9, a9, p9 = compact_edge_state(dev, C9, R, Wc, nt, n, share, 30 + i,
                                        offset="alignment" in label)
        ring0 = ring_of(dev, O, fill, seed=i)
        if Wc == 3:
            ring0 = ring0[:3] + (torch.stack([ring0[3], ring0[3]], 1),
                                 ring0[4])
        e9, out = hold_compact(dev, t9, a9, p9, R, P, nt, ring0)
        check(e9 == 0.0, f"compact_table ({label}) differs from its plain "
                         f"twin: {e9} elements")
        if label == "every key dead":
            check(not bool(out[3].any()), "compact_table placed a dead key")
        if "ring fills" in label:
            lost_seen = int(out[5])
            check(lost_seen > 0, "compact_table: the full ring lost nothing")
        g9.append(e9)
        labels9.append(label)
        runs9[label] = (t9, a9, p9, R, P, nt, ring0)

    def cells9(label):
        t9, a9, p9, R, P, nt, ring0 = runs9[label]
        r, lost = clone_ring(ring0), _zero_i32(dev)
        acc1, tab1, _s, _o = kernels.compact_table(a9, t9, p9, r, lost, R=R,
                                                   probe_len=P, neutral=nt)
        return list(logical_cells(tab1, acc1, r, t9.shape[0], R, p9,
                                  nt)) + [lost]

    first = cells9("fail at probe 2, ring has room")
    cells9("every key alive")
    c9_again = bits_err(first, cells9("fail at probe 2, ring has room"))
    check(c9_again == 0.0, f"compact_table: calls A, B, A on one scratch "
                           f"disagree ({c9_again} elements)")
    t9, a9, p9, R, P, nt, ring0 = runs9["every key alive"]
    ring_c, lost_c = clone_ring(ring0), _zero_i32(dev)
    split9 = op_split(dev, [lambda: kernels.compact_table(
        a9, t9, p9, ring_c, lost_c, R=R, probe_len=P, neutral=nt)] * 4)
    n9 = round(sum(v[0] for v in split9.values())) if split9 else None
    check(n9 is None or n9 <= 5, f"G9: {n9} device operations a call: "
                                 f"{split9}")
    return {
        "hash_upsert": {"cases": len(g5) + 1, "max_abs_err": max(g5),
                        "scratch_twice_err": up_again,
                        "kernels_a_call": n5, "shapes": labels},
        "hash_lookup": {"cases": len(g8) + 1, "max_abs_err": max(g8),
                        "scratch_twice_err": lk_again,
                        "kernels_a_call": n8},
        "compact_table": {"cases": len(g9) + 1, "max_abs_err": max(g9),
                          "scratch_twice_err": c9_again,
                          "operations_a_call": n9, "lost_when_full":
                          lost_seen, "shapes": labels9},
    }


def kernel_phase(dev, C, R, B, F, maxp, slide, timing=True):
    """Hold G1-G9 against their plain versions on both input sets, and time
    the main-path set. G1-G3 run on both jobs, so each is held at the
    north-star job's shapes and at the sparse-key job's (``sparse_ms`` is
    its time there); G4 runs on the first, G5, G6 and G8 on the second,
    G7 and G9 at the churn job's ring and compaction. Returns one record
    per kernel."""
    SC, SR = SPARSE_CAPACITY, SPARSE_RING
    sk = SPARSE_SIZE_MS // SPARSE_SLIDE_MS
    full = full_table(dev, SC, B)
    ns = {kind: lane_inputs(dev, C, B, slide, kind)
          for kind in ("main", "edge")}
    sp = {kind: sparse_lane_inputs(dev, B, kind)
          for kind in ("main", "edge")}
    # name -> kind -> the cases, the north-star job's first
    make = {
        "route_lanes": lambda kind: (
            case_route_lanes(ns[kind], C, R, maxp, slide),
            case_route_lanes(sp[kind], SC, SR, maxp, SPARSE_SLIDE_MS, k=sk)),
        "clear_rows": lambda kind: (
            case_clear_rows(dev, C, R, kind),
            case_clear_rows(dev, SC, SR, kind)),
        "scatter_update": lambda kind: (
            case_scatter_update(ns[kind], C, R, maxp, slide),
            case_scatter_update(sp[kind], SC, SR, maxp, SPARSE_SLIDE_MS,
                                k=sk, table=full)),
        "fire_reduced": lambda kind: (case_fire_reduced(dev, C, R, F, kind),),
        "hash_upsert": lambda kind: (case_hash_upsert(dev, SC, B, kind,
                                                      full),),
        "fire_compact": lambda kind: (case_fire_compact(dev, SC, kind,
                                                        full),),
        "ring_append": lambda kind: (case_ring_append(dev, B, kind),),
        "hash_lookup": lambda kind: (case_hash_lookup(dev, SC, B, kind,
                                                      full),),
        "compact_table": lambda kind: (case_compact_table(dev, SC, SR,
                                                          kind),),
    }
    job_of = {"route_lanes": ("north-star", "sparse"),
              "clear_rows": ("north-star", "sparse"),
              "scatter_update": ("north-star", "sparse"),
              "fire_reduced": ("north-star",), "hash_upsert": ("sparse",),
              "fire_compact": ("sparse",), "ring_append": ("churn",),
              "hash_lookup": ("sparse",), "compact_table": ("churn",)}
    out = {}
    for name, cases_of in make.items():
        mains, errs = None, []
        for kind in ("main", "edge"):
            cases = cases_of(kind)
            for job, c in zip(job_of[name], cases):
                err = (c["err"] if "err" in c
                       else max_abs_err(c["got"], c["want"]))
                check(err == 0.0, f"{name} ({kind} inputs, {job} shapes) "
                                  f"disagrees with its plain version: max "
                                  f"abs err {err}")
                errs.append(err)
            if kind == "main":
                mains = cases
            del cases
        main = mains[0]
        rec = {"max_abs_err": max(errs), "bound_ms": bound_ms(main["bytes"])}
        if timing:
            rec["ms"] = time_ms(main["run"])
            rec["plain_ms"] = time_ms(main["plain"], reps=5)
            rec["library_ms"] = (time_ms(main["library"])
                                 if main["library"] is not None else None)
            for name_y, fn in main.get("yardsticks", {}).items():
                rec[f"{name_y}_ms"] = time_ms(fn)
            if len(mains) > 1:
                rec["sparse_ms"] = time_ms(mains[1]["run"])
                rec["sparse_bound_ms"] = bound_ms(mains[1]["bytes"])
        out[name] = rec
        del mains, main
    return out


# ------------------------------------------------- phase 3, G10-G13

def session_index(idx: np.ndarray):
    """The sessions job's bidder index and event time (ms) of event
    ``idx``: at t ms the bidder index is (50 t + u) mod 1M, u uniform in
    [0, 250,000) by a hash of the event's index, so each bidder bids in a
    5 s burst every 20 s."""
    t = idx // EVENTS_PER_MS
    u = splitmix64(idx ^ SESSION_SALT) % np.uint64(SESSION_ACTIVE)
    return (SESSION_RATE * t + u.astype(np.int64)) % SESSION_BIDDERS, t


def session_gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    b, t = session_index(idx)
    return {"bidder": splitmix64(b).view(np.int64)}, t


_ZIPF = {}


def zipf_cdf() -> np.ndarray:
    """The CDF of Zipf(s = 1.0) over N_WORDS ranks (made once)."""
    if "cdf" not in _ZIPF:
        w = 1.0 / np.arange(1, N_WORDS + 1, dtype=np.float64)
        c = np.cumsum(w)
        _ZIPF["cdf"] = c / c[-1]
    return _ZIPF["cdf"]


def word_ranks(idx: np.ndarray) -> np.ndarray:
    """The word rank of event ``idx``: the inverse Zipf CDF at
    splitmix64(idx) / 2^64."""
    u = splitmix64(idx).astype(np.float64) / 2.0**64
    return np.minimum(np.searchsorted(zipf_cdf(), u, side="right"),
                      N_WORDS - 1)


def word_gen(offset, n):
    """Flink's WordCount stream: each event one word (id splitmix64 of its
    Zipf rank), value 1."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    return {"word": splitmix64(word_ranks(idx)).view(np.int64),
            "value": np.ones(n, np.float32)}, None


def slot_lanes(dev, slots: np.ndarray, live: np.ndarray, C: int):
    return segment.sort_slots(_t(slots, dev, torch.int32),
                              _t(live, dev, torch.bool), C)


def case_segment_sort(dev, C, B, kind):
    """``main``: the wordcount batch's slots (Zipf ranks, the hot word in
    ~7 % of the lanes), then the sessions batch's (slot, tick) keys with
    the slots G5 gives its ids. ``edge``: one key in every lane, dead
    lanes, and (slot, tick) keys with ticks across the whole int32 range
    and equal pairs."""
    rng = np.random.default_rng(21)
    if kind == "main":
        slots = word_ranks(np.arange(3 * B, 4 * B, dtype=np.int64))
        live = np.ones(B, bool)
        idx = np.arange(60 * B, 61 * B, dtype=np.int64)
        b, t = session_index(idx)
        table = hashtable.create(C, dev)
        h, l = id_halves(splitmix64(b).view(np.int64), dev)
        s_slot, ok, _ = kernels.hash_upsert(
            table, h, l, torch.ones(B, dtype=torch.bool, device=dev),
            probe_len=hashtable.KEYED_PROBE_LEN)
        s_ts = _t(t.astype(np.int32), dev, torch.int32)
        s_live = ok
    else:
        slots = np.full(B, 12345)
        live = rng.random(B) < 0.95
        s_slot = _t(rng.integers(0, C, B).astype(np.int32), dev, torch.int32)
        s_slot[: B // 2] = 77
        s_ts = _t(rng.integers(-(2**31), 2**31 - 1, B).astype(np.int32), dev,
                  torch.int32)
        s_ts[: B // 4] = 5
        s_live = _t(rng.random(B) < 0.95, dev, torch.bool)
    key1 = torch.where(_t(live, dev, torch.bool),
                       _t(slots.astype(np.int64), dev, torch.int64), C)
    key2 = torch.where(s_live, (s_slot.to(torch.int64) << 32)
                       | (s_ts.to(torch.int64) + 2**31), C << 32)
    bits1, bits2 = C.bit_length(), 32 + C.bit_length()
    got, want = [], []
    for key, bits, sh in ((key1, bits1, 0), (key2, bits2, 32)):
        got += kernels.segment_sort(key, bits=bits, seg_shift=sh)
        want += kernels.segment_sort_plain(key, bits=bits, seg_shift=sh)
        lib = torch.sort(key, stable=True)
        check(bool((lib.indices == got[-3].long()).all()),
              "segment_sort: the permutation differs from a stable sort")
    return {
        "got": got, "want": want,
        "run": lambda: kernels.segment_sort(key1, bits=bits1, seg_shift=0),
        "plain": lambda: kernels.segment_sort_plain(key1, bits=bits1,
                                                    seg_shift=0),
        "library": lambda: torch.sort(key1, stable=True),
        "session_run": lambda: kernels.segment_sort(key2, bits=bits2,
                                                    seg_shift=32),
        "session_library": lambda: torch.sort(key2, stable=True),
        # key in; order, sorted key, flag out
        "bytes": B * (8 + 4 + 8 + 1),
    }


def case_rolling_update(dev, C, B, kind):
    """``main``: the wordcount batch in slot order, half the keys with an
    earlier total. ``edge``: one key in every lane, 5 % dead lanes."""
    rng = np.random.default_rng(22)
    if kind == "main":
        slots = word_ranks(np.arange(5 * B, 6 * B, dtype=np.int64))
        live = np.ones(B, bool)
    else:
        slots = np.full(B, 999)
        live = rng.random(B) < 0.95
    order, key_s, seg_start = slot_lanes(dev, slots, live, C)
    vals = _t(rng.integers(1, 9, B).astype(np.float32), dev, torch.float32)
    acc0 = _t(rng.integers(0, 100, C).astype(np.float32), dev, torch.float32)
    tou0 = _t(rng.random(C) < 0.5, dev, torch.bool)
    a1, t1, a2, t2 = acc0.clone(), tou0.clone(), acc0.clone(), tou0.clone()
    o1 = kernels.rolling_update(a1, t1, order, key_s, seg_start, vals)
    o2 = kernels.rolling_update_plain(a2, t2, order, key_s, seg_start, vals)
    n_keys = int(torch.unique(key_s[key_s < C]).numel())
    return {
        "got": (o1, a1, t1), "want": (o2, a2, t2),
        "run": lambda: kernels.rolling_update(a1, t1, order, key_s,
                                              seg_start, vals),
        "plain": lambda: kernels.rolling_update_plain(a2, t2, order, key_s,
                                                      seg_start, vals),
        "library": None,
        # key, flag, order, value in, output out per lane; acc and touched
        # read and written per key
        "bytes": B * (8 + 1 + 4 + 4 + 4) + n_keys * (4 + 1) * 2,
    }


def case_count_update(dev, C, B, kind):
    """``main``: the windowcount batch in slot order, each key with an
    earlier count and its partial window (N = 10). ``edge``: one key in
    every lane, 3 elements into a window, 5 % dead lanes."""
    rng = np.random.default_rng(23)
    if kind == "main":
        slots = word_ranks(np.arange(7 * B, 8 * B, dtype=np.int64))
        live = np.ones(B, bool)
        cnt0 = rng.integers(0, 200, C)
    else:
        slots = np.full(B, 4321)
        live = rng.random(B) < 0.95
        cnt0 = np.full(C, 3)
    order, key_s, seg_start = slot_lanes(dev, slots, live, C)
    hi, lo = id_halves(splitmix64(slots).view(np.int64), dev)
    vals = _t(np.ones(B, np.float32), dev, torch.float32)
    count0 = _t(cnt0.astype(np.int32), dev, torch.int32)
    acc0 = _t((cnt0 % COUNT_N).astype(np.float32), dev, torch.float32)
    tou0 = _t(cnt0 % COUNT_N != 0, dev, torch.bool)
    s1 = [count0.clone(), acc0.clone(), tou0.clone()]
    s2 = [count0.clone(), acc0.clone(), tou0.clone()]
    args = (order, key_s, seg_start, hi, lo, vals)
    r1, n1 = kernels.count_update(*s1, *args, N=COUNT_N)
    r2, n2 = kernels.count_update_plain(*s2, *args, N=COUNT_N)
    n = int(n2)
    check(int(n1) == n and n > 0, f"count_update: {int(n1)} rows, plain {n}")
    n_keys = int(torch.unique(key_s[key_s < C]).numel())
    return {
        "got": [r[:n] for r in r1] + s1, "want": [r[:n] for r in r2] + s2,
        "run": lambda: kernels.count_update(*s1, *args, N=COUNT_N),
        "plain": lambda: kernels.count_update_plain(*s2, *args, N=COUNT_N),
        "library": None,
        # key, flag, order, value per lane; hi and lo only for the n fired
        # lanes, and 16 B per fire row; count, acc, touched read and
        # written per key
        "bytes": B * (8 + 1 + 4 + 4) + n * (8 + 16) + n_keys * 9 * 2,
    }


def session_state_at(dev, C, B, n_batches):
    """The sessions job's state after ``n_batches`` batches, driven through
    ops/session_windows.py (G5, G10, G11), and the next batch's lanes."""
    st = session_windows.init_state(C, device=dev)
    wm = torch.zeros((), dtype=torch.int32, device=dev)
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    ones = torch.ones(B, dtype=torch.float32, device=dev)
    for k in range(n_batches + 1):
        cols, t = session_gen(k * B, B)
        h, l = id_halves(cols["bidder"], dev)
        ts = _t(t.astype(np.int32), dev, torch.int32)
        if k == n_batches:
            return st, (h, l, ts, ones, valid), int(t.max()) - 1
        wm.fill_(int(t.max()) - 1)
        session_windows.update_and_fire(st, SESSION_GAP_MS, h, l, ts, ones,
                                        valid, wm)


def case_session_update(dev, C, B, kind, main_state):
    """``main``: the sessions job 17 s into its stream (1M ids in the
    table, ~250,000 open sessions, watermark closes due), its next batch.
    ``edge``: random open sessions over half the slots; lanes over a
    tenth of them, a hot slot in 20 % of the lanes whose ticks fall in 10
    clusters 2 gaps apart (10 sessions of one key in one batch, each cut
    inside the key's multi-block run of sorted lanes), ticks out of order
    within a gap, keys whose open session the batch merges with or
    supersedes, 5 % dead lanes (late or without a slot: G11 sees both as
    lanes of the slot C), and a watermark jump that closes ~40 % of the
    open sessions."""
    rng = np.random.default_rng(24)
    G = SESSION_GAP_MS
    if kind == "main":
        st0, (h, l, ts, vals, _valid), wm_v = main_state
        slot, live = hashtable.upsert(st0.table_keys, h, l,
                                      torch.ones_like(_valid))
        state0 = (st0.start, st0.last, st0.acc, st0.active)
        table = st0.table_keys
    else:
        act = rng.random(C) < 0.5
        start = rng.integers(0, 50_000, C)
        last = start + rng.integers(0, 20_000, C)
        state0 = (_t(start.astype(np.int32), dev, torch.int32),
                  _t(last.astype(np.int32), dev, torch.int32),
                  _t(rng.integers(1, 50, C).astype(np.float32) * act, dev,
                     torch.float32),
                  _t(act, dev, torch.bool))
        table = _t(rng.integers(-(2**62), 2**62, C), dev, torch.int64)
        s = rng.integers(0, C // 10, B)
        s[: B // 5] = 31
        t = rng.integers(40_000, 90_000, B)
        t[: B // 5] = (rng.integers(0, 10, B // 5) * 2 * G
                       + rng.integers(0, 1000, B // 5))
        slot = _t(s.astype(np.int32), dev, torch.int32)
        ts = _t(t.astype(np.int32), dev, torch.int32)
        live = _t(rng.random(B) < 0.95, dev, torch.bool)
        h, l = id_halves(rng.integers(-(2**62), 2**62, B), dev)
        vals = _t(rng.integers(1, 9, B).astype(np.float32), dev,
                  torch.float32)
        wm_v = 65_000
    return session_update_pair(dev, C, G, state0, table, slot, ts, live, h,
                               l, vals, wm_v)


def session_update_pair(dev, C, G, state0, table, slot, ts, live, h, l,
                        vals, wm_v, fires=True):
    """G11 against its plain version on copies of ``state0`` (start, last,
    acc, active) after G10 sorted the lanes' (slot, tick) keys: the record
    of a ``case_session_update``. ``fires``: the inputs must fire a row."""
    B = slot.numel()
    order, key_s, _ss = segment.sort_slot_ts(slot, ts, live, C)
    wm = torch.tensor(wm_v, dtype=torch.int32, device=dev)
    s1 = [x.clone() for x in state0]
    s2 = [x.clone() for x in state0]
    args = (table, wm, order, key_s, h, l, vals)
    # with the marks (the row counts after the superseded open and batch
    # sessions) that a shard mesh's emission orders the shards' rows by
    m1 = torch.zeros(2, dtype=torch.int32, device=dev)
    m2 = torch.zeros(2, dtype=torch.int32, device=dev)
    r1, n1 = kernels.session_update(*s1, *args, G=G, marks=m1)
    r2, n2 = kernels.session_update_plain(*s2, *args, G=G, marks=m2)
    n = int(n2)
    check(int(n1) == n and (n > 0 or not fires),
          f"session_update: {int(n1)} rows, plain {n}")
    check(torch.equal(m1, m2) and 0 <= int(m2[0]) <= int(m2[1]) <= n,
          f"session_update: marks {m1.tolist()}, plain {m2.tolist()}")
    n_close = int((state0[3] & ~s2[3]).sum())
    n_keys = int(torch.unique(key_s[(key_s >> 32) < C] >> 32).numel())
    # the timing runs on copies whose sessions the first call closed
    st_run = [x.clone() for x in state0]
    st_plain = [x.clone() for x in state0]
    return {
        "got": [r[:n] for r in r1] + s1, "want": [r[:n] for r in r2] + s2,
        "run": lambda: kernels.session_update(*st_run, *args, G=G),
        "plain": lambda: kernels.session_update_plain(*st_plain, *args, G=G),
        "library": None,
        # key, order, value per lane; the open session read and the last
        # session written per key (13 B each); 20 B per fire row, and hi
        # and lo of each lane that fires; the close sweep's active and last
        # per slot, and start, acc and the key word per closed slot
        "bytes": B * (8 + 4 + 4) + n_keys * 13 * 2 + n * 20
        + (n - n_close) * 8 + C * 5 + n_close * (4 + 4 + 8 + 5),
        "rows": n, "closes": n_close,
    }


def keyed_kernel_phase(dev, C, B, timing=True):
    """Hold G10-G13 against their plain versions on both input sets at the
    sessions, wordcount and windowcount jobs' shapes (C slots, B lanes),
    and time the main set. Returns one record per kernel."""
    main_state = session_state_at(dev, C, B, SESSION_WARM_BATCHES)
    make = {
        "segment_sort": lambda kind: case_segment_sort(dev, C, B, kind),
        "session_update": lambda kind: case_session_update(dev, C, B, kind,
                                                           main_state),
        "count_update": lambda kind: case_count_update(dev, C, B, kind),
        "rolling_update": lambda kind: case_rolling_update(dev, C, B, kind),
    }
    out = {}
    for name, case_of in make.items():
        errs, main = [], None
        for kind in ("main", "edge"):
            c = case_of(kind)
            err = max_abs_err(c["got"], c["want"])
            check(err == 0.0, f"{name} ({kind} inputs) disagrees with its "
                              f"plain version: max abs err {err}")
            errs.append(err)
            if kind == "main":
                main = c
            del c
        rec = {"max_abs_err": max(errs), "bound_ms": bound_ms(main["bytes"])}
        if "rows" in main:
            rec["rows"], rec["closes"] = main["rows"], main["closes"]
        if timing:
            rec["ms"] = time_ms(main["run"])
            rec["plain_ms"] = time_ms(main["plain"], reps=3)
            rec["library_ms"] = (time_ms(main["library"])
                                 if main["library"] is not None else None)
            if "session_run" in main:
                rec["session_key_ms"] = time_ms(main["session_run"])
                rec["session_key_library_ms"] = time_ms(
                    main["session_library"])
        out[name] = rec
        del main
    out["segment_sort"]["edges"] = sort_edge_checks(dev)
    return out


def fire_session_op_split(dev, reps=8) -> dict:
    """The device operations of G4 and G11 at their job shapes, each with
    its device time (op_split), beside the call's time_ms: G4 at the north
    star (one lane due of F = 2 over the 1M-key plane), on a quiet call (no
    lane due, the same plane), and at phase 3's max k = 5, mean W = 2 and
    fresh shapes; G11 at the sessions job's main case and at the DCN
    sessions job's shard lanes (the main inputs of phase 3's cases)."""
    g4 = case_fire_reduced(dev, N_KEYS, RING_PANES, FIRES_PER_STEP, "main")
    acc, pane_ids, p_f, lane_ok = g4["args"]
    quiet = torch.zeros_like(lane_ok)
    runs = {
        "fire_reduced north star": g4["run"],
        "fire_reduced quiet": lambda: kernels.fire_reduced(
            acc, pane_ids, p_f, quiet, C=N_KEYS, R=RING_PANES, k=1),
    }
    for shape, label in (("maxprice", "max k = 5"), ("mean", "W = 2"),
                         ("fresh", "fresh")):
        runs[f"fire_reduced {label}"] = case_fire_reduce(
            dev, "main", shape, False)["run"]
    main_state = session_state_at(dev, KEYED_CAPACITY, BATCH,
                                  SESSION_WARM_BATCHES)
    runs["session_update main"] = case_session_update(
        dev, KEYED_CAPACITY, BATCH, "main", main_state)["run"]
    runs["session_update dcn"] = case_session_update_dcn(dev, "main")["run"]
    out = {}
    for name, run in runs.items():
        out[name] = {"ms": time_ms(run), "ops": ops_a_call(dev, [run] * reps),
                     "graph_ops": graph_ops(dev, run)}
    _FIRE_SETUPS.clear()
    _DCN_HELD.clear()
    return out


EDGE_C_CARD = 1 << 20   # the north star's plane: 1M keys
G11_EDGE_B = 1 << 18    # lanes of G11's edge cases (C = KEYED_CAPACITY)


def g4_edge_inputs(dev, C, W, lanes, *, op="add", k=1, missing=(),
                   fresh_from=None, floats=False, seed=0):
    """A G4 fire over F = len(lanes) lanes (``lanes`` a string of ``T``
    due and ``F`` quiet) of k-pane windows on an R = k + F ring: the plane
    (small integers, or random floats with ``floats``, in 30 % of the cells
    and the last three slots of every row; the neutral elsewhere), the pane
    ids (the panes ``missing``, offsets into the ring's pane range, absent),
    the window ends, the due lanes and, from lane ``fresh_from`` on, re-fire
    lanes over a fresh plane. Returns (args, kw) for fire_reduced."""
    F = len(lanes)
    R = k + F
    g = torch.Generator(device="cpu").manual_seed(seed)
    neutral = {"add": 0.0, "min": FLT_MAX, "max": -FLT_MAX}[op]
    pane_ids = torch.arange(40, 40 + R, dtype=torch.int32)
    pane_ids = pane_ids[torch.argsort(torch.remainder(pane_ids, R))]
    for m in missing:
        pane_ids[(40 + m) % R] = PANE_NONE
    ends = [39 + R - f for f in range(F)]
    touch = torch.rand(R, C, generator=g) < 0.3
    touch[:, -3:] = True
    t = touch.reshape(-1)
    acc = torch.full((R * C, W + 1), neutral)
    n_t = int(t.sum())
    acc[t, :W] = (torch.rand(n_t, W, generator=g) * 80 - 40 if floats
                  else torch.randint(-40, 41, (n_t, W), generator=g).float())
    acc[t, W] = 1.0 if op == "add" else 0.0
    fresh = n_ontime = None
    if fresh_from is not None:
        fresh = ((torch.rand(R * C, generator=g) < 0.05) & t).to(dev)
        n_ontime = fresh_from
    args = (acc.to(dev), pane_ids.to(dev),
            torch.tensor(ends, dtype=torch.int32, device=dev),
            torch.tensor([c == "T" for c in lanes], device=dev))
    return args, dict(C=C, R=R, k=k, op=op, neutral=neutral, fresh=fresh,
                      n_ontime=n_ontime)


def g4_edge(dev, C, W, lanes="TTF", **kw):
    """One G4 call against its plain version: (the call, counts and sums
    bit for bit as integers (elements that differ), sums' relative error,
    the outputs)."""
    floats = kw.get("floats", False)
    args, fkw = g4_edge_inputs(dev, C, W, lanes, **kw)

    def run():
        return kernels.fire_reduced(*args, **fkw)

    c1, v1 = run()
    c2, v2 = kernels.fire_reduced_plain(*args, **fkw)
    check(c1.shape == c2.shape and v1.shape == v2.shape,
          "fire_reduced: output shapes")
    bits = float((c1 != c2).sum())
    if not floats:
        bits += float((v1 != v2).sum())
    rel = float(((v1.double() - v2.double()).abs()
                 / v2.double().abs().clamp_min(1.0)).max())
    quiet = torch.tensor([c != "T" for c in lanes], device=dev)
    check(bool((c1[quiet] == 0).all()) and bool((v1[quiet] == 0).all()),
          "fire_reduced: a lane that is not due has a nonzero output")
    return run, bits, rel, (c1, v1)


def g11_state(dev, C, rng, *, active=0.5, t0=0, span=50_000):
    """Random open sessions over ``active`` of C slots, ticks from t0."""
    act = rng.random(C) < active
    start = t0 + rng.integers(0, span, C)
    last = start + rng.integers(0, 20_000, C)
    return ((_t(start.astype(np.int64).astype(np.int32), dev, torch.int32),
             _t(last.astype(np.int64).astype(np.int32), dev, torch.int32),
             _t(rng.integers(1, 50, C).astype(np.float32) * act, dev,
                torch.float32),
             _t(act, dev, torch.bool)),
            _t(rng.integers(-(2**62), 2**62, C), dev, torch.int64))


def g11_lanes(dev, rng, slot, t, dead=0.0):
    """The lanes of a G11 case from slots and ticks (numpy int64)."""
    B = slot.shape[0]
    h, l = id_halves(rng.integers(-(2**62), 2**62, B), dev)
    return (_t(slot.astype(np.int32), dev, torch.int32),
            _t(t.astype(np.int64).astype(np.int32), dev, torch.int32),
            _t(rng.random(B) >= dead, dev, torch.bool), h, l,
            _t(rng.integers(1, 9, B).astype(np.float32), dev,
               torch.float32))


def g11_edge_case(dev, name, C, B, seed):
    """The G11 edge cases at card sizes: (state0, table, lanes, wm)."""
    rng = np.random.default_rng(seed)
    G = SESSION_GAP_MS
    if name == "wrapping ticks":
        state0, table = g11_state(dev, C, rng, t0=2**31 - 60_000,
                                  span=40_000)
        t = 2**31 - 30_000 + rng.integers(0, 60_000, B)  # past INT32_MAX
        slot = rng.integers(0, C // 8, B)
        return state0, table, g11_lanes(dev, rng, slot, t, 0.05), \
            -(2**31) + 20_000
    state0, table = g11_state(dev, C, rng)
    slot = rng.integers(0, C // 10, B)
    t = rng.integers(40_000, 90_000, B)
    wm, dead = 65_000, 0.05
    if name == "one key over many tiles":
        hot = min(20_000, B // 2)         # ~20 scan tiles of one session
        slot[:hot] = 5
        t[:hot] = 60_000 + rng.integers(0, 5_000, hot)
    elif name == "cuts at tile edges":
        # slot 0's lanes come first: 3,072 of them, ticks that cut a new
        # session at lanes 1,024 and 2,048; slot 1 starts at lane 3,072
        n0 = 3072
        slot[:n0] = 0
        slot[n0:] = np.maximum(slot[n0:], 1)
        t[:n0] = (np.arange(n0) // 1024) * (3 * G) + np.arange(n0) % 1024
        slot[n0:n0 + 1024] = 1
        dead = 0.0     # a dead lane would move slot 0's cuts
    elif name == "closes nothing":
        wm = -(2**31) + 1
    elif name == "closes every slot":
        wm = 2**31 - 1
    return state0, table, g11_lanes(dev, rng, slot, t, dead), wm


def g11_call(dev, C, state0, table, lanes, wm_v):
    """G11 against its plain version on copies of ``state0``: (the call
    on a third copy, elements that differ: rows, n_rows, marks, state)."""
    slot, ts, live, h, l, vals = lanes
    B = slot.numel()
    G = SESSION_GAP_MS
    if B:
        order, key_s, _ss = segment.sort_slot_ts(slot, ts, live, C)
    else:
        order = torch.empty(0, dtype=torch.int32, device=dev)
        key_s = torch.empty(0, dtype=torch.int64, device=dev)
    wm = torch.tensor(wm_v, dtype=torch.int32, device=dev)
    args = (table, wm, order, key_s, h, l, vals)
    s1 = [x.clone() for x in state0]
    s2 = [x.clone() for x in state0]
    m1 = torch.full((2,), -7, dtype=torch.int32, device=dev)
    m2 = torch.zeros(2, dtype=torch.int32, device=dev)
    r1, n1 = kernels.session_update(*s1, *args, G=G, marks=m1)
    r2, n2 = kernels.session_update_plain(*s2, *args, G=G, marks=m2)
    n = int(n2)
    err = float(int(n1) != n) + max_abs_err(m1, m2)
    if int(n1) == n:
        err += max_abs_err([r[:n] for r in r1] + s1,
                           [r[:n] for r in r2] + s2)
    s3 = [x.clone() for x in state0]

    def run():
        for x, x0 in zip(s3, state0):
            x.copy_(x0)
        m = torch.zeros(2, dtype=torch.int32, device=dev)
        r, nr = kernels.session_update(*s3, *args, G=G, marks=m)
        return [x[:int(nr)] for x in r] + [nr, m] + [x.clone() for x in s3]

    return run, err, n


def fire_session_edge_checks(dev) -> dict:
    """G4 and G11 on the shapes their new designs make risky, at card
    sizes, against their plain versions (counts, integer sums, rows,
    marks and state bit for bit; random float sums at rtol 1e-5, and bit
    for bit across two runs): G4 over C at its tiles ± 1 and ± 2 and at the
    north star's 2^20, due and quiet lanes mixed over F = 5, every lane
    quiet, k = 5 with missing panes, W = 1, 2, 3 and 16, min, max and add,
    re-fire lanes past n_ontime, random floats; G11 with one key over many
    scan tiles, sessions cut at tile edges, B = 0, int32-wrapping ticks, a
    watermark that closes nothing and one that closes every slot, marks
    given. The tile edges are those of the read path each C takes, as
    the library reports them (``fire_reduced_tile``). Then calls A, B, A on
    one scratch for each (a stale tag would show), and the device
    operations of a call, counted in a CUDA graph of it (graph_ops): G4
    one kernel, G11 at most three kernels, neither a fill nor a copy."""
    def tile(W, C, fresh=False):
        return kernels.build().fire_reduced_tile(W, C, int(fresh))

    g4 = []
    T, Tc = tile(1, 2), tile(1, 3)     # W = 1: even C, odd C
    for C in (T - 2, T + 2, 3 * T + 2, Tc - 1, Tc + 1, 3 * Tc + 1,
              EDGE_C_CARD, EDGE_C_CARD + 3):
        g4.append((f"W1 C={C}", dict(C=C, W=1)))
    g4 += [("W1 F=5 TFTFT", dict(C=EDGE_C_CARD, W=1, lanes="TFTFT")),
           ("W1 F=5 FFFFT", dict(C=EDGE_C_CARD, W=1, lanes="FFFFT")),
           ("W1 all quiet", dict(C=EDGE_C_CARD, W=1, lanes="FFF")),
           ("W1 k=5 missing panes", dict(C=EDGE_C_CARD, W=1, k=5,
                                         missing=(3, 5))),
           ("W1 k=5 max missing", dict(C=EDGE_C_CARD + 2, W=1, k=5,
                                       op="max", missing=(4,))),
           ("W1 min", dict(C=EDGE_C_CARD, W=1, op="min")),
           ("W1 fresh F=4", dict(C=EDGE_C_CARD, W=1, lanes="TTTT",
                                 fresh_from=2)),
           ("W1 fresh odd C", dict(C=EDGE_C_CARD + 1, W=1, lanes="TFTT",
                                   fresh_from=2)),
           ("W1 fresh C=2 mod 4", dict(C=EDGE_C_CARD + 2, W=1, lanes="TTTT",
                                       fresh_from=1))]
    # W = 2: C a multiple of 4 and not; W = 3
    for W, C0, step in ((2, 4, 4), (2, 5, 1), (3, 4, 1)):
        t = tile(W, C0)
        for C in (t - step, t + step, 3 * t + 2 * step):
            g4.append((f"W{W} C={C}", dict(C=C, W=W)))
        if C0 == 5 or W == 3:
            g4.append((f"W{W} C={EDGE_C_CARD + 1}",
                       dict(C=EDGE_C_CARD + 1, W=W)))
    g4 += [("W2 k=5 missing min", dict(C=EDGE_C_CARD, W=2, k=5, op="min",
                                       missing=(2,))),
           ("W2 fresh", dict(C=EDGE_C_CARD, W=2, lanes="TTFT",
                             fresh_from=2)),
           ("W3 max F=5", dict(C=EDGE_C_CARD, W=3, op="max",
                               lanes="FTFTT")),
           ("W16 k=3", dict(C=(1 << 14) + 1, W=16, k=3)),
           ("W1 floats", dict(C=EDGE_C_CARD, W=1, floats=True)),
           ("W2 floats", dict(C=EDGE_C_CARD, W=2, floats=True))]
    bits, rel = 0.0, 0.0
    for i, (label, kw) in enumerate(g4):
        _run, b, r, _ = g4_edge(dev, seed=i, **kw)
        check(b == 0.0 and r <= 1e-5,
              f"fire_reduced ({label}) disagrees with its plain version: {b} "
              f"elements differ, lane sums rel err {r}")
        bits, rel = max(bits, b), max(rel, r)
    # float sums in block order: two runs bit-equal
    run_f, _b, _r, (c_f, v_f) = g4_edge(dev, EDGE_C_CARD, 1, floats=True,
                                        seed=77)
    v_again = run_f()[1]
    check(torch.equal(v_f, v_again),
          f"fire_reduced: float sums differ across runs {v_f} {v_again}")
    # A, B, A on one scratch
    run_a, b_a, _, (c_a, v_a) = g4_edge(dev, EDGE_C_CARD, 1, seed=100)
    first = [c_a.clone(), v_a.clone()]
    _run_b, b_b, r_b, _ = g4_edge(dev, EDGE_C_CARD + 2, 2, lanes="TFTTF",
                                  seed=101)
    g4_again = bits_err(first, list(run_a()))
    check(b_a == b_b == 0.0 and r_b <= 1e-5 and g4_again == 0.0,
          f"fire_reduced: two calls on one scratch disagree ({b_a}, {b_b}, "
          f"{g4_again} elements)")
    # the device operations of a call, on each read path
    quiet_args, quiet_kw = g4_edge_inputs(dev, EDGE_C_CARD, 1, "FF")
    g4_ops = {"quiet": graph_ops(dev, lambda: kernels.fire_reduced(
        *quiet_args, **quiet_kw))}
    for label, kw in (("W1", dict(C=EDGE_C_CARD, W=1)),
                      ("W1 odd C", dict(C=EDGE_C_CARD + 1, W=1)),
                      ("W1 k=5", dict(C=EDGE_C_CARD, W=1, k=5)),
                      ("W2", dict(C=EDGE_C_CARD, W=2)),
                      ("W2 odd C", dict(C=EDGE_C_CARD + 1, W=2)),
                      ("W3", dict(C=EDGE_C_CARD, W=3))):
        a, fkw = g4_edge_inputs(dev, lanes="TF", **kw)
        g4_ops[label] = graph_ops(
            dev, lambda a=a, fkw=fkw: kernels.fire_reduced(*a, **fkw))
    for label, ops in g4_ops.items():
        check(ops == {"kernel": 1, "memset": 0, "memcpy": 0, "other": 0},
              f"fire_reduced ({label}): not one kernel a call: {ops}")

    C, B = KEYED_CAPACITY, G11_EDGE_B
    g11 = ("random", "one key over many tiles", "cuts at tile edges",
           "wrapping ticks", "closes nothing", "closes every slot")
    errs, rows = {}, {}
    for i, name in enumerate(g11):
        state0, table, lanes, wm = g11_edge_case(dev, name, C, B, 50 + i)
        _run, err, n = g11_call(dev, C, state0, table, lanes, wm)
        check(err == 0.0, f"session_update ({name}) disagrees with its "
                          f"plain version: {err} elements differ")
        errs[name], rows[name] = err, n
        del state0, table, lanes
    # B = 0: the closes alone
    rng = np.random.default_rng(60)
    state0, table = g11_state(dev, C, rng)
    empty = g11_lanes(dev, rng, np.zeros(0, np.int64), np.zeros(0, np.int64))
    for label, wm in (("B=0", 40_000), ("B=0 closes nothing", -5)):
        _run, err, n = g11_call(dev, C, state0, table, empty, wm)
        check(err == 0.0, f"session_update ({label}) disagrees with its "
                          f"plain version: {err} elements differ")
        errs[label], rows[label] = err, n
    # A, B, A on one scratch
    sa, ta, la, wa = g11_edge_case(dev, "random", C, B, 90)
    run_a, e_a, _ = g11_call(dev, C, sa, ta, la, wa)
    first = [x.clone() for x in run_a()]
    sb, tb, lb, wb = g11_edge_case(dev, "one key over many tiles", C // 4,
                                   B // 2, 91)
    _run_b, e_b, _ = g11_call(dev, C // 4, sb, tb, lb, wb)
    again = max_abs_err(first, run_a())
    check(e_a == e_b == 0.0 and again == 0.0,
          f"session_update: two calls on one scratch disagree ({e_a}, "
          f"{e_b}, {again})")
    st = [x.clone() for x in sa]
    order, key_s, _ss = segment.sort_slot_ts(la[0], la[1], la[2], C)
    g11_args = (ta, torch.tensor(wa, dtype=torch.int32, device=dev), order,
                key_s, *la[3:])
    marks = torch.zeros(2, dtype=torch.int32, device=dev)
    g11_ops = graph_ops(dev, lambda: kernels.session_update(
        *st, *g11_args, G=SESSION_GAP_MS, marks=marks))
    check(1 <= g11_ops["kernel"] <= 3 and g11_ops["memset"] == 0
          and g11_ops["memcpy"] == 0 and g11_ops["other"] == 0,
          f"session_update: more than three device operations, or a copy "
          f"or fill: {g11_ops}")
    return {
        "fire_reduced": {"edges": {
            "cases": len(g4) + 3, "max_abs_err": bits, "max_rel_err": rel,
            "scratch_twice_err": g4_again,
            "shapes": [label for label, _ in g4],
            "graph_ops": g4_ops}},
        "session_update": {"edges": {
            "cases": len(errs) + 2, "errs": errs, "rows": rows,
            "scratch_twice_err": again, "graph_ops": g11_ops}},
    }


def stress_checks(dev, rounds: int) -> None:
    """``--stress N``: every check phase 3 makes of G4, G11, G7, G26, G12
    and G20, N times over in one process (fire_session_edge_checks; G4's
    north-star cases and its max k = 5, W = 2 and fresh cases; G11's
    sessions-job and DCN cases; ring_exchange_edge_checks; G7's main and
    mean cases, G26's north-star and DCN slices; count_cep_edge_checks;
    G12's main and edge cases, G20's main case with one stale bucket and
    with all), then fire_session_op_split, ring_exchange_op_split and
    count_cep_op_split once, and sector_probe: a fault that shows only now
    and then fails one of the rounds. A "stress" line a round, a
    "stress_split" line and a "sector_probe" line at the end."""
    main_state = session_state_at(dev, KEYED_CAPACITY, BATCH,
                                  SESSION_WARM_BATCHES)
    for r in range(rounds):
        t0 = time.perf_counter()
        edges = fire_session_edge_checks(dev)
        for kind in ("main", "edge"):
            c = case_fire_reduced(dev, N_KEYS, RING_PANES, FIRES_PER_STEP,
                                  kind)
            err = max_abs_err(c["got"], c["want"])
            check(err == 0.0, f"fire_reduced ({kind}) disagrees with its "
                              f"plain version: {err}")
            for shape in ("maxprice", "mean", "fresh"):
                c = case_fire_reduce(dev, kind, shape, False)
                check(c["err"] == 0.0 and c["float_rel"] <= 1e-5,
                      f"fire_reduced ({shape}, {kind}) disagrees with its "
                      f"plain version: {c['err']}, {c['float_rel']}")
            c = case_session_update(dev, KEYED_CAPACITY, BATCH, kind,
                                    main_state)
            err = max_abs_err(c["got"], c["want"])
            check(err == 0.0, f"session_update ({kind}) disagrees with its "
                              f"plain version: {err}")
            c = case_session_update_dcn(dev, kind)
            check(c["err"] == 0.0, f"session_update (DCN, {kind}) disagrees "
                                   f"with its plain version: {c['err']}")
            c = case_ring_append(dev, BATCH, kind)
            err = max_abs_err(c["got"], c["want"])
            check(err == 0.0, f"ring_append ({kind}) disagrees with its "
                              f"plain version: {err}")
            c = case_count_update(dev, KEYED_CAPACITY, BATCH, kind)
            err = bits_err(c["got"], c["want"])
            check(err == 0.0, f"count_update ({kind}) disagrees with its "
                              f"plain version: {err}")
            for name, make in (("ring_append (mean)", case_ring_mean),
                               ("exchange_pack", case_exchange_pack),
                               ("exchange_pack (DCN)",
                                case_exchange_pack_dcn)):
                c = make(dev, kind)
                check(c["err"] == 0.0, f"{name} ({kind}) disagrees with its "
                                       f"plain version: {c['err']}")
            del c
        for stale in (None, [True] * 9):
            c = case_cep_expire(dev, CEPW_CAPACITY, 3, 9, stale=stale)
            check(c["err"] == 0.0, f"cep_expire ({stale}) disagrees with "
                                   f"its plain version: {c['err']}")
        del c
        _FIRE_SETUPS.clear()
        _DCN_HELD.clear()
        ring_ex = ring_exchange_edge_checks(dev)
        cc = count_cep_edge_checks(dev)
        emit({"phase": "stress", "round": r,
              "seconds": time.perf_counter() - t0,
              "g12_cases": cc["count_update"]["edges"]["cases"] + 2,
              "g20_cases": cc["cep_expire"]["edges"]["cases"] + 2,
              "g4_cases": edges["fire_reduced"]["edges"]["cases"] + 8,
              "g11_cases": edges["session_update"]["edges"]["cases"] + 4,
              "g7_cases": ring_ex["ring_append"]["edges"]["cases"] + 4,
              "g26_cases": ring_ex["exchange_pack"]["edges"]["cases"] + 4,
              "graph_ops": {"fire_reduced": edges["fire_reduced"]["edges"][
                  "graph_ops"]["W1"], "session_update": edges[
                  "session_update"]["edges"]["graph_ops"]}})
    emit({"phase": "stress_split", "calls": {
        **fire_session_op_split(dev), **ring_exchange_op_split(dev),
        **count_cep_op_split(dev)}})
    emit({"phase": "sector_probe", "calls": sector_probe(dev)})


# ------------------------------------------ phase 3, G7 and G26 edges

G7_TILE = 2048     # ring_append.cu's tile (ops/cuda.py RING_TILE)


def g7_lanes(dev, mask, W, seed):
    """G7's lane columns for ``mask`` (bool numpy [B]): random key halves,
    panes and W value columns of small integers (W = 0: a count)."""
    rng = np.random.default_rng(seed)
    B = mask.shape[0]
    hi, lo = (_t(rng.integers(-2**31, 2**31, B), dev, torch.int32)
              for _ in range(2))
    pane = _t(rng.integers(-5, 40, B), dev, torch.int32)
    vals = (None if W == 0 else
            _t(rng.integers(1, 99, (B, W) if W > 1 else B), dev,
               torch.float32))
    return _t(mask, dev, torch.bool), hi, lo, pane, vals


def g7_ring(dev, O, fill, W, seed):
    """An overflow ring of O lanes holding ``fill`` lanes, W value
    columns (a count's ring holds one)."""
    ring = list(ring_of(dev, O, fill, seed))
    if W > 1:
        g = torch.Generator(device="cpu").manual_seed(seed)
        ring[3] = torch.randint(1, 9, (O, W), generator=g).float().to(dev)
    return tuple(ring)


def g7_call(dev, ring0, lanes):
    """G7 against its plain version on copies of ``ring0``: (elements of
    the ring and ``lost`` whose bits differ, the call's outputs)."""
    r1, r2 = clone_ring(ring0), clone_ring(ring0)
    l1, l2 = _zero_i32(dev), _zero_i32(dev)
    kernels.ring_append(r1, l1, *lanes)
    kernels.ring_append_plain(r2, l2, *lanes)
    return bits_err(list(r1) + [l1], list(r2) + [l2]), list(r1) + [l1]


def g7_edge_cases(B_main=BATCH):
    """G7's risky shapes: (label, B, O, fill, mask, W), ``mask`` a bool
    numpy array, over tiles of G7_TILE lanes."""
    rng = np.random.default_rng(70)
    T = G7_TILE

    def half(n):
        return rng.random(n) < 0.5

    cases = [("B=0", 0, 64, 10, np.zeros(0, bool), 1),
             ("B=1", 1, 64, 10, np.ones(1, bool), 1)]
    for B in (T - 1, T, T + 1, 3 * T - 1, 3 * T + 1):
        cases.append((f"B={B}", B, 4 * T, 100, half(B), 1))
    ends = np.zeros(40 * T, bool)         # each tile's first and last lane
    ends[::T] = True
    ends[T - 1::T] = True
    cases.append(("a lane at each tile end", 40 * T, 100 * T, 7, ends, 1))
    m = half(5 * T + 77)
    n = int(m.sum())
    cases += [("fills exactly", m.shape[0], 1000 + n, 1000, m, 1),
              ("full on entry", m.shape[0], 5000, 5000, m, 1)]
    # the ring fills in the middle of tile 3
    upto = int(m[:3 * T + T // 2].sum())
    cases.append(("fills mid-tile", m.shape[0], 300 + upto, 300, m, 1))
    cases += [("every lane masked", B_main, 2 * B_main, 5,
               np.ones(B_main, bool), 1),
              ("no lane masked", B_main, 1000, 5, np.zeros(B_main, bool), 1),
              ("W=2", 7 * T + 5, 8 * T, 11, half(7 * T + 5), 2),
              ("W=2 fills", 7 * T + 5, 3 * T, 11, half(7 * T + 5), 2),
              ("count", 7 * T + 5, 8 * T, 11, half(7 * T + 5), 0),
              ("count fills", 7 * T + 5, 2 * T, 11, half(7 * T + 5), 0)]
    return cases


def g26_lanes(B, seed, W=1, one_key=False, share=1.0):
    """G26's lane columns (numpy): random 64-bit keys' halves (or one key
    in every lane), ticks, W value columns, a ``share`` of lanes valid."""
    rng = np.random.default_rng(seed)
    keys = (np.full(B, 7, np.int64) if one_key
            else rng.integers(0, 2**62, B))
    hi = (keys >> 32).astype(np.uint32)
    lo = (keys & 0xFFFFFFFF).astype(np.uint32)
    ts = rng.integers(0, 1 << 20, B).astype(np.int32)
    vals = rng.integers(1, 99, (B, W) if W > 1 else B).astype(np.float32)
    return hi, lo, ts, vals, rng.random(B) < share


def g26_edge_cases(B=None):
    """G26's risky shapes: {label: (lanes, n, maxp, cap)}, ``lanes`` the
    numpy columns of g26_lanes; B one source's slice of a north-star batch
    by default."""
    from flink_tpu_torch.parallel.exchange import bucket_capacity

    B = BATCH // SHARDS if B is None else B

    def cap(n, b=B):
        return bucket_capacity(b, n, 2.0)

    cases = {f"n={n}": (g26_lanes(B, 260 + n), n, MAX_PARALLELISM, cap(n))
             for n in (1, 2, 4, 8)}
    cases.update({
        "n=256 (the most)": (g26_lanes(B, 261), 256, 1 << 15, cap(256)),
        "n=256, B=1000": (g26_lanes(1000, 262), 256, 1 << 15,
                          cap(256, 1000)),
        "maxp=100": (g26_lanes(B, 263), 4, 100, cap(4)),
        "cap=8": (g26_lanes(B, 264), 4, MAX_PARALLELISM, 8),
        "one key": (g26_lanes(B, 265, one_key=True), 4, MAX_PARALLELISM,
                    cap(4)),
        "no valid lane": (g26_lanes(B, 266, share=0.0), 4, MAX_PARALLELISM,
                          cap(4)),
        "W=2": (g26_lanes(B, 267, W=2), 4, MAX_PARALLELISM, cap(4)),
        "ragged": (g26_lanes(B - 77, 268, share=0.9), 4, MAX_PARALLELISM,
                   cap(4, B - 77)),
        "B=0": (g26_lanes(0, 269), 4, MAX_PARALLELISM, 8),
        "B=1": (g26_lanes(1, 270), 4, MAX_PARALLELISM, 8),
        "B=2^20": (g26_lanes(1 << 20, 271), 4, MAX_PARALLELISM,
                   cap(4, 1 << 20)),
    })
    return cases


def g26_args(dev, hi, lo, ts, vals, valid):
    return (_i32(hi, dev), _i32(lo, dev), _i32(ts, dev),
            torch.from_numpy(vals).to(dev), torch.from_numpy(valid).to(dev))


def g26_call(dev, args, n, maxp, cap):
    """G26 against its plain version: (elements of the six outputs whose
    bits differ, the call's outputs)."""
    a = kernels.exchange_pack(*args, n=n, maxp=maxp, cap=cap)
    b = kernels.exchange_pack_plain(*args, n=n, maxp=maxp, cap=cap)
    return bits_err(list(a), list(b)), list(a)


ONE_KERNEL = {"kernel": 1, "memset": 0, "memcpy": 0, "other": 0}


def ring_exchange_edge_checks(dev) -> dict:
    """G7 and G26 on the shapes their single launches make risky, bit for
    bit against their plain versions: G7 (tiles of 2,048 lanes) at B = 0,
    1, one lane either side of a tile edge, many tiles with a taken lane
    at each end, a ring that fills exactly, one full on entry, one that
    fills mid-tile, every lane masked and none, an unaligned mask (byte
    loads), W = 1 and 2 and a count; G26 at n = 1, 2, 4, 8 and 256 (also
    with more shards than blocks), a maxp no power of two, cap = 8, one key
    in every lane, no valid lane, W = 2, a ragged batch, B = 0 and 1, and
    2^20 lanes (passes past the registers). Then calls A, B, A on one
    scratch for each (a stale tag would show), and on the card the device
    operations of each call, counted in a CUDA graph of it (graph_ops): one
    kernel, no fill, no copy, on every shape."""
    on_card = dev.type == "cuda"
    g7, g7_ops = {}, {}
    for i, (label, B, O, fill, mask, W) in enumerate(g7_edge_cases()):
        ring0 = g7_ring(dev, O, fill, W, seed=i)
        lanes = g7_lanes(dev, mask, W, seed=100 + i)
        g7[label], _ = g7_call(dev, ring0, lanes)
        check(g7[label] == 0.0, f"ring_append ({label}) disagrees with its "
                                f"plain version: {g7[label]} elements differ")
        if on_card:
            rt, lt = clone_ring(ring0), _zero_i32(dev)
            g7_ops[label] = graph_ops(
                dev, lambda r=rt, l=lt, a=lanes: kernels.ring_append(r, l, *a))
    # an unaligned mask: a view one byte in, so the tiles read bytes
    m = np.random.default_rng(71).random(3 * G7_TILE + 9) < 0.5
    ring0 = g7_ring(dev, 4 * G7_TILE, 20, 1, seed=50)
    lanes = list(g7_lanes(dev, m, 1, seed=150))
    lanes[0] = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                          lanes[0]])[1:]
    g7["unaligned mask"], _ = g7_call(dev, ring0, lanes)
    check(g7["unaligned mask"] == 0.0,
          f"ring_append (unaligned mask) disagrees with its plain version: "
          f"{g7['unaligned mask']} elements differ")
    # A, B, A on one scratch: many tiles, then few, then many again
    ra = g7_ring(dev, 60 * G7_TILE, 3, 1, seed=51)
    la = g7_lanes(dev, np.random.default_rng(72).random(50 * G7_TILE) < 0.3,
                  1, seed=151)
    rb = g7_ring(dev, 4 * G7_TILE, 9, 2, seed=52)
    lb = g7_lanes(dev, np.random.default_rng(73).random(2 * G7_TILE) < 0.6,
                  2, seed=152)
    e_a, first = g7_call(dev, ra, la)
    e_b, _ = g7_call(dev, rb, lb)
    e_a2, again = g7_call(dev, ra, la)
    g7_twice = bits_err(first, again)
    check(e_a == e_b == e_a2 == 0.0 and g7_twice == 0.0,
          f"ring_append: calls on one scratch disagree ({e_a}, {e_b}, "
          f"{e_a2}, {g7_twice})")
    for label, ops in g7_ops.items():
        check(ops == ONE_KERNEL,
              f"ring_append ({label}): not one kernel a call: {ops}")

    g26, g26_ops = {}, {}
    cases = g26_edge_cases()
    for label, (cols, n, maxp, cap) in cases.items():
        args = g26_args(dev, *cols)
        g26[label], _ = g26_call(dev, args, n, maxp, cap)
        check(g26[label] == 0.0, f"exchange_pack ({label}) disagrees with "
                                 f"its plain version: {g26[label]} elements "
                                 f"differ")
        if on_card:
            g26_ops[label] = graph_ops(
                dev, lambda a=args, n=n, m=maxp, c=cap: kernels.exchange_pack(
                    *a, n=n, maxp=m, cap=c))
        del args
    for label, ops in g26_ops.items():
        check(ops == ONE_KERNEL,
              f"exchange_pack ({label}): not one kernel a call: {ops}")
    # A, B, A on one scratch: n = 4, then n = 8 over fewer lanes, n = 4
    (ca, *ka), (cb, nb, mb, _) = cases["n=4"], cases["n=8"]
    aa = g26_args(dev, *ca)
    ab = g26_args(dev, *(x[:5000] for x in cb))
    e_a, first = g26_call(dev, aa, *ka)
    e_b, _ = g26_call(dev, ab, nb, mb, 8)
    e_a2, again = g26_call(dev, aa, *ka)
    g26_twice = bits_err(first, again)
    check(e_a == e_b == e_a2 == 0.0 and g26_twice == 0.0,
          f"exchange_pack: calls on one scratch disagree ({e_a}, {e_b}, "
          f"{e_a2}, {g26_twice})")
    return {
        "ring_append": {"edges": {
            "cases": len(g7) + 3, "errs": g7, "scratch_twice_err": g7_twice,
            "graph_ops": g7_ops}},
        "exchange_pack": {"edges": {
            "cases": len(g26) + 3, "errs": g26,
            "scratch_twice_err": g26_twice, "graph_ops": g26_ops}},
    }


def ring_exchange_op_split(dev, reps=8) -> dict:
    """The device operations of G7 and G26 at their main shapes, each with
    its device time (op_split) and its graph count (graph_ops), beside the
    call's time_ms: G7 at its main case (RING_LANES, 1 % of a batch's
    lanes masked, a count), at mean's W = 2 and with no lane masked; G26
    at one source's slice of the north star (65,536 lanes, n = 4, cap =
    32,768) and at the DCN window job's (131,072 lanes, n = 4, cap =
    65,536)."""
    ring0 = g7_ring(dev, RING_LANES, 40_000, 0, seed=9)
    quiet = g7_lanes(dev, np.zeros(BATCH, bool), 0, seed=3)
    rq, lq = clone_ring(ring0), _zero_i32(dev)
    runs = {"ring_append main": case_ring_append(dev, BATCH, "main")["run"],
            "ring_append W = 2": case_ring_mean(dev, "main")["run"],
            "ring_append no lane masked": lambda: kernels.ring_append(
                rq, lq, *quiet),
            "exchange_pack main": case_exchange_pack(dev, "main")["run"],
            "exchange_pack dcn": case_exchange_pack_dcn(dev, "main")["run"]}
    out = {}
    for name, run in runs.items():
        out[name] = {"ms": time_ms(run), "ops": ops_a_call(dev, [run] * reps),
                     "graph_ops": graph_ops(dev, run)}
    return out


def count_cep_op_split(dev, reps=8) -> dict:
    """The device operations of G20 and G12 at their main shapes, each with
    its device time (op_split) and its graph count (graph_ops), beside the
    call's time_ms: G20 over cep-within's carry [2^22 + 1, 20] with one
    stale bucket and with all nine, each beside ``index_fill_`` over the
    same columns; G12 at the windowcount batch (``case_count_update``
    main) and with one key in every lane (edge)."""
    runs = {}
    for label, stale in (("one stale bucket", [q == 5 for q in range(9)]),
                         ("all buckets stale", [True] * 9)):
        c = case_cep_expire(dev, CEPW_CAPACITY, 3, 9, stale=stale)
        check(c["err"] == 0.0, f"cep_expire ({label}) disagrees with its "
                               f"plain version: {c['err']}")
        runs[f"cep_expire {label}"] = (c["run"], c["bytes"],
                                       c["sector_bytes"])
        runs[f"index_fill_ {label}"] = (c["library"], c["bytes"],
                                        c["sector_bytes"])
        del c
    for kind in ("main", "edge"):
        c = case_count_update(dev, KEYED_CAPACITY, BATCH, kind)
        err = max_abs_err(c["got"], c["want"])
        check(err == 0.0, f"count_update ({kind}) disagrees with its plain "
                          f"version: {err}")
        runs[f"count_update {kind}"] = (c["run"], c["bytes"], None)
        del c
    out = split_runs(dev, runs, reps)
    del runs
    torch.cuda.empty_cache()
    return out


SECTOR_PROBE_FLOATS = 1 << 26   # 268 MB: 2^23 sectors, past the 50 MB L2


def sector_probe(dev, reps=8) -> dict:
    """Whether a store of part of a 32-byte sector costs the card a read of
    it: over 2^23 sectors (268 MB), 4 bytes written a sector, all 32
    written, and all 32 read and written, each timed as count_cep_op_split
    times a call (torch's own elementwise kernels, a probe of the memory
    system used nowhere in the port)."""
    buf = torch.zeros(SECTOR_PROBE_FLOATS, dtype=torch.float32, device=dev)
    sectors = SECTOR_PROBE_FLOATS // 8
    out = split_runs(dev, {
        "sectors, 4 B written a sector": (
            lambda: buf.view(-1, 8)[:, 0].zero_(), sectors * 4,
            sectors * 32),
        "sectors, 32 B written a sector": (
            buf.zero_, sectors * 32, sectors * 32),
        "sectors, 32 B read and written a sector": (
            lambda: buf.mul_(1.0), sectors * 64, sectors * 32)}, reps)
    del buf
    torch.cuda.empty_cache()
    return out


def split_runs(dev, runs, reps) -> dict:
    """Each call of ``runs`` ({name: (call, bytes or None, sector bytes or
    None)}) with its time_ms, its device operations and its graph count,
    beside its byte bound and the bound of the 32-byte sectors it
    touches."""
    out = {}
    for name, (run, n_bytes, sector_bytes) in runs.items():
        rec = {"ms": time_ms(run), "ops": ops_a_call(dev, [run] * reps),
               "graph_ops": graph_ops(dev, run)}
        if n_bytes is not None:
            rec["bound_ms"] = bound_ms(n_bytes)
        if sector_bytes is not None:
            rec["sector_bound_ms"] = bound_ms(sector_bytes)
        out[name] = rec
    return out


# ------------------------------------------ phase 3, G12 and G20 edges

G12_TILE = 1024    # count_update.cu's tile (ops/cuda.py COUNT_TILE)
G12_EDGE_C = 1 << 16


def g12_segments(runs):
    """Sorted slots from (slot, lanes) runs: the batch G10 sorts into this
    order."""
    return np.concatenate([np.full(n, s, np.int64) for s, n in runs])


def g12_lanes(dev, slots, live, floats=False, seed=0):
    """G12's lane columns for ``slots`` (numpy, any order; shuffled into
    lane order) and ``live``: G10's order, sorted keys and flags at
    G12_EDGE_C, key halves, and values (small integers, or random floats
    in [0, 10) with ``floats``)."""
    rng = np.random.default_rng(seed)
    B = slots.shape[0]
    perm = rng.permutation(B)
    slots, live = slots[perm], live[perm]
    order, key_s, seg_start = slot_lanes(dev, slots, live, G12_EDGE_C)
    hi, lo = id_halves(splitmix64(slots.astype(np.int64)).view(np.int64),
                       dev)
    v = rng.random(B) * 10 if floats else rng.integers(1, 9, B)
    return (order, key_s, seg_start, hi, lo,
            _t(v.astype(np.float32), dev, torch.float32))


def g12_state(dev, N, seed, cnt=None):
    """A count-window state of G12_EDGE_C keys: old counts (random over a
    few windows, or ``cnt``), partials of small integers, and `touched`
    set at random, whether or not a count is a multiple of N."""
    rng = np.random.default_rng(seed)
    C = G12_EDGE_C
    cnt0 = rng.integers(0, 5 * N + 3, C) if cnt is None else cnt
    return [_t(np.asarray(cnt0, np.int64).astype(np.int32), dev,
               torch.int32),
            _t(rng.integers(0, 60, C).astype(np.float32), dev,
               torch.float32),
            _t(rng.random(C) < 0.5, dev, torch.bool)]


def g12_call(dev, state0, lanes, N, floats=False):
    """G12 against its plain version on copies of ``state0``: (elements of
    n_rows, the rows and the state whose bits differ, the largest relative
    error of the sums, the row count, the call's outputs). With
    ``floats`` the row values and acc are held at rtol 1e-6 instead."""
    s1 = [x.clone() for x in state0]
    s2 = [x.clone() for x in state0]
    r1, n1 = kernels.count_update(*s1, *lanes, N=N)
    r2, n2 = kernels.count_update_plain(*s2, *lanes, N=N)
    n = int(n2)
    got = [n1] + [r[:n] for r in r1] + s1
    want = [n2] + [r[:n] for r in r2] + s2
    if int(n1) != n:
        return float("inf"), float("inf"), n, got
    exact = [0, 1, 2, 3, 5, 7] if floats else range(len(got))
    err = bits_err([got[k] for k in exact], [want[k] for k in exact])
    rel = 0.0
    for k in (4, 6):
        d = (got[k].double() - want[k].double()).abs()
        if d.numel():
            rel = max(rel, float((d / want[k].double().abs()
                                  .clamp_min(1e-30)).max()))
    return err, rel, n, got


def g12_edge_cases():
    """G12's risky shapes: (label, slots, live, N, cnt, floats), ``slots``
    and ``live`` numpy arrays (``cnt``: the old counts, or None for
    random ones)."""
    rng = np.random.default_rng(120)
    T, C = G12_TILE, G12_EDGE_C

    def rand(B, keys, dead=0.0):
        return rng.integers(0, keys, B), rng.random(B) >= dead

    def ones(B):
        return np.ones(B, bool)

    cases = [("B=1", np.array([7]), ones(1), 10, None, False)]
    for B in (T - 1, T, T + 1):
        cases.append((f"B={B}", *rand(B, 300), 10, None, False))
    cases += [
        ("N=1", *rand(5000, 400), 1, None, False),
        ("N=10, 5 % dead", *rand(5000, 400, 0.05), 10, None, False),
        (f"N={T - 1}", *rand(9000, 5), T - 1, None, False),
        (f"N={T + 1}", *rand(9000, 5), T + 1, None, False),
        ("N above B", *rand(5000, 4), 8000, np.full(C, 7700), False),
        ("one key in every lane", np.full(40_000, 4321), ones(40_000), 10,
         np.full(C, 3), False),
        ("one key, N=1500", np.full(9000, 77), rng.random(9000) >= 0.05,
         1500, None, False),
    ]
    # a key over three tiles (lanes 1,019-3,080), its windows of 7 open
    # across each tile edge
    three = g12_segments([(s, 1) for s in range(1019)] + [(5000, 2062)]
                         + [(s, 1) for s in range(6000, 7000)])
    cnt = rng.integers(0, 40, C)
    cnt[5000] = 3
    cases.append(("a key across three tiles", three, ones(three.size), 7,
                  cnt, False))
    # fires at lane 0 (tile 0's first), 1,024 and 2,047 (tile 1's first
    # and last)
    edges = g12_segments([(s, 1) for s in range(1020)] + [(9000, 5)]
                         + [(s, 1) for s in range(9001, 10016)]
                         + [(10500, 8)]
                         + [(s, 1) for s in range(20000, 20100)])
    cnt = rng.integers(0, 40, C)
    cnt[[0, 9000, 10500]] = [9, 5, 2]
    cases.append(("fires at tile ends", edges, ones(edges.size), 10, cnt,
                  False))
    mult = rng.integers(0, 6, C) * 10
    cases += [
        ("old counts multiples of N", *rand(5000, 500), 10, mult, False),
        ("all lanes dead", rng.integers(0, 100, 3000),
         np.zeros(3000, bool), 10, None, False),
        ("random floats", *rand(20_000, 3000, 0.05), 10, None, True),
        ("old counts near 2^31 (a wraps)", *rand(3000, 50), 10,
         2**31 - 1 - rng.integers(0, 25, C), False),
    ]
    return cases


def g20_edge_cases():
    """G20's risky shapes: (label, rows, S, Q, stale)."""
    one9 = [q == 3 for q in range(9)]
    some9 = [q in (0, 4, 8) for q in range(9)]
    return [
        ("S=2, Q=9, one stale", 5000, 2, 9, one9),
        ("S=3, Q=9, several", 5000, 3, 9, some9),
        ("S=3, Q=9, all", 5000, 3, 9, [True] * 9),
        ("S=15, Q=9, one stale", 3001, 15, 9, one9),
        ("S=15, Q=9, all", 3001, 15, 9, [True] * 9),
        ("S=3, Q=2, one stale", 777, 3, 2, [False, True]),
        ("S=3, Q=2, all", 777, 3, 2, [True, True]),
        ("S=2, Q=126, stale_hi", 2049, 2, 126,
         [q in (1, 70, 125) for q in range(126)]),
        ("S=2, Q=126, all", 2049, 2, 126, [True] * 126),
        ("one row", 1, 3, 9, some9),
        ("rows no multiple of a block", 256 * 7 + 13, 3, 9, one9),
    ]


def g20_call(dev, carry0, stale, S, Q):
    """G20 against its plain version on copies of ``carry0``: (elements
    whose bits differ, the call's carry)."""
    c1, c2 = carry0.clone(), carry0.clone()
    kernels.cep_expire(c1, stale, S=S, Q=Q)
    kernels.cep_expire_plain(c2, stale, S=S, Q=Q)
    return bits_err(c1, c2), c1


def count_cep_edge_checks(dev) -> dict:
    """G12 and G20 on the shapes their single launches make risky, bit for
    bit against their plain versions. G12 (1,024-lane tiles): B = 1 and
    one lane either side of a tile edge; N = 1, 10, a tile +- 1 and above
    B; one key in every lane (N = 10 and 1,500), a key over three tiles
    with a window across each edge, fires at a tile's first and last lane;
    old counts multiples of N or not, `touched` set or not at random; 5 %
    dead lanes, all dead, random floats (rtol 1e-6), old counts near 2^31
    (a wraps as int32). G20: S = 2, 3, 15; Q = 2, 9 and 126 (stale bits
    past 64); one stale bucket, several, all; one row, a row count no
    multiple of a block, a carry one float off 16-byte alignment, and on
    the card a carry of 2^31 floats and more (64-bit offsets; a carry of
    ones, its stale cells counted and its sum taken). Then
    calls A, B, A on one scratch for each (a stale tag would show), and
    on the card the device operations of each call, counted in a CUDA
    graph of it (graph_ops): one kernel, no fill, no copy."""
    on_card = dev.type == "cuda"
    g12, g12_ops, rel, rows = {}, {}, 0.0, {}
    cases = g12_edge_cases()
    inputs = {}
    for i, (label, slots, live, N, cnt, floats) in enumerate(cases):
        state0 = g12_state(dev, N, seed=200 + i, cnt=cnt)
        lanes = g12_lanes(dev, slots, live, floats, seed=300 + i)
        err, r, rows[label], _ = g12_call(dev, state0, lanes, N, floats)
        g12[label] = err
        rel = max(rel, r)
        check(err == 0.0 and r <= 1e-6,
              f"count_update ({label}) disagrees with its plain version: "
              f"{err} elements differ, rel err {r}")
        if on_card:
            st = [x.clone() for x in state0]
            g12_ops[label] = graph_ops(
                dev, lambda s=st, a=lanes, n=N: kernels.count_update(
                    *s, *a, N=n))
        inputs[label] = (state0, lanes, N)
    # A, B, A on one scratch: three tiles, then 40 tiles of one key, again
    sa, la, na = inputs["a key across three tiles"]
    sb, lb, nb = inputs["one key in every lane"]
    e_a, _, _, first = g12_call(dev, sa, la, na)
    e_b, _, _, _ = g12_call(dev, sb, lb, nb)
    e_a2, _, _, again = g12_call(dev, sa, la, na)
    g12_twice = bits_err(first, again)
    check(e_a == e_b == e_a2 == 0.0 and g12_twice == 0.0,
          f"count_update: calls on one scratch disagree ({e_a}, {e_b}, "
          f"{e_a2}, {g12_twice})")
    for label, ops in g12_ops.items():
        check(ops == ONE_KERNEL,
              f"count_update ({label}): not one kernel a call: {ops}")
    del inputs

    g20, g20_ops = {}, {}
    g = torch.Generator(device="cpu").manual_seed(201)
    for label, n, S, Q, stale in g20_edge_cases():
        D = (S - 1) * Q + 2
        carry0 = torch.randint(0, 5, (n, D), generator=g).float().to(dev)
        g20[label], _ = g20_call(dev, carry0, stale, S, Q)
        check(g20[label] == 0.0, f"cep_expire ({label}) disagrees with its "
                                 f"plain version: {g20[label]} elements")
        if on_card:
            c = carry0.clone()
            g20_ops[label] = graph_ops(
                dev, lambda c=c, st=stale, S=S, Q=Q: kernels.cep_expire(
                    c, st, S=S, Q=Q))
    # a carry one float off 16-byte alignment (4-byte stores)
    flat = torch.randint(0, 5, (1 + 999 * 20,), generator=g).float().to(dev)
    g20["unaligned carry"], _ = g20_call(
        dev, flat[1:].view(999, 20), [q % 2 == 0 for q in range(9)], 3, 9)
    check(g20["unaligned carry"] == 0.0,
          f"cep_expire (unaligned carry) disagrees with its plain version: "
          f"{g20['unaligned carry']} elements")
    if on_card:  # 64-bit offsets: a carry of 2^31 floats and more (8.6 GB)
        rows, one = (1 << 31) // 20 + 1000, [q == 4 for q in range(9)]
        big = torch.ones(rows, 20, device=dev)
        kernels.cep_expire(big, one, S=3, Q=9)
        cols = cep_stale_cols(3, 9, one)
        zeros = int((big[:, cols] == 0).sum())
        total = float(big.sum(dtype=torch.float64))
        g20["64-bit offsets"] = float(abs(zeros - rows * len(cols))
                                      + abs(total - rows * (20 - len(cols))))
        check(g20["64-bit offsets"] == 0.0,
              f"cep_expire (64-bit offsets): {zeros} stale cells zeroed of "
              f"{rows * len(cols)}, sum {total}")
        del big
        torch.cuda.empty_cache()
    # A, B, A: G20 keeps no scratch, so this holds its store lists apart
    ca = torch.randint(0, 5, (3001, 128), generator=g).float().to(dev)
    cb = torch.randint(0, 5, (777, 6), generator=g).float().to(dev)
    e_a, first = g20_call(dev, ca, [True] * 9, 15, 9)
    e_b, _ = g20_call(dev, cb, [False, True], 3, 2)
    e_a2, again = g20_call(dev, ca, [True] * 9, 15, 9)
    g20_twice = bits_err(first, again)
    check(e_a == e_b == e_a2 == 0.0 and g20_twice == 0.0,
          f"cep_expire: calls in a row disagree ({e_a}, {e_b}, {e_a2}, "
          f"{g20_twice})")
    for label, ops in g20_ops.items():
        check(ops == ONE_KERNEL,
              f"cep_expire ({label}): not one kernel a call: {ops}")
    return {
        "count_update": {"edges": {
            "cases": len(g12) + 3, "errs": g12, "max_rel_err": rel,
            "rows": rows, "scratch_twice_err": g12_twice,
            "graph_ops": g12_ops}},
        "cep_expire": {"edges": {
            "cases": len(g20) + 3, "errs": g20,
            "twice_err": g20_twice, "graph_ops": g20_ops}},
    }


def session_keys(rng, n, C, ticks, dead=0.05):
    """(slot, tick) keys as ops/segment.py sort_slot_ts builds them: slots
    in [0, C), ticks from ``ticks`` (an int64 array of n), ``dead`` of the
    lanes at C << 32. Their bits: 32 + C.bit_length()."""
    slot = rng.integers(0, C, n).astype(np.int64)
    key = (slot << 32) | ((ticks.astype(np.int64) + 2**31) & 0xFFFFFFFF)
    return np.where(rng.random(n) < dead, C << 32, key)


def sort_edge_checks(dev) -> dict:
    """G10 on the shapes its tiling, its digit plan and its scratch make
    risky, each bit for bit against its plain version and its permutation
    and keys against torch.sort(stable=True)'s: n below one tile, at k
    tiles and k tiles +- 1, n = 1; bits 1, 8, 9, 16, 63; a constant low,
    middle and top digit; every key equal, strictly descending keys, dead
    lanes at C (slot keys) and C << 32 (session keys, a 51-bit key whose
    tick digits above the lowest two are constant); then calls in a row on
    one scratch (A, B, no lanes, A again: A's outputs the same both times,
    the histogram half, tile counters and barrier carried over); then the
    device kernels a call launches at the 51-bit shape (torch.profiler):
    one. Returns a record nested under segment_sort."""
    rng = np.random.default_rng(18)
    tile = kernels.SORT_TILE
    if dev.type == "cuda":
        check(kernels.build().segment_sort_tile() == tile,
              "segment_sort: SORT_TILE differs from the kernel's tile")
        check(kernels.build().segment_sort_state_words()
              == kernels.SORT_STATE_WORDS,
              "segment_sort: SORT_STATE_WORDS differs from the kernel's")

    def rand(n, bits):
        return rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(
            np.int64) if bits < 63 else rng.integers(
            0, 2**63 - 1, n, dtype=np.int64)

    ticks = rng.integers(5_000_000, 5_000_000 + 40_000, 1 << 19)
    cases = [  # (label, keys, bits, seg_shift)
        ("n below a tile", rand(tile // 3, 23), 23, 0),
        ("n = 1", rand(1, 23), 23, 0),
        ("n = tile", rand(tile, 23), 23, 0),
        ("n = 3 tiles - 1", rand(3 * tile - 1, 23), 23, 0),
        ("n = 3 tiles + 1", rand(3 * tile + 1, 23), 23, 0),
        ("n = 64 tiles + 1", rand(64 * tile + 1, 23), 23, 0),
    ]
    cases += [(f"bits {b}", rand(50_000, b), b, max(0, b - 5))
              for b in (1, 8, 9, 16, 63)]
    lo = rand(60_000, 16)
    cases += [
        ("constant low digit", (lo << 8) | 0x5A, 24, 8),
        ("constant middle digit", ((lo >> 8) << 16) | (0xA5 << 8)
         | (lo & 255), 24, 0),
        ("constant top digit", (0xC3 << 16) | lo, 24, 16),
        ("every key equal", np.full(100_000, 0x1234_5678_9A), 40, 0),
        ("descending", np.arange(100_000, 0, -1, dtype=np.int64), 17, 0),
        ("dead slots at C", np.where(rng.random(200_000) < 0.3, 1 << 18,
                                     rand(200_000, 18)), 19, 0),
        ("51-bit session keys", session_keys(rng, 1 << 19, 1 << 18, ticks),
         51, 32),
    ]
    err = 0.0
    for label, key, bits, sh in cases:
        k = torch.from_numpy(np.ascontiguousarray(key, np.int64)).to(dev)
        got = kernels.segment_sort(k, bits=bits, seg_shift=sh)
        want = kernels.segment_sort_plain(k, bits=bits, seg_shift=sh)
        lib = torch.sort(k, stable=True)
        e = max(max_abs_err(list(got), list(want)),
                max_abs_err([got[0].long(), got[1]],
                            [lib.indices, lib.values]))
        check(e == 0.0, f"segment_sort ({label}, n {k.numel()}, bits "
                        f"{bits}) differs from its plain version or a "
                        f"stable sort: {e} elements")
        err = max(err, e)
    # calls in a row on one scratch: A, B, no lanes, A again
    ka = torch.from_numpy(cases[4][1]).to(dev)
    kb = torch.from_numpy(cases[-1][1]).to(dev)
    a1 = kernels.segment_sort(ka, bits=23, seg_shift=0)
    kernels.segment_sort(kb, bits=51, seg_shift=32)
    kernels.segment_sort(ka[:0], bits=23, seg_shift=0)   # no launch
    a2 = kernels.segment_sort(ka, bits=23, seg_shift=0)
    again = max_abs_err(list(a1), list(a2))
    check(again == 0.0, f"segment_sort: a call on a used scratch differs "
                        f"({again} elements)")
    n_launch, seen = launches_a_call(
        dev, [lambda: kernels.segment_sort(kb, bits=51, seg_shift=32)] * 4)
    check(n_launch in (None, 1) and all("sort_kernel" in k for k in seen),
          f"G10: {n_launch} device kernels a call, not one: {seen}")
    return {"cases": len(cases) + 1, "max_abs_err": err,
            "scratch_twice_err": again, "kernels_a_call": n_launch,
            "shapes": [c[0] for c in cases]}


# ------------------------------------------------------------ phase 4

def numpy_reference(total, n_keys, events_per_ms, window_ms, chunk=1 << 22):
    """(key, window) pairs of the generator: the windows a tumbling sum
    emits. Each event is 1.0, so the value sum is the event count."""
    n_windows = -(-total // (events_per_ms * window_ms))
    seen = np.zeros((n_windows, n_keys), bool)
    for off in range(0, total, chunk):
        keys, ts, _ = gen_batch(off, min(chunk, total - off), n_keys,
                                events_per_ms)
        seen[ts // window_ms, keys] = True
    return int(seen.sum())


def north_star_job(device, n_keys, events_per_ms, total, batch, depth,
                   config=None, with_env=False, parallelism=1):
    """The north-star job through the public API, with ``config`` added to
    its configuration, at ``parallelism`` shards; returns (sink, job, s),
    or (sink, env, job, s) with ``with_env``."""
    def gen(offset, n):
        keys, ts, vals = gen_batch(offset, n, n_keys, events_per_ms)
        return {"key": keys, "value": vals}, ts

    cfg = Configuration({
        "keys.reverse-map": False,
        "window.fires-per-step": FIRES_PER_STEP,
        "pipeline.ring-depth": depth,
        # no overflow ring: the job's keys all fit, and without a ring the
        # drains reduce the fires on the card (G4) as in PRs 1-2
        "state.backend.overflow-ring": 0,
        **(config or {}),
    })
    env = StreamExecutionEnvironment(cfg, device=device)
    env.set_parallelism(parallelism)
    env.set_max_parallelism(MAX_PARALLELISM)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(n_keys)
    env.batch_size = batch
    sink = CountingSink()
    (
        env.add_source(GeneratorSource(gen, total=total))
        .key_by(lambda c: c["key"])
        .time_window(WINDOW_MS)
        .sum(lambda c: c["value"])
        .add_sink(sink)
    )
    t0 = time.perf_counter()
    job = env.execute("chip-smoke-north-star")
    if device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (sink, env, job, secs) if with_env else (sink, job, secs)


# ------------------------------------------------------------ phase 5

def sparse_gen(offset, n):
    """The north-star traffic with each key mapped to its sparse id."""
    keys, ts, _ = gen_batch(offset, n)
    return {"id": sparse_ids(keys)}, ts


def sparse_job(device, total, batch, depth, parallelism=1):
    """HOP(2 s, 10 s) count per sparse id into a row-keeping sink, through
    the public API, at ``parallelism`` shards; returns (sink, job, s)."""
    cfg = Configuration({
        "keys.reverse-map": False,
        "window.fires-per-step": FIRES_PER_STEP,
        "pipeline.ring-depth": depth,
        "state.probe-len": PROBE_LEN,
    })
    env = StreamExecutionEnvironment(cfg, device=device)
    env.set_parallelism(parallelism)
    env.set_max_parallelism(MAX_PARALLELISM)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(SPARSE_CAPACITY)
    env.batch_size = batch
    sink = ColumnarCollectSink()
    (
        env.add_source(GeneratorSource(sparse_gen, total=total))
        .key_by(lambda c: c["id"])
        .time_window(SPARSE_SIZE_MS, SPARSE_SLIDE_MS)
        .count()
        .add_sink(sink)
    )
    t0 = time.perf_counter()
    job = env.execute("chip-smoke-sparse-hop")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sink, job, time.perf_counter() - t0


def sparse_reference(total, chunk=1 << 22):
    """numpy's answer for the sparse job: the number of distinct (key,
    window) pairs, and the rows (id, window end ms, count) of the keys whose
    id is 0 mod 1024. A window ending at pane e holds panes e-4 .. e."""
    k = SPARSE_SIZE_MS // SPARSE_SLIDE_MS
    n_panes = -(-total // (EVENTS_PER_MS * SPARSE_SLIDE_MS))
    seen = np.zeros((n_panes, N_KEYS), bool)
    sel_ids, sel_panes = [], []
    for off in range(0, total, chunk):
        keys, ts, _ = gen_batch(off, min(chunk, total - off))
        pane = ts // SPARSE_SLIDE_MS
        seen[pane, keys] = True
        ids = sparse_ids(keys)
        sel = ids.view(np.uint64) % np.uint64(1024) == 0
        sel_ids.append(ids[sel])
        sel_panes.append(pane[sel])
    n_pairs = 0
    for e in range(n_panes + k - 1):
        n_pairs += int(np.logical_or.reduce(
            seen[max(0, e - k + 1):e + 1], axis=0).sum())
    ids = np.concatenate(sel_ids).view(np.uint64)
    panes = np.concatenate(sel_panes)
    ends = np.concatenate([(panes + j + 1) * SPARSE_SLIDE_MS
                           for j in range(k)])
    pairs, counts = np.unique(
        np.stack([np.tile(ids, k), ends.astype(np.uint64)], 1), axis=0,
        return_counts=True)
    return n_pairs, pairs, counts


def check_sparse_rows(cols, total):
    """The sparse job's rows against numpy; returns the row count."""
    n_pairs, pairs, counts = sparse_reference(total)
    n = len(cols["value"])
    check(n == n_pairs, f"sparse job: {n} rows, numpy {n_pairs}")
    vsum = float(np.sum(cols["value"], dtype=np.float64))
    k = SPARSE_SIZE_MS // SPARSE_SLIDE_MS
    check(vsum == float(k * total),
          f"sparse job: values sum to {vsum}, not {k * total}")
    kid = cols["key_id"].astype(np.uint64)
    sel = kid % np.uint64(1024) == 0
    got = np.stack([kid[sel], cols["window_end_ms"][sel].astype(np.uint64)],
                   1)
    order = np.lexsort((got[:, 1], got[:, 0]))
    check(np.array_equal(got[order], pairs)
          and np.array_equal(cols["value"][sel][order], counts),
          "sparse job: the rows of the keys with id = 0 mod 1024 differ "
          "from numpy's")
    return n


# ------------------------------------------------------------ phase 6

def churn_ids(idx: np.ndarray) -> np.ndarray:
    """The churn job's id of event ``idx``: at event time t ms,
    splitmix64(t * CHURN_IDS_PER_MS + u), u uniform in [0, CHURN_LIVE) —
    drawn by a hash of the event's index, so that any cut of the stream
    gives the same ids."""
    t = idx // EVENTS_PER_MS
    u = splitmix64(idx + CHURN_SEED) % np.uint64(CHURN_LIVE)
    return splitmix64(t * CHURN_IDS_PER_MS + u.astype(np.int64)).view(
        np.int64)


def churn_gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    return {"id": churn_ids(idx)}, idx // EVENTS_PER_MS


def churn_job(device, total, batch, depth):
    """nexmark q5's HOP(2 s, 10 s) count per auction id, the ids churning,
    through the public API with the overflow ring unset; returns (sink,
    job, s)."""
    cfg = Configuration({
        "keys.reverse-map": False,
        "window.fires-per-step": FIRES_PER_STEP,
        "pipeline.ring-depth": depth,
        "state.probe-len": PROBE_LEN,
    })
    env = StreamExecutionEnvironment(cfg, device=device)
    env.set_parallelism(1)
    env.set_max_parallelism(MAX_PARALLELISM)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(CHURN_CAPACITY)
    env.batch_size = batch
    sink = ColumnarCollectSink()
    (
        env.add_source(GeneratorSource(churn_gen, total=total))
        .key_by(lambda c: c["id"])
        .time_window(SPARSE_SIZE_MS, SPARSE_SLIDE_MS)
        .count()
        .add_sink(sink)
    )
    t0 = time.perf_counter()
    job = env.execute("chip-smoke-churn")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sink, job, time.perf_counter() - t0


def check_churn_rows(cols, total):
    """Every (id, window end, count) row of the churn job against numpy's
    group-by of the same stream. Returns (rows, distinct ids, the most ids
    a window holds — the live set the table must keep at once)."""
    k = SPARSE_SIZE_MS // SPARSE_SLIDE_MS
    per_pane = EVENTS_PER_MS * SPARSE_SLIDE_MS
    n_panes = -(-total // per_pane)
    panes = []
    for p in range(n_panes):
        idx = np.arange(p * per_pane, min((p + 1) * per_pane, total))
        panes.append(np.unique(churn_ids(idx).view(np.uint64),
                               return_counts=True))
    kid = cols["key_id"].astype(np.uint64)
    end = cols["window_end_ms"].astype(np.int64)
    val = cols["value"]
    order = np.lexsort((kid, end))
    kid, end, val = kid[order], end[order], val[order]
    bounds = np.searchsorted(end, (np.arange(n_panes + k) + 1)
                             * SPARSE_SLIDE_MS, side="left")
    live_max = 0
    for e in range(n_panes + k - 1):
        ks = [panes[q] for q in range(max(0, e - k + 1), min(e + 1, n_panes))]
        uk, inv = np.unique(np.concatenate([a for a, _ in ks]),
                            return_inverse=True)
        cnt = np.bincount(inv, weights=np.concatenate([c for _, c in ks]))
        a, b = bounds[e], bounds[e + 1]
        check(b - a == len(uk) and np.array_equal(kid[a:b], uk)
              and np.array_equal(val[a:b], cnt.astype(np.float32))
              and bool((end[a:b] == (e + 1) * SPARSE_SLIDE_MS).all()),
              f"churn job: the rows of the window ending at pane {e} "
              f"differ from numpy's")
        live_max = max(live_max, len(uk))
    check(bounds[n_panes + k - 1] == len(kid),
          "churn job: rows past the last window")
    distinct = len(np.unique(np.concatenate([a for a, _ in panes])))
    return len(kid), distinct, live_max


# ------------------------------------------------------ phases 7-9

def keyed_env(device, parallelism=1):
    env = StreamExecutionEnvironment(
        Configuration({"keys.reverse-map": False}), device=device)
    env.set_parallelism(parallelism)
    env.set_max_parallelism(MAX_PARALLELISM)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(KEYED_CAPACITY)
    env.batch_size = BATCH
    return env


def _timed_job(env, name, sink):
    t0 = time.perf_counter()
    job = env.execute(name)
    if env.device.type == "cuda":
        torch.cuda.synchronize()
    return sink, job, time.perf_counter() - t0


def sessions_job(device, total, parallelism=1):
    """nexmark q11: sessions (gap 10 s) counting each bidder's bids, at
    ``parallelism`` shards."""
    from flink_tpu_torch.datastream.window.assigners import (
        EventTimeSessionWindows,
    )
    env = keyed_env(device, parallelism)
    sink = ColumnarCollectSink()
    (env.add_source(GeneratorSource(session_gen, total=total))
     .key_by(lambda c: c["bidder"])
     .window(EventTimeSessionWindows.with_gap(SESSION_GAP_MS))
     .count()
     .add_sink(sink))
    return _timed_job(env, "chip-smoke-sessions", sink)


def session_reference(total, chunk=1 << 22):
    """numpy's sessions: the events sorted stably by bidder (time order
    kept), cut at a bidder change or a gap > 10 s. Returns (id uint64,
    start ms, end ms = last + gap, count) sorted by (id, start)."""
    b_all = np.empty(total, np.int32)
    t_all = np.empty(total, np.int32)
    for off in range(0, total, chunk):
        idx = np.arange(off, min(off + chunk, total), dtype=np.int64)
        b, t = session_index(idx)
        b_all[off:off + len(idx)] = b
        t_all[off:off + len(idx)] = t
    order = np.argsort(b_all, kind="stable")
    b, t = b_all[order], t_all[order]
    del b_all, t_all, order
    cut = np.ones(total, bool)
    cut[1:] = (b[1:] != b[:-1]) | (t[1:] - t[:-1] > SESSION_GAP_MS)
    starts = np.flatnonzero(cut)
    ends = np.append(starts[1:], total)
    ids = splitmix64(b[starts].astype(np.int64))
    rows = (ids, t[starts].astype(np.int64),
            t[ends - 1].astype(np.int64) + SESSION_GAP_MS,
            (ends - starts).astype(np.float32))
    o = np.lexsort((rows[1], rows[0]))
    return tuple(r[o] for r in rows)


def check_session_rows(cols, total):
    """Every (id, start, end, count) row against numpy's. Returns (rows,
    sessions that the watermark closed before the end of the stream)."""
    ids, start, end, cnt = session_reference(total)
    kid = cols["key_id"].astype(np.uint64)
    o = np.lexsort((cols["window_start_ms"], kid))
    check(len(kid) == len(ids)
          and np.array_equal(kid[o], ids)
          and np.array_equal(cols["window_start_ms"][o], start)
          and np.array_equal(cols["window_end_ms"][o], end)
          and np.array_equal(cols["value"][o], cnt),
          f"sessions job: {len(kid)} rows, numpy {len(ids)}; the rows "
          f"differ from numpy's")
    last_wm = (total - 1) // EVENTS_PER_MS - 1
    return len(ids), int((end <= last_wm).sum())


def probe_depths(table, C, probe_len=hashtable.KEYED_PROBE_LEN):
    """How deep the table's keys sit in their chains of probe_len."""
    used = torch.nonzero(table != EMPTY_WORD).reshape(-1)
    hi, lo = kernels.split_words(table[used])
    depth = (used - (probe_hash(hi, lo) & (C - 1))) % C
    return {"keys": int(used.numel()), "load": used.numel() / C,
            "probe_len": probe_len, "max_depth": int(depth.max()),
            "keys_at_depth_12_or_more": int((depth >= 12).sum()),
            "keys_at_depth_16_or_more": int((depth >= 16).sum())}


def wordcount_job(device, total, parallelism=1):
    """Flink's streaming WordCount: keyBy(word).sum(count), at
    ``parallelism`` shards."""
    env = keyed_env(device, parallelism)
    sink = ColumnarCollectSink()
    (env.add_source(GeneratorSource(word_gen, total=total))
     .key_by(lambda c: c["word"])
     .sum(lambda c: c["value"])
     .add_sink(sink))
    return _timed_job(env, "chip-smoke-wordcount", sink)


def windowcount_job(device, total, parallelism=1):
    """Flink's WindowWordCount: keyBy(word).countWindow(10).sum(count), at
    ``parallelism`` shards."""
    env = keyed_env(device, parallelism)
    sink = ColumnarCollectSink()
    (env.add_source(GeneratorSource(word_gen, total=total))
     .key_by(lambda c: c["word"])
     .count_window(COUNT_N)
     .sum(lambda c: c["value"])
     .add_sink(sink))
    return _timed_job(env, "chip-smoke-windowcount", sink)


def all_word_ranks(total, chunk=1 << 22):
    return np.concatenate([
        word_ranks(np.arange(off, min(off + chunk, total), dtype=np.int64))
        for off in range(0, total, chunk)])


def check_wordcount_rows(cols, ranks):
    """Every row, in input order: the event's word and numpy's running
    count of that word."""
    n = len(ranks)
    order = np.argsort(ranks, kind="stable")
    r = ranks[order]
    first = np.ones(n, bool)
    first[1:] = r[1:] != r[:-1]
    starts = np.flatnonzero(first)
    seg = np.cumsum(first) - 1
    running = np.empty(n, np.float32)
    running[order] = (np.arange(n) - starts[seg] + 1).astype(np.float32)
    check(len(cols["value"]) == n
          and np.array_equal(cols["key_id"], splitmix64(ranks))
          and np.array_equal(cols["value"], running),
          "wordcount job: the rows differ from numpy's running counts")
    return int(running.max())


def check_windowcount_rows(cols, ranks):
    """The (id, ordinal) rows: floor(count / 10) windows of each word,
    each worth 10."""
    uniq, cnt = np.unique(ranks, return_counts=True)
    k = cnt // COUNT_N
    ids = np.repeat(splitmix64(uniq), k)
    first = np.repeat(np.cumsum(k) - k, k)
    ordinal = np.arange(len(ids)) - first
    o = np.lexsort((ordinal, ids))
    kid = cols["key_id"].astype(np.uint64)
    w = cols["window_end_ms"]
    g = np.lexsort((w, kid))
    check(len(kid) == len(ids) and np.array_equal(kid[g], ids[o])
          and np.array_equal(w[g], ordinal[o])
          and bool((cols["value"] == COUNT_N).all()),
          f"windowcount job: {len(kid)} rows, numpy {len(ids)}; the rows "
          f"differ from numpy's")
    return len(ids)


# ------------------------------------------- sketches: traffic and specs
#
# nexmark-flink's bid stream at its hot-channel rule (BASELINE config #3's
# sketches): every draw is a hash of the event's index, so a job's source
# and numpy's reference see the same events.

def bid_channels(idx: np.ndarray) -> np.ndarray:
    """Channel id of each event: one of 4 hot channels with probability
    1/2, else uniform over 10,000 others (BidGenerator's HOT_CHANNELS_RATIO
    of 2 and CHANNELS_NUMBER), as integer ids 0..10,003."""
    u = splitmix64(idx ^ BID_SALT_CHANNEL)
    hot = (u & np.uint64(1)) == np.uint64(1)
    return np.where(hot, (u >> np.uint64(1)) % np.uint64(BID_HOT),
                    np.uint64(BID_HOT) + (u >> np.uint64(3))
                    % np.uint64(BID_COLD)).astype(np.int64)


def bid_bidder_index(idx: np.ndarray) -> np.ndarray:
    return (splitmix64(idx ^ BID_SALT_BIDDER)
            % np.uint64(BID_BIDDERS)).astype(np.int64)


def bid_bidders(idx: np.ndarray) -> np.ndarray:
    """Bidder id: splitmix64 of a uniform index in [0, 1M)."""
    return splitmix64(bid_bidder_index(idx)).view(np.int64)


def _zipf_auction_table():
    """The head of Zipf(1.3)'s CDF (ranks 1..2^16) and zeta(1.3)."""
    if "auction" not in _ZIPF:
        k = np.arange(1, BID_ZIPF_HEAD + 1, dtype=np.float64)
        w = k ** -BID_ZIPF_S
        s, n = BID_ZIPF_S, float(BID_ZIPF_HEAD)
        # zeta(s) by Euler-Maclaurin past the head
        zeta = w.sum() + n ** (1 - s) / (s - 1) - n ** -s / 2
        _ZIPF["auction"] = (np.cumsum(w) / zeta, zeta)
    return _ZIPF["auction"]


def bid_auctions(idx: np.ndarray) -> np.ndarray:
    """Auction id: Zipf(1.3) mod 100,000 (bench_configs.py's count-min
    items), drawn by the inverse CDF at splitmix64(idx) / 2^64 over the
    head's 2^16 ranks, the continuous tail beyond."""
    cdf, zeta = _zipf_auction_table()
    u = splitmix64(idx ^ BID_SALT_AUCTION).astype(np.float64) / 2.0**64
    head = np.searchsorted(cdf, u, side="right")
    s = BID_ZIPF_S
    tail = ((1.0 - u) * (s - 1) * zeta) ** (1.0 / (1.0 - s))
    rank = np.where(head < BID_ZIPF_HEAD, head + 1,
                    np.clip(tail, BID_ZIPF_HEAD + 1, 2.0**62))
    return rank.astype(np.int64) % BID_AUCTIONS


def bid_gen(field: str):
    """The bid stream's source: channel plus the one column a job reads
    (``bidder`` or ``auction``); event time idx / 2,000 ms."""
    draw = bid_bidders if field == "bidder" else bid_auctions

    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        return ({"channel": bid_channels(idx), field: draw(idx)},
                idx // EVENTS_PER_MS)
    return gen


def hll_spec():
    h = sketches.HyperLogLog(HLL_P)
    return ReduceSpec("sketch", h.dtype, h.value_shape, sketch=h,
                      finalize=h.finalize, result_shape=h.result_shape,
                      result_dtype=h.result_dtype)


def cms_spec(depth=None, width=None, query=CMS_QUERY):
    c = sketches.CountMinSketch(depth or CMS_DEPTH, width or CMS_WIDTH,
                                query=query)
    kw = {} if query is None else dict(
        finalize=c.finalize, result_shape=c.result_shape,
        result_dtype=c.result_dtype)
    return ReduceSpec("sketch", c.dtype, c.value_shape, sketch=c, **kw)


# the two jobs' shapes: (spec, job column, ring R, slide ms, panes k)
SKETCH_JOBS = {
    "distinct": (hll_spec, "bidder", DISTINCT_RING, DISTINCT_SLIDE_MS,
                 DISTINCT_SIZE_MS // DISTINCT_SLIDE_MS),
    "countmin": (cms_spec, "auction", CMS_RING, CMS_SLIDE_MS,
                 CMS_SIZE_MS // CMS_SLIDE_MS),
}


def main_end_pane(job: str) -> int:
    """The window the kernel cases fire: the distinct job's ending at pane
    6 (panes 2-6, 20M events), the countmin job's at pane 2 (panes 1-2,
    16M events)."""
    return 6 if job == "distinct" else 2


def bid_lanes(dev, job, offset, n):
    """One batch of a job's traffic as G14's lanes: slot = channel (the
    identity table), pane, item hash bits; every lane live."""
    _spec, field, _R, slide, _k = SKETCH_JOBS[job]
    cols, ts = bid_gen(field)(offset, n)
    h = sketches.hash32_host(cols[field]).view(np.int32)
    return (_t(cols["channel"].astype(np.int32), dev, torch.int32),
            _t((ts // slide).astype(np.int32), dev, torch.int32),
            _t(h, dev, torch.int32))


def sketch_state_at(dev, job, end_pane):
    """A job's split planes (identity table, slot = channel) after every
    event of the k panes of the window ending at ``end_pane``, built with
    G14 itself (held to its plain version below): the fire's main input
    and the base of the update's. Returns (red, acc, touched,
    pane_ids)."""
    make, _field, R, slide, k = SKETCH_JOBS[job]
    red = make()
    C, W = SKETCH_CAPACITY, red.value_shape[0]
    acc = torch.zeros(C * R, W, dtype=torch.int32, device=dev)
    touched = torch.zeros(C * R, dtype=torch.bool, device=dev)
    per = slide * EVENTS_PER_MS
    max_pane = torch.tensor(end_pane, dtype=torch.int32, device=dev)
    lost = _zero_i32(dev)
    for off in range((end_pane - k + 1) * per, (end_pane + 1) * per, BATCH):
        n = min(BATCH, (end_pane + 1) * per - off)
        slot, pane, h = bid_lanes(dev, job, off, n)
        z = torch.zeros(n, dtype=torch.int32, device=dev)
        live = torch.ones(n, dtype=torch.bool, device=dev)
        kernels.sketch_update(acc, touched, None, lost, pane, z, live, slot,
                              h, max_pane, C=C, R=R, sketch=red.sketch)
    pane_ids = torch.tensor([q for q in range(end_pane - R + 1, end_pane + 1)],
                            dtype=torch.int32, device=dev)
    pane_ids = pane_ids[torch.argsort(torch.remainder(pane_ids, R))]
    check(int(lost) == 0, f"{job} state: {int(lost)} lanes lost")
    return red, acc, touched, pane_ids


def rank_zero_hashes(p: int, n: int) -> np.ndarray:
    """n item hashes whose fmix32 is 0 in its low 32 - p bits (HyperLogLog
    rank 33 - p)."""
    out, start = [], 0
    while sum(map(len, out)) < n:
        cand = np.arange(start, start + (1 << 24), dtype=np.uint32)
        out.append(cand[(sketches._fmix32_np(cand) << np.uint32(p)) == 0])
        start += 1 << 24
    return np.concatenate(out)[:n]


def case_sketch_update(dev, job, kind, base):
    """G14 at a job's shapes. ``main``: a batch in the middle of the last
    pane of ``base`` (the job's state after a window's events), real
    routes. ``edge``: item hashes above 2^24 and of rank 33 - p, a fifth
    of the lanes on one key and one register, lanes with no slot (C), dead
    lanes and lanes behind the ring's horizon."""
    red, acc0, touched0, _pids = base
    _make, _field, R, slide, k = SKETCH_JOBS[job]
    C = SKETCH_CAPACITY
    end_pane = main_end_pane(job)
    per = slide * EVENTS_PER_MS
    slot, pane, h = bid_lanes(dev, job, end_pane * per + per // 2, BATCH)
    B = BATCH
    live = torch.ones(B, dtype=torch.bool, device=dev)
    if kind == "edge":
        rng = np.random.default_rng(17)
        s = rng.integers(0, C, B)
        s[rng.random(B) < 0.05] = C
        p = rng.integers(end_pane - R + 1, end_pane + 1, B)
        p[rng.random(B) < 0.05] = end_pane - R - 1   # too old
        hh = sketches.hash32_host(rng.integers(0, 1 << 40, B))
        special = rng.random(B) < 0.1
        hh[special] = rng.choice(rank_zero_hashes(HLL_P, 8),
                                 int(special.sum()))
        one = rng.random(B) < 0.2                    # one key, one register
        s[one], p[one], hh[one] = 7, end_pane, hh[0]
        slot = _t(s.astype(np.int32), dev, torch.int32)
        pane = _t(p.astype(np.int32), dev, torch.int32)
        h = _t(hh.view(np.int32), dev, torch.int32)
        live = _t(rng.random(B) < 0.9, dev, torch.bool)
    hi = torch.zeros(B, dtype=torch.int32, device=dev)
    kg = assign_to_key_group(route_hash(hi, slot), MAX_PARALLELISM).to(
        torch.int32)
    max_pane = torch.tensor(end_pane, dtype=torch.int32, device=dev)
    sides = []
    for _ in range(2):
        sides.append((acc0.clone(), touched0.clone(),
                      torch.zeros(MAX_PARALLELISM, dtype=torch.bool,
                                  device=dev), _zero_i32(dev)))
    lanes = (pane, kg, live, slot, h, max_pane)
    kw = dict(C=C, R=R, sketch=red.sketch)
    kernels.sketch_update(*sides[0], *lanes, **kw)
    kernels.sketch_update_plain(*sides[1], *lanes, **kw)
    # the library yardstick: the register scatter alone, on precomputed
    # register indices (no horizon, slot, touched or kg_dirty work)
    ok = live & (pane >= end_pane - (R - 1)) & (slot < C)
    flat = (torch.remainder(pane.long(), R) * C + slot.long())[ok]
    eidx, upd, _m = red.sketch.expand(flat, h[ok], ok[ok])
    regs = sides[1][0].view(-1)
    if red.sketch.op == "max":
        library = lambda: regs.scatter_reduce_(0, eidx, upd, reduce="amax")
    else:
        library = lambda: regs.index_put_((eidx,), upd, accumulate=True)
    got, want = sides
    # the same lanes with uniform item hashes: what the hot items' shared
    # registers cost (a warp pre-combine could take back at most this)
    uniform = (pane, kg, live, slot, torch.randint(
        -2**31, 2**31 - 1, (B,), dtype=torch.int32, device=dev), max_pane)
    return {
        "got": list(got), "want": list(want),
        "uniform_run": lambda: kernels.sketch_update(*got, *uniform, **kw),
        "run": lambda: kernels.sketch_update(*got, *lanes, **kw),
        "plain": lambda: kernels.sketch_update_plain(*want, *lanes, **kw),
        "library": library,
        # pane, kg, live, slot, hash in; each register it may raise read
        # and written once; each touched byte written once
        "bytes": B * (4 + 4 + 1 + 4 + 4)
        + int(torch.unique(eidx).numel()) * 8
        + int(torch.unique(flat).numel()),
    }


def case_sketch_fire(dev, job, kind, base):
    """G15 at a job's shapes, both fire modes (rows into an arena, and
    reduced). ``main``: the job's window ending at the last pane of
    ``base``, one due lane of F = 2. ``edge``: random registers (0 and
    33 - p among them) touched at random, two due lanes, one of them with
    a pane rotated out of the ring; and a Count-Min without a query at a
    small W (raw rows)."""
    red, acc, touched, pane_ids = base
    _make, _field, R, slide, k = SKETCH_JOBS[job]
    C, F = SKETCH_CAPACITY, FIRES_PER_STEP
    end_pane = int(pane_ids.max())
    ends, n_due = [end_pane, end_pane + 1], 1
    if kind == "edge":
        g = torch.Generator(device=dev).manual_seed(23)
        hi_reg = 33 - HLL_P if red.sketch.op == "max" else 50
        acc = torch.randint(0, hi_reg + 1, acc.shape, generator=g,
                            device=dev, dtype=torch.int32)
        touched = torch.rand(touched.shape, generator=g, device=dev) < 0.5
        pane_ids = pane_ids.clone()
        pane_ids[(end_pane - 1) % R] = PANE_NONE    # rotated out
        ends, n_due = [end_pane, end_pane - 1], 2
    table = torch.arange(C, dtype=torch.int64, device=dev)
    p_f = torch.tensor(ends, dtype=torch.int32, device=dev)
    lane_ok = torch.tensor([f < n_due for f in range(F)], device=dev)
    specs = [red]
    if kind == "edge" and job == "countmin":
        specs.append(cms_spec(2, 32, None))         # raw rows, W = 64
    got, want, floats = [], [], []
    for r in specs:
        W = r.value_shape[0]
        a = acc if W == acc.shape[1] else acc[:, :W].contiguous()
        args = (a, touched, pane_ids, p_f, lane_ok, table)
        kw = dict(C=C, R=R, k=k, red=r)
        rows1 = fire_row_buffers(F, C, dev, red=r)
        rows2 = fire_row_buffers(F, C, dev, red=r)
        c1, v1 = kernels.sketch_fire(*args, rows1, **kw)
        c2, v2 = kernels.sketch_fire_plain(*args, rows2, **kw)
        cr1, vr1 = kernels.sketch_fire(*args, None, **kw)
        cr2, vr2 = kernels.sketch_fire_plain(*args, None, **kw)
        got += [c1, cr1]
        want += [c2, cr2]
        for f in range(F):
            n = int(c2[f])
            got += [rows1[0][f, :n], rows1[1][f, :n]]
            want += [rows2[0][f, :n], rows2[1][f, :n]]
            if r.out_dtype == torch.float32:
                floats.append((rows1[2][f, :n], rows2[2][f, :n]))
            else:
                got.append(rows1[2][f, :n])
                want.append(rows2[2][f, :n])
        for x, y in ((v1, v2), (vr1, vr2)):
            if r.out_dtype == torch.float32:
                floats.append((x, y))
            else:
                got.append(x)
                want.append(y)
    W = red.value_shape[0]
    args = (acc, touched, pane_ids, p_f, lane_ok, table)
    kw = dict(C=C, R=R, k=k, red=red)
    rows1 = fire_row_buffers(F, C, dev, red=red)
    rows2 = fire_row_buffers(F, C, dev, red=red)
    # bytes: the touched bytes of every present row of a due lane; per
    # emitted slot its present panes' registers (all W for hll, D x Q for
    # a query); 8 B of key and the value per emitted row
    t2 = touched.view(R, C)
    n_rows, n_cells, n_present = 0, 0, 0
    for e, ok in zip(ends, lane_ok.tolist()):
        if not ok:
            continue
        rows = [(e - j) % R for j in range(k)
                if int(pane_ids[(e - j) % R]) == e - j]
        n_present += len(rows)
        if rows:
            per_slot = t2[rows].sum(0)
            n_cells += int(per_slot.sum())
            n_rows += int((per_slot > 0).sum())
    cells_w = W if red.finalize is None or red.sketch.op == "max" else \
        red.sketch.depth * len(red.sketch.query)
    out_w = int(np.prod(red.out_shape, dtype=np.int64))
    return {
        "got": got, "want": want, "floats": floats,
        "run": lambda: kernels.sketch_fire(*args, rows1, **kw),
        "plain": lambda: kernels.sketch_fire_plain(*args, rows2, **kw),
        "library": None,
        "bytes": n_present * C + n_cells * cells_w * 4
        + n_rows * (8 + 4 * out_w) + R * 4 + F * (4 + 1 + 4 + 4),
        "rows": n_rows,
    }


def float_errs(pairs):
    """(max abs err, max rel err) over (got, want) float tensor pairs; the
    relative error against max(|want|, 1) (an estimate is >= 1 where a
    slot was touched)."""
    abs_e = rel_e = 0.0
    for a, b in pairs:
        if a.shape != b.shape:
            return float("inf"), float("inf")
        if a.numel():
            d = (a.double() - b.double()).abs()
            abs_e = max(abs_e, float(d.max()))
            rel_e = max(rel_e, float(
                (d / b.double().abs().clamp_min(1.0)).max()))
    return abs_e, rel_e


def case_clear_split(dev, job, kind, base):
    """G2 on a job's split planes. ``main``: a pane crossing clears one
    stale row. ``edge``: two rows, one of them evicted with unfired data
    (its touched slots counted)."""
    red, acc0, touched0, _pids = base
    R = SKETCH_JOBS[job][2]
    C = SKETCH_CAPACITY
    W = red.value_shape[0]
    end_pane = int(_pids.max())
    clear = torch.zeros(R, dtype=torch.bool, device=dev)
    evicted = torch.zeros(R, dtype=torch.bool, device=dev)
    clear[(end_pane + 1) % R] = True
    if kind == "edge":
        q = end_pane % R
        clear[q] = evicted[q] = True
    rows = clear.nonzero().reshape(-1)
    sides = [(acc0.clone(), touched0.clone(), _zero_i32(dev))
             for _ in range(2)]
    kw = dict(C=C, R=R)
    (a1, t1, d1), (a2, t2, d2) = sides
    kernels.clear_rows(a1, clear, evicted, d1, touched=t1, **kw)
    kernels.clear_rows_plain(a2, clear, evicted, d2, touched=t2, **kw)
    return {
        "got": [a1, t1, d1], "want": [a2, t2, d2],
        "run": lambda: kernels.clear_rows(a1, clear, evicted, d1,
                                          touched=t1, **kw),
        "plain": lambda: kernels.clear_rows_plain(a2, clear, evicted, d2,
                                                  touched=t2, **kw),
        "library": lambda: (a2.view(R, C * W).index_fill_(0, rows, 0),
                            t2.view(R, C).index_fill_(0, rows, False)),
        # flagged rows' registers and touched bytes written, evicted rows'
        # touched bytes read, masks read
        "bytes": int(clear.sum()) * C * (W * 4 + 1)
        + int(evicted.sum()) * C + 2 * R,
    }


def sketch_kernel_phase(dev, timing=True):
    """Hold G14, G15 and G2's split variant against their plain versions
    on both inputs at both sketch jobs' shapes (C = 2^14 slots, W = 4,096
    registers: HyperLogLog p = 12 with R = 12, k = 5; Count-Min 4 x 1,024
    with R = 8, k = 2, Q = 3), and time the main inputs. Equality is exact
    but for HyperLogLog's float estimates (and value sums), held to rtol
    1e-6: the kernel's log and the plain version's may round apart.
    Returns one record per kernel, the distinct job's numbers first."""
    recs = {}
    for job in ("distinct", "countmin"):
        base = sketch_state_at(dev, job, main_end_pane(job))
        for name, case in (("sketch_update", case_sketch_update),
                           ("sketch_fire", case_sketch_fire),
                           ("clear_rows_split", case_clear_split)):
            errs, rels, main = [], [], None
            for kind in ("main", "edge"):
                c = case(dev, job, kind, base)
                err = max_abs_err(c["got"], c["want"])
                f_abs, f_rel = float_errs(c.get("floats", ()))
                check(err == 0.0 and f_rel <= 1e-6,
                      f"{name} ({kind} inputs, {job} shapes) disagrees "
                      f"with its plain version: {err} integer elements "
                      f"differ, float rel err {f_rel}")
                errs.append(max(err, f_abs))
                rels.append(f_rel)
                if kind == "main":
                    main = c
                else:
                    del c
            rec = {"max_abs_err": max(errs), "max_rel_err": max(rels),
                   "bound_ms": bound_ms(main["bytes"])}
            if "rows" in main:
                rec["rows"] = main["rows"]
            if timing:
                rec["ms"] = time_ms(main["run"])
                rec["plain_ms"] = time_ms(main["plain"], reps=3)
                rec["library_ms"] = (time_ms(main["library"])
                                     if main["library"] is not None
                                     else None)
                if "uniform_run" in main:
                    rec["uniform_items_ms"] = time_ms(main["uniform_run"])
            del main
            recs.setdefault(name, {})[job] = rec
        del base
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return recs


# ------------------------------------------- sketches: the two jobs

def sketch_env(device):
    env = StreamExecutionEnvironment(Configuration({
        "keys.reverse-map": False,
        "window.fires-per-step": FIRES_PER_STEP,
        "pipeline.ring-depth": RING_DEPTH,
        "state.probe-len": SKETCH_PROBE_LEN,
    }), device=device)
    env.set_parallelism(1)
    env.set_max_parallelism(MAX_PARALLELISM)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(SKETCH_CAPACITY)
    env.batch_size = BATCH
    return env


def distinct_job(device, total):
    """nexmark q16's count(distinct bidder) per channel over HOP(2 s, 10 s),
    as distinct_count(bidder, precision=12)."""
    env = sketch_env(device)
    sink = ColumnarCollectSink()
    (env.add_source(GeneratorSource(bid_gen("bidder"), total=total))
     .key_by(lambda c: c["channel"])
     .time_window(DISTINCT_SIZE_MS, DISTINCT_SLIDE_MS)
     .distinct_count(lambda c: c["bidder"], precision=HLL_P)
     .add_sink(sink))
    return _timed_job(env, "chip-smoke-distinct", sink)


def countmin_job(device, total):
    """BASELINE #3's Count-Min as bench_configs.py runs it, keyed by
    channel: HOP(4 s, 8 s), count_min(auction, 4, 1024, query=[1, 2, 3])."""
    env = sketch_env(device)
    sink = ColumnarCollectSink()
    (env.add_source(GeneratorSource(bid_gen("auction"), total=total))
     .key_by(lambda c: c["channel"])
     .time_window(CMS_SIZE_MS, CMS_SLIDE_MS)
     .count_min(lambda c: c["auction"], depth=CMS_DEPTH, width=CMS_WIDTH,
                query=CMS_QUERY)
     .add_sink(sink))
    return _timed_job(env, "chip-smoke-countmin", sink)


def _hll_rank(h: np.ndarray, p: int):
    """numpy's (bucket, rank) of item hashes (HyperLogLog.host_add's law,
    vectorized): frexp gives floor(log2 w) + 1 exactly for a uint32 w."""
    x = sketches._fmix32_np(h)
    bucket = (x >> np.uint32(32 - p)).astype(np.int64)
    w = (x.astype(np.uint64) << np.uint64(p)) & np.uint64(0xFFFFFFFF)
    e = np.frexp(w.astype(np.float64))[1]
    rho = np.where(w == 0, 33 - p, 33 - e)
    return bucket, rho.astype(np.int8)


def _sorted_rows(cols):
    kid = cols["key_id"].astype(np.int64)
    o = np.lexsort((cols["window_end_ms"], kid))
    return kid[o], cols["window_end_ms"][o], np.asarray(cols["value"])[o]


def check_distinct_rows(cols, total, chunk=1 << 22):
    """numpy's HyperLogLog of the same hashes: registers per (pane,
    channel) by np.maximum.at, each window's the max over its panes, the
    estimate from their exact sums as the port computes it; every (channel,
    window, estimate) row equal, the estimate at rtol 1e-6. Then the
    median relative error against numpy's exact distinct bidders over the
    4 hot channels and every 64th cold one. Returns (rows, median error,
    windows checked for error)."""
    hll = sketches.HyperLogLog(HLL_P)
    W, NCH = hll.m, BID_HOT + BID_COLD
    per = DISTINCT_SLIDE_MS * EVENTS_PER_MS
    n_panes = -(-total // per)
    k = DISTINCT_SIZE_MS // DISTINCT_SLIDE_MS
    check(n_panes <= 8, "the exact count keeps one bit a pane in a byte")
    regs = np.zeros(n_panes * NCH * W, np.int8)
    sel = np.full(NCH, -1, np.int64)
    sel_ch = np.concatenate([np.arange(BID_HOT),
                             np.arange(BID_HOT, NCH, 64)])
    sel[sel_ch] = np.arange(len(sel_ch))
    seen = np.zeros(len(sel_ch) * BID_BIDDERS, np.uint8)
    for off in range(0, total, chunk):
        idx = np.arange(off, min(off + chunk, total), dtype=np.int64)
        ch = bid_channels(idx)
        b = bid_bidder_index(idx)
        pane = idx // per
        bucket, rho = _hll_rank(sketches.hash32_host(splitmix64(b).view(np.int64)),
                                HLL_P)
        np.maximum.at(regs, (pane * NCH + ch) * W + bucket, rho)
        s = sel[ch]
        m = s >= 0
        pos, pm = s[m] * BID_BIDDERS + b[m], pane[m]
        for q in np.unique(pm):
            seen[pos[pm == q]] |= np.uint8(1 << int(q))
    regs = regs.reshape(n_panes, NCH, W)
    lut = (np.int64(1) << (hll.base - np.arange(hll.base + 1))).astype(
        np.int64)
    want_k, want_e, want_v, errs = [], [], [], []
    seen = seen.reshape(len(sel_ch), BID_BIDDERS)
    for p in range(n_panes + k - 1):
        qs = list(range(max(0, p - k + 1), min(p, n_panes - 1) + 1))
        r = regs[qs].max(axis=0)
        present = np.flatnonzero(r.any(axis=1))
        rp = r[present]
        est = hll.estimate(torch.from_numpy(lut[rp].sum(axis=1)),
                           torch.from_numpy((rp == 0).sum(axis=1))).numpy()
        want_k.append(present)
        want_e.append(np.full(len(present), (p + 1) * DISTINCT_SLIDE_MS))
        want_v.append(est)
        wmask = np.uint8(sum(1 << q for q in qs))
        exact = ((seen & wmask) != 0).sum(axis=1)
        e_sel = dict(zip(present.tolist(), est.tolist()))
        for c, x in zip(sel_ch.tolist(), exact.tolist()):
            if x:
                errs.append(abs(e_sel[c] - x) / x)
    wk_, we_, wv_ = (np.concatenate(a) for a in (want_k, want_e, want_v))
    o = np.lexsort((we_, wk_))
    wk_, we_, wv_ = wk_[o], we_[o], wv_[o]
    gk, ge, gv = _sorted_rows(cols)
    check(len(gk) == len(wk_) and np.array_equal(gk, wk_)
          and np.array_equal(ge, we_),
          f"distinct job: {len(gk)} rows, numpy {len(wk_)}; the (channel, "
          f"window) pairs differ")
    rel = float(np.max(np.abs(gv.astype(np.float64) - wv_)
                       / np.abs(wv_.astype(np.float64))))
    check(rel <= 1e-6, f"distinct job: estimates off numpy's by rel {rel}")
    med = float(np.median(errs))
    check(med < 0.03, f"distinct job: median relative error {med} >= 3 %")
    return len(gk), med, len(errs), rel


def check_countmin_rows(cols, total, chunk=1 << 22):
    """numpy's Count-Min of the same hashes at the query's columns: per
    (pane, channel) and row d the events whose register is the query
    item's, summed over each window's panes, the min over d; every
    (channel, window, [3] estimates) row equal, and every estimate at
    least the item's exact count. Returns (rows, hot-channel estimate of
    item 1 in the first full window, its exact count)."""
    cms = sketches.CountMinSketch(CMS_DEPTH, CMS_WIDTH, query=CMS_QUERY)
    NCH, D, Q = BID_HOT + BID_COLD, CMS_DEPTH, len(CMS_QUERY)
    per = CMS_SLIDE_MS * EVENTS_PER_MS
    n_panes = -(-total // per)
    k = CMS_SIZE_MS // CMS_SLIDE_MS
    hits = np.zeros((n_panes * NCH, D, Q), np.int64)
    exact = np.zeros((n_panes * NCH, Q), np.int64)
    events = np.zeros(n_panes * NCH, np.int64)
    n_cells = n_panes * NCH
    for off in range(0, total, chunk):
        idx = np.arange(off, min(off + chunk, total), dtype=np.int64)
        cell = (idx // per) * NCH + bid_channels(idx)
        items = bid_auctions(idx)
        h = sketches.hash32_host(items)
        events += np.bincount(cell, minlength=n_cells)
        for d in range(D):
            pos = cms._positions_np(h, d)
            for q in range(Q):
                hits[:, d, q] += np.bincount(
                    cell[pos == cms.qpos[d, q]], minlength=n_cells)
        for q, item in enumerate(CMS_QUERY):
            exact[:, q] += np.bincount(cell[items == item],
                                       minlength=n_cells)
    hits = hits.reshape(n_panes, NCH, D, Q)
    exact = exact.reshape(n_panes, NCH, Q)
    events = events.reshape(n_panes, NCH)
    want_k, want_e, want_v, want_x = [], [], [], []
    for p in range(n_panes + k - 1):
        qs = list(range(max(0, p - k + 1), min(p, n_panes - 1) + 1))
        present = np.flatnonzero(events[qs].sum(axis=0))
        want_k.append(present)
        want_e.append(np.full(len(present), (p + 1) * CMS_SLIDE_MS))
        want_v.append(hits[qs].sum(axis=0)[present].min(axis=1))
        want_x.append(exact[qs].sum(axis=0)[present])
    wk_, we_, wv_, wx_ = (np.concatenate(a) for a in
                          (want_k, want_e, want_v, want_x))
    o = np.lexsort((we_, wk_))
    wk_, we_, wv_, wx_ = wk_[o], we_[o], wv_[o], wx_[o]
    gk, ge, gv = _sorted_rows(cols)
    check(len(gk) == len(wk_) and np.array_equal(gk, wk_)
          and np.array_equal(ge, we_) and np.array_equal(gv, wv_),
          f"countmin job: {len(gk)} rows, numpy {len(wk_)}; the rows "
          f"differ from numpy's Count-Min")
    check(bool((gv >= wx_).all()), "countmin job: an estimate under-counts")
    first = np.flatnonzero((wk_ == 0) & (we_ == CMS_SIZE_MS))[0]
    return len(gk), int(gv[first, 0]), int(wx_[first, 0])


# ------------------------------------- the reduces: min, max, mean, generic
#
# Three jobs: maxprice (nexmark q7's MAX(price), keyed per auction as q5
# keys it, HOP(2 s, 10 s), the sparse job's capacity and probe length),
# mean (the mean price per bidder over 1M integer bidders, 10 s tumbling
# windows, the direct layout) and late-reduce (the north star's traffic
# with a generic reduce and allowed lateness).

PRICE_SALT, AUCTION_SALT = 0x9A1CE, 0xA0C7
BIDDER_SALT, LATE_SALT = 0xB1DD, 0x1A7E
MEAN_CAPACITY = 1 << 20       # >= the 1M bidders: the direct layout
MEAN_WINDOW_MS = 10_000
MEAN_RING = 8                 # the executor's auto ring at k = 1
LATE_WINDOW_MS, LATE_LATENESS_MS, LATE_OOO_MS = 5_000, 2_000, 500
LATE_SHARE, LATE_MAX_MS = 0.05, 3_000
LATE_CAPACITY = 1 << 21       # 1M keys in the hash layout: load 0.48
LATE_RING = 8                 # the executor's auto ring: 2 + 2.5 s / 5 s + 2


def unit_draw(idx: np.ndarray, salt: int) -> np.ndarray:
    """A uniform float64 in [0, 1) from a hash of each event's index."""
    return (splitmix64(idx + salt) >> np.uint64(11)).astype(np.float64) \
        / float(1 << 53)


def bid_price(idx: np.ndarray) -> np.ndarray:
    """nexmark's PriceGenerator: round(10^(6u) * 100) cents, float32."""
    return np.round(10.0 ** (6.0 * unit_draw(idx, PRICE_SALT))
                    * 100.0).astype(np.float32)


def maxprice_gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    u = (unit_draw(idx, AUCTION_SALT) * N_KEYS).astype(np.int64)
    return {"auction": sparse_ids(u), "price": bid_price(idx)}, \
        idx // EVENTS_PER_MS


def mean_gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    bidder = (unit_draw(idx, BIDDER_SALT) * N_KEYS).astype(np.int64)
    return {"bidder": bidder, "price": bid_price(idx)}, idx // EVENTS_PER_MS


def late_ts(idx: np.ndarray) -> np.ndarray:
    """The north star's event time, 5 % of the events moved back by a
    uniform 0-3 s (both draws a hash of the event's index)."""
    ts = idx // EVENTS_PER_MS
    late = unit_draw(idx, LATE_SALT) < LATE_SHARE
    back = (unit_draw(idx, LATE_SALT + 1) * LATE_MAX_MS).astype(np.int64)
    return np.where(late, np.maximum(ts - back, 0), ts)


def late_gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    keys = (idx * 2862933555777941757) % N_KEYS
    return {"key": keys, "v": np.ones(n, np.float32), "ts": late_ts(idx)}, \
        None


def reduce_env(device, capacity, config=None, parallelism=1):
    env = StreamExecutionEnvironment(Configuration(dict({
        "keys.reverse-map": False,
        "window.fires-per-step": FIRES_PER_STEP,
        "pipeline.ring-depth": RING_DEPTH,
        "state.probe-len": PROBE_LEN,
    }, **(config or {}))), device=device)
    env.set_parallelism(parallelism)
    env.set_max_parallelism(MAX_PARALLELISM)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(capacity)
    env.batch_size = BATCH
    return env


def maxprice_job(device, total):
    """key_by(auction).time_window(10 s, 2 s).max(price)."""
    env = reduce_env(device, SPARSE_CAPACITY)
    sink = ColumnarCollectSink()
    (env.add_source(GeneratorSource(maxprice_gen, total=total))
     .key_by(lambda c: c["auction"])
     .time_window(SPARSE_SIZE_MS, SPARSE_SLIDE_MS)
     .max(lambda c: c["price"]).add_sink(sink))
    return _timed_job(env, "chip-smoke-maxprice", sink)


def mean_job(device, total):
    """key_by(bidder).time_window(10 s).mean(price), direct layout."""
    env = reduce_env(device, MEAN_CAPACITY)
    sink = ColumnarCollectSink()
    (env.add_source(GeneratorSource(mean_gen, total=total))
     .key_by(lambda c: c["bidder"]).time_window(MEAN_WINDOW_MS)
     .mean(lambda c: c["price"]).add_sink(sink))
    return _timed_job(env, "chip-smoke-mean", sink)


def late_job(device, total, parallelism=1):
    """time_window(5 s).allowed_lateness(2 s).reduce(a + b) over the north
    star's traffic, 5 % of it up to 3 s late, watermark 500 ms behind, at
    ``parallelism`` shards."""
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    env = reduce_env(device, LATE_CAPACITY, parallelism=parallelism)
    sink = ColumnarCollectSink()
    (env.add_source(GeneratorSource(late_gen, total=total))
     .assign_timestamps_and_watermarks(
         lambda c: c["ts"],
         WatermarkStrategy.for_bounded_out_of_orderness(LATE_OOO_MS))
     .key_by(lambda c: c["key"]).time_window(LATE_WINDOW_MS)
     .allowed_lateness(LATE_LATENESS_MS)
     .reduce(lambda a, b: a + b, extractor=lambda c: c["v"], neutral=0.0)
     .add_sink(sink))
    return _timed_job(env, "chip-smoke-late-reduce", sink)


def _rows_by_window(cols):
    kid = cols["key_id"].astype(np.uint64)
    end = cols["window_end_ms"].astype(np.int64)
    order = np.lexsort((kid, end))
    return kid[order], end[order], np.asarray(cols["value"])[order]


def check_maxprice_rows(cols, total):
    """Every (auction, window, max price) row against numpy: per pane each
    auction's max, then each window's max over its 5 panes. Exact: max
    picks an input."""
    k = SPARSE_SIZE_MS // SPARSE_SLIDE_MS
    per_pane = EVENTS_PER_MS * SPARSE_SLIDE_MS
    n_panes = -(-total // per_pane)
    panes = []
    for p in range(n_panes):
        c, _ = maxprice_gen(p * per_pane, min(per_pane, total - p * per_pane))
        uk, inv = np.unique(c["auction"].view(np.uint64),
                            return_inverse=True)
        mx = np.full(len(uk), -np.inf, np.float32)
        np.maximum.at(mx, inv, c["price"])
        panes.append((uk, mx))
    kid, end, val = _rows_by_window(cols)
    bounds = np.searchsorted(end, (np.arange(n_panes + k) + 1)
                             * SPARSE_SLIDE_MS, side="left")
    for e in range(n_panes + k - 1):
        ks = [panes[q] for q in range(max(0, e - k + 1), min(e + 1, n_panes))]
        uk, inv = np.unique(np.concatenate([a for a, _ in ks]),
                            return_inverse=True)
        mx = np.full(len(uk), -np.inf, np.float32)
        np.maximum.at(mx, inv, np.concatenate([m for _, m in ks]))
        a, b = bounds[e], bounds[e + 1]
        check(b - a == len(uk) and np.array_equal(kid[a:b], uk)
              and np.array_equal(val[a:b], mx),
              f"maxprice job: the rows of the window ending at pane {e} "
              f"differ from numpy's")
    check(bounds[n_panes + k - 1] == len(kid),
          "maxprice job: rows past the last window")
    return len(kid)


def check_mean_rows(cols, total, chunk=1 << 22):
    """Every (bidder, window, mean price) row against numpy's float64 mean
    of the same float32 prices, at rtol 1e-5 (the port sums in float32)."""
    n_win = -(-total // (EVENTS_PER_MS * MEAN_WINDOW_MS))
    s = np.zeros(n_win * N_KEYS)
    cnt = np.zeros(n_win * N_KEYS)
    for off in range(0, total, chunk):
        c, ts = mean_gen(off, min(chunk, total - off))
        g = (ts // MEAN_WINDOW_MS) * N_KEYS + c["bidder"]
        s += np.bincount(g, weights=c["price"].astype(np.float64),
                         minlength=len(s))
        cnt += np.bincount(g, minlength=len(s))
    have = np.nonzero(cnt)[0]
    kid, end, val = _rows_by_window(cols)
    check(len(kid) == len(have), f"mean job: {len(kid)} rows, numpy "
                                 f"{len(have)}")
    want_key = (have % N_KEYS).astype(np.uint64)
    want_end = (have // N_KEYS + 1) * MEAN_WINDOW_MS
    check(np.array_equal(kid, want_key) and np.array_equal(end, want_end),
          "mean job: the (bidder, window) rows differ from numpy's")
    want = s[have] / cnt[have]
    rel = float(np.max(np.abs(val.astype(np.float64) - want) / want))
    check(rel <= 1e-5, f"mean job: rel err {rel} against numpy's mean")
    return len(kid), rel


def late_reference(total):
    """numpy's late-reduce: per batch (the source's cut), the watermark the
    batch meets (the earlier batches' newest event time - 500 - 1); a
    record drops when its window's end - 1 + 2 s <= that watermark, counts
    as a late-but-allowed record when its window had fired (end - 1 <=
    that watermark), and otherwise on time. Returns (dropped, the sum per
    (key, window) of the kept records, the (key, window) pairs that got a
    late-but-allowed record), keyed key * n_windows + window."""
    n_win = -(-(total // EVENTS_PER_MS + 1) // LATE_WINDOW_MS) + 1
    sums = np.zeros(N_KEYS * n_win)
    lated = np.zeros(N_KEYS * n_win, bool)
    dropped, newest = 0, None
    for off in range(0, total, BATCH):
        c, _ = late_gen(off, min(BATCH, total - off))
        ts = c["ts"]
        w = ts // LATE_WINDOW_MS
        end = (w + 1) * LATE_WINDOW_MS
        keep = np.ones(len(ts), bool)
        late = np.zeros(len(ts), bool)
        if newest is not None:
            wm = newest - LATE_OOO_MS - 1
            keep = end - 1 + LATE_LATENESS_MS > wm
            late = keep & (end - 1 <= wm)
        dropped += int((~keep).sum())
        g = c["key"] * n_win + w
        sums += np.bincount(g[keep], minlength=len(sums))
        lated[g[late]] = True
        newest = int(ts.max()) if newest is None else max(newest,
                                                          int(ts.max()))
    return dropped, sums, lated, n_win


def check_late_rows(cols, total, dropped_late):
    """The late-reduce job's rows: the last row of each (key, window)
    equals numpy's sum of its records not beyond the lateness; the late
    drops equal numpy's count; the (key, window) pairs with re-fire rows
    are exactly those a late-but-allowed record reached."""
    dropped, sums, lated, n_win = late_reference(total)
    check(dropped_late == dropped,
          f"late-reduce job: {dropped_late} late drops, numpy {dropped}")
    g = cols["key_id"].astype(np.int64) * n_win + \
        cols["window_end_ms"].astype(np.int64) // LATE_WINDOW_MS - 1
    val = np.asarray(cols["value"], np.float64)
    last = np.full(len(sums), np.nan)
    last[g] = val                       # later rows overwrite earlier ones
    n_rows = np.bincount(g, minlength=len(sums))
    have = np.nonzero(sums)[0]
    check(np.array_equal(np.nonzero(n_rows)[0], have),
          "late-reduce job: its (key, window) rows differ from numpy's")
    check(np.array_equal(last[have], sums[have]),
          "late-reduce job: a window's last row differs from numpy's sum")
    refired = n_rows > 1
    check(np.array_equal(refired, lated),
          f"late-reduce job: {int(refired.sum())} windows re-fired, "
          f"{int(lated.sum())} got a late record")
    return len(g), int(refired.sum()), int((n_rows - 1).clip(0).sum())


# ------------------------------------- the reduces: kernels (phase 3)

def bits_err(a, b) -> float:
    """Elements whose bits differ (float tensors compared as int32 words:
    signed zeros and NaN payloads count), across lists of tensors."""
    pairs = zip(a, b) if isinstance(a, (tuple, list)) else [(a, b)]
    err = 0.0
    for x, y in pairs:
        if x.shape != y.shape:
            return float("inf")
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        err += float((x != y).sum())
    return err


def neutral_plane(dev, C, R, W, neutral, density, seed, values):
    """A packed plane [C*R, W+1]: the neutral everywhere, ``values(n)``
    (float32 [n, W]) and the touch marker in a ``density`` share of the
    cells (marker 1 for add, 0 for min and max)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    touch = torch.rand(R * C, generator=g) < density
    acc = torch.full((R * C, W + 1), float(neutral))
    n = int(touch.sum())
    acc[touch, :W] = values(n, g)
    acc[touch, W] = 1.0 if neutral == 0 else 0.0
    return acc.to(dev)


def _prices(n, g):
    u = torch.rand(n, 1, generator=g, dtype=torch.float64)
    return torch.round(10.0 ** (6.0 * u) * 100.0).float()


def _mean_pairs(n, g):
    """[sum, count] cells of small integers: every float32 sum on the
    plane stays exact (below 2^24) whatever order the card adds in."""
    c = torch.randint(1, 40, (n,), generator=g).float()
    return torch.stack([torch.randint(1, 100, (n,), generator=g).float()
                        * c, c], 1)


FLT_MAX = float(np.finfo(np.float32).max)


def case_scatter_reduce(dev, kind, shape, full):
    """G3 with a min or max combine or a W = 2 sum. ``maxprice`` (max, the
    sparse job's lanes and the full table's slots, C = 2^21, R = 12, k =
    5) and ``mean`` (W = 2 [price, 1] pairs, the direct layout, C = 2^20,
    R = 8): ``main`` the job's batch; ``edge`` also a fifth of the lanes on
    one hot slot, negative values, +-0.0 and NaN (min at the maxprice
    shapes), and the lateness fresh marking (panes at or before
    fired_through set their cells' flags)."""
    if shape == "maxprice":
        C, R, k, slide, op = (SPARSE_CAPACITY, SPARSE_RING,
                              SPARSE_SIZE_MS // SPARSE_SLIDE_MS,
                              SPARSE_SLIDE_MS, "max" if kind == "main"
                              else "min")
        inp = sparse_lane_inputs(dev, BATCH, kind)
    else:
        C, R, k, slide, op = MEAN_CAPACITY, MEAN_RING, 1, MEAN_WINDOW_MS, \
            "add"
        inp = lane_inputs(dev, C, BATCH, slide, kind)
    B = BATCH
    pane, kg, live, stats = kernels.route_lanes_plain(
        inp["hi"], inp["lo"], inp["ts"], inp["valid"], inp["watermark"],
        inp["purged_through"], slide=slide, k=k, maxp=MAX_PARALLELISM,
        kg_start=0, kg_end=MAX_PARALLELISM - 1)
    max_pane = torch.maximum(torch.tensor(PANE_NONE, dtype=torch.int32,
                                          device=dev), stats[1])
    g = torch.Generator(device="cpu").manual_seed(17)
    W = 1 if shape == "maxprice" else 2
    neutral = {"min": FLT_MAX, "max": -FLT_MAX, "add": 0.0}[op]
    vals = (_prices(B, g)[:, 0] if W == 1 else
            torch.stack([torch.randint(1, 100, (B,), generator=g).float(),
                         torch.ones(B)], 1))
    if shape == "maxprice":
        inside = live & (pane >= max_pane - (R - 1))
        slot, _ok, _n = kernels.hash_upsert(full.clone(), inp["hi"],
                                            inp["lo"], inside,
                                            probe_len=PROBE_LEN)
    else:
        hi, lo = inp["hi"], inp["lo"]
        slot = torch.where((hi == 0) & (lo >= 0) & (lo < C), lo, C)
    fresh_kw = [{}, {}]
    if kind == "edge":
        hot = torch.rand(B, generator=g) < 0.2
        slot = torch.where(hot.to(dev), slot[0], slot)
        sign = torch.where(torch.rand(B, generator=g) < 0.5, -1.0, 1.0)
        vals = vals * (sign if W == 1 else sign[:, None])
        special = torch.tensor([0.0, -0.0, float("nan"), FLT_MAX, -FLT_MAX])
        pick = torch.randint(0, len(special), (B,), generator=g)
        edge_lane = torch.rand(B, generator=g) < 0.05
        if W == 1:
            vals = torch.where(edge_lane, special[pick], vals)
        fired = int(max_pane) - 2
        for d in fresh_kw:
            d.update(fresh=torch.zeros(C * R, dtype=torch.bool, device=dev),
                     fired_through=torch.tensor(fired, dtype=torch.int32,
                                                device=dev),
                     n_fresh=_zero_i32(dev))
    vals = vals.to(dev).contiguous()
    acc0 = neutral_plane(dev, C, R, W, neutral, 0.3, 5,
                         _prices if W == 1 else _mean_pairs)
    if kind == "edge":
        # a NaN and signed zeros already in the plane too
        acc0[:64:2, 0] = float("nan") if W == 1 else acc0[:64:2, 0]
    a1, a2 = acc0.clone(), acc0.clone()
    dirty1 = torch.zeros(MAX_PARALLELISM, dtype=torch.bool, device=dev)
    dirty2 = dirty1.clone()
    d1, d2 = _zero_i32(dev), _zero_i32(dev)
    lanes = (pane, kg, live, slot, vals, max_pane)
    kw = dict(C=C, R=R, op=op)
    kernels.scatter_update(a1, dirty1, d1, *lanes, **kw, **fresh_kw[0])
    kernels.scatter_update_plain(a2, dirty2, d2, *lanes, **kw, **fresh_kw[1])
    got = [a1, dirty1, d1] + list(fresh_kw[0].values())
    want = [a2, dirty2, d2] + list(fresh_kw[1].values())
    check(kind == "main" or int(fresh_kw[0]["n_fresh"]) > 0,
          "scatter_update: the edge batch marked no fresh cell")
    ok = live & (pane >= max_pane - (R - 1)) & (slot < C)
    flat = (torch.remainder(pane.long(), R) * C + slot.long())[ok]
    lib_idx = flat[:, None] * (W + 1) + torch.arange(W + 1, device=dev)
    lib_val = torch.cat([vals[ok].reshape(-1, W), torch.full(
        (flat.shape[0], 1), 1.0 if op == "add" else 0.0, device=dev)], 1)
    lib = {"max": "amax", "min": "amin", "add": "sum"}[op]
    vo_idx = lib_idx[:, :W].reshape(-1)
    vo_val = lib_val[:, :W].reshape(-1)
    if op == "add":   # the value columns and the marker in one call
        library = lambda: a2.view(-1).index_add_(0, lib_idx.reshape(-1),
                                                 lib_val.reshape(-1))
    else:
        library = lambda: a2.view(-1).scatter_reduce_(
            0, lib_idx.reshape(-1), lib_val.reshape(-1), lib,
            include_self=True)
    return {
        "err": bits_err(got, want),
        "run": lambda: kernels.scatter_update(a1, dirty1, d1, *lanes, **kw,
                                              **fresh_kw[0]),
        "plain": lambda: kernels.scatter_update_plain(a2, dirty2, d2,
                                                      *lanes, **kw,
                                                      **fresh_kw[1]),
        # the scatter of the value columns and the touch marker in one call
        # (no drop counting, lanes filtered before the timer)
        "library": library,
        # the earlier yardstick: the value columns alone, scatter-reduced
        "yardsticks": {"values_only": lambda: a2.view(-1).scatter_reduce_(
            0, vo_idx, vo_val, lib, include_self=True)},
        # pane, kg, live, slot, W values in; each touched cell read and
        # written once
        "bytes": B * (4 + 4 + 1 + 4 + 4 * W)
        + int(torch.unique(flat).numel()) * 4 * (W + 1) * 2,
    }


def case_clear_reduce(dev, kind, shape):
    """G2 with a reduce's neutral: ``max`` (the maxprice job's packed plane,
    -FLT_MAX neutral, C = 2^21, R = 12), ``min`` (the same shapes, +FLT_MAX),
    ``mean`` (W = 2, C = 2^20, R = 8),
    ``generic`` (the late-reduce job's split float plane and touched bytes,
    C = 2^21, R = 8, with its fresh rows). ``main``: one stale row;
    ``edge``: two rows, one evicted with unfired data, and (generic) fresh
    rows cleared on their own mask."""
    C, R, W, neutral, split = {
        "max": (SPARSE_CAPACITY, SPARSE_RING, 1, -FLT_MAX, False),
        "min": (SPARSE_CAPACITY, SPARSE_RING, 1, FLT_MAX, False),
        "mean": (MEAN_CAPACITY, MEAN_RING, 2, 0.0, False),
        "generic": (LATE_CAPACITY, LATE_RING, 1, 0.0, True)}[shape]
    g = torch.Generator(device="cpu").manual_seed(23)
    clear = torch.zeros(R, dtype=torch.bool, device=dev)
    evicted = torch.zeros(R, dtype=torch.bool, device=dev)
    clear[1] = True
    if kind == "edge":
        clear[5] = evicted[5] = True
    fresh_clear = None
    if split:
        touched0 = (torch.rand(R * C, generator=g) < 0.5).to(dev)
        acc0 = (torch.randint(1, 9, (R * C,), generator=g).float().to(dev)
                * touched0)
        fresh0 = (torch.rand(R * C, generator=g) < 0.02).to(dev)
        if kind == "edge":
            fresh_clear = torch.zeros(R, dtype=torch.bool, device=dev)
            fresh_clear[2] = True
    else:
        acc0 = neutral_plane(dev, C, R, W, neutral, 0.9, 29,
                             _prices if W == 1 else _mean_pairs)
        touched0 = fresh0 = None
    sides = []
    for _ in range(2):
        sides.append(dict(acc=acc0.clone(), d=_zero_i32(dev),
                          touched=None if touched0 is None
                          else touched0.clone(),
                          fresh=None if fresh0 is None else fresh0.clone()))
    kw = dict(C=C, R=R, neutral=neutral, fresh_clear=fresh_clear)

    def call(fn, s):
        fn(s["acc"], clear, evicted, s["d"], touched=s["touched"],
           fresh=s["fresh"], **kw)

    call(kernels.clear_rows, sides[0])
    call(kernels.clear_rows_plain, sides[1])
    flat = [[v for v in s.values() if v is not None] for s in sides]
    rows = clear.nonzero().reshape(-1)
    n_rows = int(clear.sum())
    width = (4 * W + 1) if split else 4 * (W + 1)
    return {
        "err": bits_err(flat[0], flat[1]),
        "run": lambda: call(kernels.clear_rows, sides[0]),
        "plain": lambda: call(kernels.clear_rows_plain, sides[1]),
        "library": lambda: sides[1]["acc"].view(R, -1).index_fill_(
            0, rows, neutral),
        # flagged rows written (values, touch column or bytes, fresh
        # bytes), evicted rows' touch read, masks read
        "bytes": n_rows * C * (width + (1 if split else 0))
        + int(evicted.sum()) * C * (1 if split else 4) + 3 * R,
    }


def clear_edge_checks(dev) -> dict:
    """G2's single grid-stride pass on the shapes its 16-byte stores make
    risky, each bit for bit (dropped_capacity included) against its plain
    version: mean's Wc = 3 plane at an odd C (rows off 16-byte alignment:
    the head and tail words) with an evicted row; every row flagged, some
    evicted; no row flagged; only the last row; min's +FLT_MAX neutral;
    the fresh plane alone; split float planes with a two-word neutral (the
    repeated pattern), touched bytes and fresh rows on their own mask;
    int32 split planes whose rows are not a multiple of 4 words; then the
    device kernels a call launches (torch.profiler): one. Returns a record
    nested under clear_rows."""
    g = torch.Generator(device="cpu").manual_seed(27)
    cases = [  # (label, C, R, W, neutral, split, clear, evicted, fresh)
        ("Wc 3, odd C, evicted", 100_003, 8, 2, 0.0, None, [2, 7], [2],
         None),
        ("every row, some evicted", 1 << 16, 8, 1, 0.0, None, list(range(8)),
         [1, 4, 6], None),
        ("no row", 1 << 16, 8, 1, 0.0, None, [], [], None),
        ("last row only", 70_001, 6, 1, 0.0, None, [5], [5], None),
        ("min neutral, Wc 3", 4_099, 4, 2, FLT_MAX, None, [0, 3], [3],
         None),
        ("fresh rows alone", 1 << 16, 8, 1, 0.0, None, [], [], [3, 7]),
        ("split float, vector neutral", 50_001, 8, 2, (0.0, -1e30),
         "float", [1, 6], [6], [2, 6]),
        ("split int32, odd words", 1_001, 4, 3, 0, "int", [0, 3], [0],
         None),
        ("split float, every row", 1 << 14, 4, 1, 0.0, "float",
         [0, 1, 2, 3], [2], [0, 1, 2, 3]),
    ]
    err, runs = 0.0, []
    for label, C, R, W, neutral, split, rows, ev, fr in cases:
        def flags(idx):
            f = torch.zeros(R, dtype=torch.bool)
            f[list(idx)] = True
            return f.to(dev)
        clear, evicted = flags(rows), flags(ev)
        fresh_clear = None if fr is None else flags(fr)
        fresh0 = (torch.rand(R * C, generator=g) < 0.3).to(dev)
        if split is None:
            acc0 = neutral_plane(dev, C, R, W, neutral, 0.6, len(runs),
                                 _mean_pairs if W == 2 else _prices)
            touched0 = None
        else:
            touched0 = (torch.rand(R * C, generator=g) < 0.5).to(dev)
            vals = torch.randint(1, 99, (R * C, W), generator=g)
            acc0 = (vals.to(torch.int32) if split == "int"
                    else vals.float()).to(dev)
            if W == 1:
                acc0 = acc0.reshape(R * C)
        sides = [dict(acc=acc0.clone(), d=_zero_i32(dev),
                      touched=None if touched0 is None else touched0.clone(),
                      fresh=fresh0.clone()) for _ in range(2)]
        kw = dict(C=C, R=R, neutral=neutral, fresh_clear=fresh_clear)

        def call(fn, sd, kw=kw, clear=clear, evicted=evicted):
            fn(sd["acc"], clear, evicted, sd["d"], touched=sd["touched"],
               fresh=sd["fresh"], **kw)

        call(kernels.clear_rows, sides[0])
        call(kernels.clear_rows_plain, sides[1])
        e = bits_err([v for v in sides[0].values() if v is not None],
                     [v for v in sides[1].values() if v is not None])
        check(e == 0.0, f"clear_rows ({label}) differs from its plain "
                        f"version: {e} elements")
        err = max(err, e)
        if label == "Wc 3, odd C, evicted":
            check(int(sides[1]["d"]) > 0, "clear_rows: the evicted row "
                                          "counted no touched key")
            runs.append(lambda sd=sides[0], c=call: c(kernels.clear_rows,
                                                      sd))
        else:
            runs.append(None)
        del sides
    n_launch, seen = launches_a_call(dev, [runs[0]] * 4)
    check(n_launch in (None, 1) and all("clear_kernel" in k for k in seen),
          f"G2: {n_launch} device kernels a call, not one: {seen}")
    return {"cases": len(cases), "max_abs_err": err,
            "kernels_a_call": n_launch, "shapes": [c[0] for c in cases]}


def route_edge_inputs(dev, B, seed, *, offset=0, invalid=False,
                      late=False, negative=False):
    """G1's lanes for an edge case: ``B`` lanes (as a view ``offset`` lanes
    into larger tensors), keys with a nonzero high word on 1 %, ticks in
    panes -2 .. 4 of a 1,000-tick slide (``negative``: down to INT32_MIN
    and across zero), 5 % invalid (``invalid``: all), a watermark in pane 1
    and the purge cursor at pane -1 (``late``: the watermark far ahead, so
    every valid lane is late)."""
    rng = np.random.default_rng(seed)
    n = B + offset
    hi = np.where(rng.random(n) < 0.01, rng.integers(1, 1 << 31, n),
                  0).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if negative:
        ts = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
        ts[: n // 2] = rng.integers(-5000, 5000, n // 2)
        ts[:4] = [-(1 << 31), (1 << 31) - 1, -1, 0][: min(4, n)]
    else:
        ts = rng.integers(-2000, 5000, n)
    valid = rng.random(n) >= (1.0 if invalid else 0.05)
    wm = (1 << 30) if late else 1500
    sl = slice(offset, offset + B)
    return dict(
        hi=_t(hi.view(np.int32), dev, torch.int32)[sl],
        lo=_t(lo.view(np.int32), dev, torch.int32)[sl],
        ts=_t(ts.astype(np.int32), dev, torch.int32)[sl],
        valid=_t(valid, dev, torch.bool)[sl],
        watermark=torch.tensor(wm, dtype=torch.int32, device=dev),
        purged_through=torch.tensor(-1, dtype=torch.int32, device=dev))


def route_edge_checks(dev) -> dict:
    """G1's one-launch grid-stride pass on the shapes its 4-lane groups, its
    divide by a multiply and a shift and its last-block fold make risky,
    each bit for bit (pane, kg, live, the four stats, the fill, the cold
    lanes) against its plain version, each alone, with the fill, with the
    residency mask and with both: B = 0 (the sentinels), 1, 3 and 1,001;
    a view one lane in (the scalar path); every lane invalid; every lane
    late; an owner range of one key group; negative ticks down to
    INT32_MIN at slides 1, 7 and 1,000 with lateness; maxp 100 (not a power
    of two) and 32,768; then calls in a row on one scratch (A, B, A, A's
    outputs the same both times) and the device kernels a call launches
    (torch.profiler): one. Returns a record nested under route_lanes."""
    cases = [  # (label, B, inputs, slide, k, L, maxp, kg range)
        ("B 0", 0, {}, 1000, 1, 0, 128, None),
        ("B 1", 1, {}, 1000, 1, 0, 128, None),
        ("B 3", 3, {}, 1000, 2, 0, 128, None),
        ("B 1001", 1001, {}, 1000, 1, 0, 128, None),
        ("view at lane 1", 100_001, dict(offset=1), 1000, 3, 0, 128, None),
        ("all invalid", 4096, dict(invalid=True), 1000, 1, 0, 128, None),
        ("all late", 4096, dict(late=True), 1000, 1, 0, 128, None),
        ("one key group", 65_536, {}, 1000, 1, 0, 128, (37, 37)),
        ("negative ticks, slide 1", 65_537, dict(negative=True), 1, 1, 0,
         128, None),
        ("negative ticks, slide 7, L 20", 65_536, dict(negative=True), 7, 2,
         20, 128, (3, 90)),
        ("negative ticks, slide 1000, L 500", 65_538, dict(negative=True),
         1000, 4, 500, 128, None),
        ("maxp 100", 65_536, {}, 1000, 1, 0, 100, (10, 60)),
        ("maxp 32768", BATCH, {}, WINDOW_MS, 1, 0, 1 << 15, (0, 20_000)),
    ]
    g = torch.Generator(device="cpu").manual_seed(41)
    err, runs = 0.0, {}
    for i, (label, B, extra, slide, k, L, maxp, kgr) in enumerate(cases):
        inp = route_edge_inputs(dev, B, 50 + i, **extra)
        args = (inp["hi"], inp["lo"], inp["ts"], inp["valid"],
                inp["watermark"], inp["purged_through"])
        lo_kg, hi_kg = kgr if kgr is not None else (0, maxp - 1)
        kw = dict(slide=slide, k=k, maxp=maxp, kg_start=lo_kg,
                  kg_end=hi_kg, L=L)
        res = (torch.rand(maxp, generator=g) < 0.5).to(dev)
        for mode in ("plain", "fill", "res", "fill+res"):
            fills = [torch.randint(0, 9, (maxp,), generator=g,
                                   dtype=torch.int32).to(dev)
                     if "fill" in mode else None]
            fills.append(None if fills[0] is None else fills[0].clone())
            r = res if "res" in mode else None
            got = list(kernels.route_lanes(*args, **kw, fill=fills[0],
                                           res=r))
            want = list(kernels.route_lanes_plain(*args, **kw,
                                                  fill=fills[1], res=r))
            if fills[0] is not None:
                got.append(fills[0])
                want.append(fills[1])
            e = bits_err(got, want)
            check(e == 0.0, f"route_lanes ({label}, {mode}) differs from "
                            f"its plain version: {e} elements")
            err = max(err, e)
        stats = want[3].tolist()
        if label == "B 0":
            check(stats == [0, PANE_NONE, 2**31 - 1, 0],
                  f"route_lanes (B 0): stats {stats}, not the sentinels")
        if label == "all late":
            check(stats[0] > 0 and stats[1] == PANE_NONE,
                  f"route_lanes (all late): stats {stats}")
        if label in ("B 1001", "view at lane 1"):
            runs[label] = (lambda a=args, kw=kw: kernels.route_lanes(*a,
                                                                     **kw))
    # A, B, A on one scratch
    first = [t.clone() for t in runs["B 1001"]()]
    runs["view at lane 1"]()
    again = bits_err(first, list(runs["B 1001"]()))
    check(again == 0.0, f"route_lanes: two calls on one scratch disagree "
                        f"({again} elements)")
    n_launch, seen = launches_a_call(dev, [runs["B 1001"]] * 4)
    check(n_launch in (None, 1) and all("route_lanes" in k for k in seen),
          f"G1: {n_launch} device kernels a call, not one: {seen}")
    return {"cases": len(cases) * 4 + 1, "max_abs_err": err,
            "scratch_twice_err": again, "kernels_a_call": n_launch,
            "shapes": [c[0] for c in cases]}


SIGNED_ZEROS = (0.0, -0.0)
MINMAX_SPECIALS = (0.0, -0.0, float("nan"), FLT_MAX, -FLT_MAX)


def update_edge_lanes(dev, B, W, seed, *, C, R, offset=0, hot=0.0,
                      specials=(), integer=True, count=False):
    """G3's lanes for an edge case: ``B`` lanes (a view ``offset`` lanes
    in), panes max_pane - R - 2 .. max_pane (the oldest three too old),
    10 % dead, slots over [0, C) with 3 % at C (no slot) and 1 % at -1, a
    ``hot`` share on one slot and pane; values small integers (``integer``:
    every sum exact in any order) or random floats with signs, 5 % of them
    one of ``specials``; None for ``count``."""
    rng = np.random.default_rng(seed)
    n = B + offset
    max_pane = 40
    pane = rng.integers(max_pane - R - 2, max_pane + 1, n)
    live = rng.random(n) >= 0.1
    slot = rng.integers(0, C, n)
    slot[rng.random(n) < 0.03] = C
    slot[rng.random(n) < 0.01] = -1
    kg = rng.integers(0, MAX_PARALLELISM, n)
    hot_lane = rng.random(n) < hot
    slot[hot_lane] = 5
    pane[hot_lane] = max_pane - 1
    if integer:
        vals = rng.integers(-9, 10, (n, W)).astype(np.float32)
    else:
        vals = (rng.standard_normal((n, W)) * 100).astype(np.float32)
    if specials:
        special = np.array(specials, np.float32)
        pick = rng.random((n, W)) < 0.05
        vals[pick] = special[rng.integers(0, len(special),
                                          int(pick.sum()))]
    sl = slice(offset, offset + B)
    values = None
    if not count:
        values = _t(vals if W > 1 else vals[:, 0], dev, torch.float32)[sl]
    return dict(pane=_t(pane.astype(np.int32), dev, torch.int32)[sl],
                kg=_t(kg.astype(np.int32), dev, torch.int32)[sl],
                live=_t(live, dev, torch.bool)[sl],
                slot=_t(slot.astype(np.int32), dev, torch.int32)[sl],
                values=values,
                max_pane=torch.tensor(max_pane, dtype=torch.int32,
                                      device=dev))


def update_edge_checks(dev) -> dict:
    """G3's grid-stride pass of 4-lane groups and vector reductions on the
    shapes they make risky, each bit for bit (plane, kg_dirty,
    dropped_capacity, fresh flags, n_fresh) against its plain version:
    B = 1, 3 and 100,003 (a tail), a view one lane in (the scalar path);
    W = 1, 2 (cells at both 8-byte phases), 3 and 16; count; a hot cell
    taking 20 % of the lanes under add (small integers, signed zeros), min
    and max (random floats with signed zeros, NaN and +-FLT_MAX, a NaN and
    signed zeros already in the plane); a fresh plane; no-slot lanes with
    count_nofit on and off; then the device kernels a call launches
    (torch.profiler): one. Returns a record nested under scatter_update."""
    C, R = 1 << 16, 8
    cases = [  # (label, B, W, op, lanes' options, fresh, count_nofit)
        ("W1 B 1", 1, 1, "add", {}, False, True),
        ("W1 B 3", 3, 1, "add", {}, False, True),
        ("W1 odd B", 100_003, 1, "add", {}, False, True),
        ("W1 view at lane 1", 100_003, 1, "add", dict(offset=1), False,
         True),
        ("W2 both phases", 100_000, 2, "add", {}, False, True),
        ("W2 view at lane 1", 100_001, 2, "add", dict(offset=1), False,
         False),
        ("W3", 100_000, 3, "add", {}, False, True),
        ("W16", 50_001, 16, "add", {}, False, True),
        ("count", 100_002, 1, "add", dict(count=True), False, True),
        ("count W2", 100_000, 2, "add", dict(count=True), False, False),
        ("hot add", 100_000, 1, "add", dict(hot=0.2, specials=SIGNED_ZEROS),
         False, True),
        ("hot add W2", 100_000, 2, "add",
         dict(hot=0.2, specials=SIGNED_ZEROS), True, True),
        ("hot min", 100_000, 1, "min",
         dict(hot=0.2, specials=MINMAX_SPECIALS, integer=False), False,
         True),
        ("hot max", 100_001, 1, "max",
         dict(hot=0.2, specials=MINMAX_SPECIALS, integer=False), True,
         False),
        ("hot max W3", 100_000, 3, "max",
         dict(hot=0.2, specials=MINMAX_SPECIALS, integer=False), False,
         True),
        ("fresh", 100_000, 1, "add", {}, True, True),
        ("nofit counted off", 100_000, 1, "add", {}, False, False),
    ]
    err, runs = 0.0, {}
    for i, (label, B, W, op, opts, fresh, nofit) in enumerate(cases):
        lanes = update_edge_lanes(dev, B, W, 70 + i, C=C, R=R, **opts)
        neutral = {"min": FLT_MAX, "max": -FLT_MAX, "add": 0.0}[op]
        acc0 = neutral_plane(dev, C, R, W, neutral, 0.3, i,
                             _mean_pairs if W == 2 else
                             (lambda n, g, W=W: torch.randint(
                                 -9, 10, (n, W), generator=g).float()))
        if op != "add":
            acc0[:64:2, 0] = float("nan")
            acc0[1:64:4, 0] = -0.0
            acc0[3:64:4, 0] = 0.0
        sides = []
        for _ in range(2):
            sd = dict(acc=acc0.clone(),
                      dirty=torch.zeros(MAX_PARALLELISM, dtype=torch.bool,
                                        device=dev),
                      d=_zero_i32(dev))
            if fresh:
                sd.update(fresh=torch.zeros(C * R, dtype=torch.bool,
                                            device=dev),
                          fired_through=torch.tensor(37, dtype=torch.int32,
                                                     device=dev),
                          n_fresh=_zero_i32(dev))
            sides.append(sd)
        kw = dict(C=C, R=R, op=op, count_nofit=nofit)

        def call(fn, sd, lanes=lanes, kw=kw):
            extra = {k: sd[k] for k in ("fresh", "fired_through", "n_fresh")
                     if k in sd}
            fn(sd["acc"], sd["dirty"], sd["d"], lanes["pane"], lanes["kg"],
               lanes["live"], lanes["slot"], lanes["values"],
               lanes["max_pane"], **kw, **extra)

        call(kernels.scatter_update, sides[0])
        call(kernels.scatter_update_plain, sides[1])
        e = bits_err(list(sides[0].values()), list(sides[1].values()))
        check(e == 0.0, f"scatter_update ({label}) differs from its plain "
                        f"version: {e} elements")
        err = max(err, e)
        if label == "W2 both phases":
            ok = (lanes["live"] & (lanes["slot"] >= 0)
                  & (lanes["slot"] < C)
                  & (lanes["pane"] >= lanes["max_pane"] - (R - 1)))
            flat = (torch.remainder(lanes["pane"].long(), R) * C
                    + lanes["slot"].long())[ok]
            check(bool((flat % 2 == 0).any()) and bool((flat % 2).any()),
                  "scatter_update (W2): cells at one 8-byte phase only")
        if fresh:
            check(int(sides[1]["n_fresh"]) > 0,
                  f"scatter_update ({label}): no fresh cell marked")
        if label == "W1 odd B":
            check(int(sides[1]["d"]) > 0,
                  "scatter_update (W1 odd B): no lane dropped")
            runs[label] = lambda sd=sides[0], c=call: c(
                kernels.scatter_update, sd)
        del sides
    n_launch, seen = launches_a_call(dev, [runs["W1 odd B"]] * 4)
    check(n_launch in (None, 1)
          and all("scatter_update" in k for k in seen),
          f"G3: {n_launch} device kernels a call, not one: {seen}")
    return {"cases": len(cases), "max_abs_err": err,
            "kernels_a_call": n_launch, "shapes": [c[0] for c in cases]}


def _fire_setup(dev, shape, kind, g):
    """(acc, pane_ids, p_f, lane_ok, table, C, R, k, op, W, neutral, fresh,
    n_ontime) for a fire case (``maxprice``: max on the main inputs, min on
    the edge ones)."""
    if shape == "maxprice":
        C, R = SPARSE_CAPACITY, SPARSE_RING
        k, W = SPARSE_SIZE_MS // SPARSE_SLIDE_MS, 1
        op, neutral = (("max", -FLT_MAX) if kind == "main"
                       else ("min", FLT_MAX))
    elif shape == "mean":
        C, R, k, op, W, neutral = MEAN_CAPACITY, MEAN_RING, 1, "add", 2, 0.0
    else:   # a packed sum with lateness: F on-time + F re-fire lanes
        C, R, k, op, W, neutral = LATE_CAPACITY, LATE_RING, 1, "add", 1, 0.0
    acc = neutral_plane(dev, C, R, W, neutral, 0.7, 31,
                        _prices if W == 1 else _mean_pairs)
    pane_ids = torch.arange(40, 40 + R, dtype=torch.int32)
    pane_ids = pane_ids[torch.argsort(torch.remainder(pane_ids, R))].to(dev)
    table = torch.arange(C, dtype=torch.int64, device=dev)
    F = FIRES_PER_STEP
    fresh = n_ontime = None
    if shape == "fresh":
        ends = [47, 48, 41, 43]
        ok = [True, False, True, True]
        fresh = (torch.rand(R * C, generator=g) < 0.01).to(dev) & (
            acc[:, W] != neutral)
        n_ontime = F
    else:
        ends = [44 + k, 45 + k]
        ok = [True, False]
    p_f = torch.tensor(ends, dtype=torch.int32, device=dev)
    lane_ok = torch.tensor(ok, device=dev)
    return (acc, pane_ids, p_f, lane_ok, table, C, R, k, op, W, neutral,
            fresh, n_ontime)


_FIRE_SETUPS = {}    # (shape, kind) -> _fire_setup's tensors, G4 and G6


def case_fire_reduce(dev, kind, shape, compact):
    """G4 (``compact`` False) or G6 with a reduce's combine and width:
    ``maxprice`` (max, k = 5; min on the edge inputs), ``mean`` (W = 2)
    and ``fresh`` (a packed
    sum with allowed lateness: two on-time lanes, then two re-fire lanes
    emitting by the fresh plane). ``edge`` adds a second due lane and a
    ring row that holds another pane."""
    key = (shape, kind)
    if key not in _FIRE_SETUPS:   # the same inputs for G4 and G6
        g = torch.Generator(device="cpu").manual_seed(37)
        _FIRE_SETUPS[key] = _fire_setup(dev, shape, kind, g)
    (acc, pane_ids, p_f, lane_ok, table, C, R, k, op, W, neutral, fresh,
     n_ontime) = _FIRE_SETUPS[key]
    pane_ids = pane_ids.clone()
    if kind == "edge":
        lane_ok = torch.ones_like(lane_ok)
        pane_ids[int(p_f[0]) % R] = PANE_NONE
    Ft = p_f.shape[0]
    kw = dict(C=C, R=R, k=k, op=op, neutral=neutral, fresh=fresh,
              n_ontime=n_ontime)
    args = (acc, pane_ids, p_f, lane_ok)
    if compact:
        vs = (Ft, C) if W == 1 else (Ft, C, W)
        rows1 = (torch.empty(Ft, C, dtype=torch.int32, device=dev),
                 torch.empty(Ft, C, dtype=torch.int32, device=dev),
                 torch.empty(vs, dtype=torch.float32, device=dev))
        rows2 = tuple(torch.empty_like(r) for r in rows1)
        c1, v1 = kernels.fire_compact(*args, table, *rows1, **kw)
        c2, v2 = kernels.fire_compact_plain(*args, table, *rows2, **kw)
        got, want = [c1], [c2]
        for f in range(Ft):
            n = int(c2[f])
            got += [r[f, :n] for r in rows1]
            want += [r[f, :n] for r in rows2]
        run = lambda: kernels.fire_compact(*args, table, *rows1, **kw)
        plain = lambda: kernels.fire_compact_plain(*args, table, *rows2,
                                                   **kw)
    else:
        c1, v1 = kernels.fire_reduced(*args, **kw)
        c2, v2 = kernels.fire_reduced_plain(*args, **kw)
        got, want = [c1], [c2]
        run = lambda: kernels.fire_reduced(*args, **kw)
        plain = lambda: kernels.fire_reduced_plain(*args, **kw)
    # the lane sums add in another order on the card: rtol 1e-5
    rel = float(((v1.double() - v2.double()).abs()
                 / v2.double().abs().clamp_min(1.0)).max())
    present = [(int(e) - j) % R
               for e, o in zip(p_f.tolist(), lane_ok.tolist()) if o
               for j in range(k) if int(pane_ids[(int(e) - j) % R])
               == int(e) - j]
    n_present = len(present)
    n_rows = int(c2.sum())
    rows = torch.tensor(present, dtype=torch.long, device=dev)
    a3 = acc.view(R, C, W + 1)
    return {
        "err": bits_err(got, want), "float_rel": rel,
        "run": run, "plain": plain, "library": None,
        # a yardstick for G4's read, a part only: one Tensor.sum over the
        # present rows (gathered outside the timer)
        "yardsticks": {} if compact else {
            "read_sum": (lambda g=a3[rows]: g.sum())},
        # each present row of each due lane read once (and its fresh
        # bytes for a re-fire lane), the emitted rows written
        "bytes": n_present * C * 4 * (W + 1)
        + (n_present * C // 2 if fresh is not None else 0)
        + (n_rows * (16 + 4 * W) if compact else 0) + R * 4 + Ft * 13,
    }


def case_compact_reduce(dev, kind):
    """G9 on a max plane (-FLT_MAX neutral, touch column 0 where touched;
    a min plane, +FLT_MAX, on the edge inputs):
    the maxprice job's table shape, 2^21 slots probed 64 deep filled by G5
    with 1.9M ids, ``main`` 70 % alive, ``edge`` 80 % alive rebuilt with
    chains of 2, so that alive keys move to the ring. The alive test must
    read the touch column against the neutral: a dead key's cells are all
    -FLT_MAX, a live key's touch column 0. Held to the same logical cells
    (plane + ring) as the plain version, and no dead key placed."""
    probe, share = (PROBE_LEN, 0.7) if kind == "main" else (2, 0.8)
    R = SPARSE_RING
    C = SPARSE_CAPACITY
    table, acc_sum, pane_ids, alive = churned_state(
        dev, C, R, PROBE_LEN, int(0.9 * C), share, 4)
    touched = acc_sum[:, 1] != 0
    neutral = -FLT_MAX if kind == "main" else FLT_MAX
    acc = torch.where(touched[:, None],
                      torch.stack([acc_sum[:, 0] - 4.5,
                                   torch.zeros_like(acc_sum[:, 0])], 1),
                      neutral)
    ring0 = ring_of(dev, RING_LANES, 1000)
    r1, r2 = clone_ring(ring0), clone_ring(ring0)
    l1, l2 = _zero_i32(dev), _zero_i32(dev)
    kw = dict(R=R, probe_len=probe, neutral=neutral)
    acc1, tab1, _s1, ok1 = kernels.compact_table(acc, table, pane_ids, r1,
                                                 l1, **kw)
    acc2, tab2, _s2, ok2 = kernels.compact_table_plain(acc, table, pane_ids,
                                                       r2, l2, **kw)
    check(bool((ok1 <= alive).all()) and bool((ok2 <= alive).all()),
          "compact_table (min / max plane): placed a dead key")
    cells1 = logical_cells(tab1, acc1, r1, C, R, pane_ids, neutral)
    cells2 = logical_cells(tab2, acc2, r2, C, R, pane_ids, neutral)
    check(int(cells1[0].numel()) == int(
        (touched.view(R, C) & alive[None, :]).sum()) + 1000,
        "compact_table (min / max plane): cells lost or invented")
    ring_t, lost_t = clone_ring(ring0), _zero_i32(dev)
    return {
        # G5's CAS walk and the plain claim rounds may place other keys
        # (and, with chains of 2, another number of them): the cells of
        # the plane and the ring together must be the same
        "err": bits_err(list(cells1), list(cells2)),
        # the timed calls share one ring: the main table exports nothing
        "run": lambda: kernels.compact_table(acc, table, pane_ids, ring_t,
                                             lost_t, **kw),
        "plain": lambda: kernels.compact_table_plain(acc, table, pane_ids,
                                                     ring_t, lost_t, **kw),
        "library": None,
        "bytes": C * R * 8 * 2 + C * 8 * 2,
    }


def late_table_slots(dev, keys: np.ndarray, table):
    """The late-reduce job's keys' slots in ``table`` (G5 places them)."""
    hi = torch.zeros(len(keys), dtype=torch.int32, device=dev)
    lo = _t(keys.astype(np.int32), dev, torch.int32)
    slot, _ok, _n = kernels.hash_upsert(table, hi, lo,
                                        torch.ones_like(hi, dtype=torch.bool),
                                        probe_len=PROBE_LEN)
    return hi, lo, slot


def case_rep_update(dev, kind, phase):
    """G16 at the late-reduce job's shapes (C = 2^21 slots, R = 8, B =
    262,144): one batch of its traffic, sorted by cell with G10, gathered
    (rep_gather) and, after the sum's scan, set (rep_set, with the lane
    bookkeeping: drops, kg_dirty, fresh marking). ``main``: the job's
    batch; ``edge``: a fifth of the lanes on one hot key, dead and too-old
    lanes, panes at or before fired_through."""
    C, R = LATE_CAPACITY, LATE_RING
    B = BATCH
    off = 6 * LATE_WINDOW_MS * EVENTS_PER_MS
    cols, _ = late_gen(off, B)
    keys = cols["key"].copy()
    g = torch.Generator(device="cpu").manual_seed(41)
    if kind == "edge":
        keys[(torch.rand(B, generator=g) < 0.2).numpy()] = keys[0]
    table = hashtable.create(C, dev)
    hi, lo, slot = late_table_slots(dev, keys, table)
    pane = _t(cols["ts"] // LATE_WINDOW_MS, dev, torch.int32)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    max_pane = pane.max()
    if kind == "edge":
        live = (torch.rand(B, generator=g) < 0.95).to(dev)
        pane = torch.where((torch.rand(B, generator=g) < 0.01).to(dev),
                           pane - R, pane)
    kg = assign_to_key_group(route_hash(hi, lo), MAX_PARALLELISM).to(
        torch.int32)
    N = C * R
    ok = live & (pane >= max_pane - (R - 1)) & (slot < C)
    cell = torch.remainder(pane.long(), R) * C + slot.long()
    key = torch.where(ok, cell, N)
    order, key_s, seg_start = kernels.segment_sort(
        key, bits=segment._bits(N), seg_shift=0)
    values = _t(cols["v"], dev, torch.float32)
    acc0 = torch.zeros(N, device=dev)
    touched0 = torch.zeros(N, dtype=torch.bool, device=dev)
    # a third of the cells hold earlier records
    pre = (torch.rand(N, generator=g) < 0.3).to(dev)
    acc0[pre] = 3.0
    touched0 |= pre
    if phase == "gather":
        got = kernels.rep_gather(order, key_s, values, acc0, touched0, 0.0)
        want = kernels.rep_gather_plain(order, key_s, values, acc0, touched0,
                                        0.0)
        return {
            "err": bits_err(list(got), list(want)),
            "run": lambda: kernels.rep_gather(order, key_s, values, acc0,
                                              touched0, 0.0),
            "plain": lambda: kernels.rep_gather_plain(
                order, key_s, values, acc0, touched0, 0.0),
            # the yardstick: the gathers alone
            "library": lambda: (values.index_select(0, order.long()),
                                acc0.index_select(0, key_s.clamp_max(N - 1))),
            # order, key_s, the lane's value and its cell (+ touched) read;
            # two floats and a byte written a lane
            "bytes": B * (4 + 8 + 4 + 4 + 1 + 4 + 4 + 1),
        }
    v_s, old, old_t = kernels.rep_gather_plain(order, key_s, values, acc0,
                                               touched0, 0.0)
    prefix = segment.segmented_reduce_sorted(v_s, seg_start, torch.add)
    merged = torch.where(old_t, old + prefix, prefix).contiguous()
    fired = torch.tensor(int(max_pane) - (1 if kind == "edge" else 9),
                         dtype=torch.int32, device=dev)
    sides = []
    for _ in range(2):
        sides.append(dict(
            acc=acc0.clone(), touched=touched0.clone(),
            dirty=torch.zeros(MAX_PARALLELISM, dtype=torch.bool, device=dev),
            dropped=_zero_i32(dev),
            fresh=torch.zeros(N, dtype=torch.bool, device=dev),
            n_fresh=_zero_i32(dev)))

    def call(fn, s):
        fn(s["acc"], s["touched"], order, key_s, seg_start, merged,
           lanes=kernels.WindowLanes(pane, kg, live, slot, max_pane,
                                     s["dirty"], s["dropped"], s["fresh"],
                                     fired, s["n_fresh"]), C=C, R=R)

    call(kernels.rep_set, sides[0])
    call(kernels.rep_set_plain, sides[1])
    check(kind == "main" or int(sides[0]["n_fresh"]) > 0,
          "rep_set: the edge batch marked no fresh cell")
    rep = kernels._seg_end(seg_start) & (key_s < N)
    n_rep = int(rep.sum())
    dst = key_s[rep]
    src = merged[rep]
    return {
        "err": bits_err(list(sides[0].values()), list(sides[1].values())),
        "run": lambda: call(kernels.rep_set, sides[0]),
        "plain": lambda: call(kernels.rep_set_plain, sides[1]),
        # the yardstick: the set alone
        "library": lambda: sides[1]["acc"].index_copy_(0, dst, src),
        # the sorted keys, flags and merged values read; one cell and its
        # touched byte written a segment; pane, kg, slot, live read
        "bytes": B * (8 + 1 + 4 + 13) + n_rep * 5,
    }


def case_fresh_rows(dev, kind):
    """G2's fresh_rows at the late-reduce job's shapes (C = 2^21, R = 8):
    ``main`` the fresh flags a late record sets (1 % of one row), ``edge``
    rows full, empty and sparse."""
    C, R = LATE_CAPACITY, LATE_RING
    g = torch.Generator(device="cpu").manual_seed(43)
    share = torch.tensor([0.0, 0.01, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]) \
        if kind == "main" else torch.tensor([1.0, 0.0, 0.5, 1e-6, 0.3, 0.0,
                                             0.9, 0.01])
    fresh = (torch.rand(R, C, generator=g) < share[:, None]).reshape(-1).to(
        dev)
    return {
        "err": bits_err(kernels.fresh_rows(fresh, C=C, R=R),
                        kernels.fresh_rows_plain(fresh, C=C, R=R)),
        "run": lambda: kernels.fresh_rows(fresh, C=C, R=R),
        "plain": lambda: kernels.fresh_rows_plain(fresh, C=C, R=R),
        "library": lambda: fresh.view(R, C).sum(dim=1, dtype=torch.int32),
        "bytes": R * C + R * 4,
    }


def case_fire_pack(dev, kind):
    """G6's fire_pack at the late-reduce job's shapes (C = 2^21 slots, 2F =
    4 lanes): the dense fire of the generic reduce (its combine in torch)
    compacted. ``main``: one on-time lane emitting 48 % of the slots (the
    keys of a window) and re-fire lanes emitting 2 %; ``edge``: every lane
    due, one emitting nothing, one everything."""
    C, F = LATE_CAPACITY, 2 * FIRES_PER_STEP
    g = torch.Generator(device="cpu").manual_seed(47)
    share = ([0.48, 0.0, 0.02, 0.02] if kind == "main"
             else [0.48, 0.0, 1.0, 0.3])
    mask = (torch.rand(F, C, generator=g)
            < torch.tensor(share)[:, None]).to(dev)
    vals = torch.randint(1, 60, (F, C), generator=g).float().to(dev)
    lane_ok = torch.tensor([True, False, True, True] if kind == "main"
                           else [True] * F, device=dev)
    table = hashtable.create(C, dev)
    late_table_slots(dev, np.arange(N_KEYS), table)
    outs = [tuple(torch.empty(F, C, dtype=d, device=dev)
                  for d in (torch.int32, torch.int32, torch.float32))
            for _ in range(2)]
    c1, v1 = kernels.fire_pack(table, mask, vals, lane_ok, outs[0])
    c2, v2 = kernels.fire_pack_plain(table, mask, vals, lane_ok, outs[1])
    got, want = [c1], [c2]
    for f in range(F):
        n = int(c2[f])
        got += [r[f, :n] for r in outs[0]]
        want += [r[f, :n] for r in outs[1]]
    emitted = mask & lane_ok[:, None]
    n_rows = int(emitted.sum())
    m0 = torch.nonzero(emitted[0]).reshape(-1)
    # the one-call yardstick: the due lanes' [F, C] (hi, lo, value) payload
    # compacted by the emitted mask
    hi, lo = kernels.split_words(table)
    payload = torch.stack([hi.expand(F, C), lo.expand(F, C),
                           vals.view(torch.int32)], 2)
    keep = emitted[:, :, None]
    return {
        "err": bits_err(got, want),
        # the lane sums add in another order on the card: rtol 1e-5
        "float_rel": float(((v1.double() - v2.double()).abs()
                            / v2.double().abs().clamp_min(1.0)).max()),
        "run": lambda: kernels.fire_pack(table, mask, vals, lane_ok,
                                         outs[0]),
        "plain": lambda: kernels.fire_pack_plain(table, mask, vals, lane_ok,
                                                 outs[1]),
        "library": lambda: torch.masked_select(payload, keep),
        "yardsticks": {"index_select": lambda: vals[0].index_select(0, m0)},
        # the masks of the due lanes read, each emitted slot's value and
        # key word read and its row (12 B) written
        "bytes": int(lane_ok.sum()) * C + n_rows * (4 + 8 + 12),
    }


def case_route_late(dev, kind):
    """G1 with allowed lateness at the late-reduce job's shapes (slide =
    size = 5,000 ms, L = 2,000 ms): a batch of its traffic against a
    watermark that has passed the previous window's end by ``main`` 1 s
    (its late records re-fire) and ``edge`` 2.5 s (beyond the lateness:
    they drop), the purge cursor behind."""
    off = 6 * LATE_WINDOW_MS * EVENTS_PER_MS
    cols, _ = late_gen(off, BATCH)
    ts = cols["ts"]
    end = (int(ts.max()) // LATE_WINDOW_MS) * LATE_WINDOW_MS
    wm = end - 1 + (1000 if kind == "main" else 2500)
    inp = {
        "hi": torch.zeros(BATCH, dtype=torch.int32, device=dev),
        "lo": _t(cols["key"].astype(np.int32), dev, torch.int32),
        "ts": _t(ts.astype(np.int32), dev, torch.int32),
        "valid": torch.ones(BATCH, dtype=torch.bool, device=dev),
        "watermark": torch.tensor(wm, dtype=torch.int32, device=dev),
        "purged_through": torch.tensor(end // LATE_WINDOW_MS - 3,
                                       dtype=torch.int32, device=dev)}
    args = (inp["hi"], inp["lo"], inp["ts"], inp["valid"], inp["watermark"],
            inp["purged_through"])
    kw = dict(slide=LATE_WINDOW_MS, k=1, maxp=MAX_PARALLELISM, kg_start=0,
              kg_end=MAX_PARALLELISM - 1, L=LATE_LATENESS_MS)
    got = kernels.route_lanes(*args, **kw)
    want = kernels.route_lanes_plain(*args, **kw)
    check((int(got[3][0]) > 0) == (kind == "edge"),
          "route_lanes: the lateness cases' late drops are not as built")
    return {
        "err": bits_err(list(got), list(want)),
        "run": lambda: kernels.route_lanes(*args, **kw),
        "plain": lambda: kernels.route_lanes_plain(*args, **kw),
        "library": None,
        "bytes": BATCH * (4 + 4 + 4 + 1 + 4 + 4 + 1),
    }


def case_ring_mean(dev, kind):
    """G7 with mean's W = 2 value columns: the mean job's ring (RING_LANES)
    taking 1 % of a batch's lanes (``main``), or a ring of B/2 lanes 3/4
    full taking half of them, so that lanes are lost (``edge``)."""
    B = BATCH
    g = torch.Generator(device="cpu").manual_seed(53)
    share, O, fill = ((0.01, RING_LANES, 40_000) if kind == "main"
                      else (0.5, B // 2, 3 * B // 8))
    mask = (torch.rand(B, generator=g) < share).to(dev)
    hi, lo = (torch.randint(-2**31, 2**31 - 1, (B,), generator=g,
                            dtype=torch.int32).to(dev) for _ in range(2))
    pane = torch.randint(0, 15, (B,), generator=g, dtype=torch.int32).to(dev)
    vals = torch.stack([_prices(B, g)[:, 0], torch.ones(B)], 1).to(dev)
    ring0 = list(ring_of(dev, O, fill))
    ring0[3] = torch.zeros(O, 2, device=dev)
    ring0 = tuple(ring0)
    r1, r2 = clone_ring(ring0), clone_ring(ring0)
    l1, l2 = _zero_i32(dev), _zero_i32(dev)
    kernels.ring_append(r1, l1, mask, hi, lo, pane, vals)
    kernels.ring_append_plain(r2, l2, mask, hi, lo, pane, vals)
    rt, lt = clone_ring(ring0), _zero_i32(dev)
    rp, lp = clone_ring(ring0), _zero_i32(dev)
    lanes = torch.cat([torch.stack([hi, lo, pane], 1),
                       vals.view(torch.int32)], 1)
    n = int(mask.sum())
    return {
        "err": bits_err(list(r1) + [l1], list(r2) + [l2]),
        "run": lambda: kernels.ring_append(rt, lt, mask, hi, lo, pane, vals),
        "plain": lambda: kernels.ring_append_plain(rp, lp, mask, hi, lo,
                                                   pane, vals),
        "library": lambda: torch.masked_select(lanes, mask[:, None]),
        "bytes": B + n * 20 * 2 + 8,
    }


# G6's tiles: 2,048 slots a block at W = 1 and 2, 512 beyond
# (csrc/fire_compact.cu: 8 warps of kRounds x 32 x kSpt slots)
G6_TILE, G6_SMALL_TILE = 2048, 512


def _fire_edge_inputs(dev, C, W, op, k, shape, seed):
    """A fire over F = 3 lanes of k-pane windows on an R = k + 2 ring: its
    plane (small integers where touched, the neutral elsewhere), pane ids,
    window ends, due lanes and a table of random key words. ``shape``:
    ``random`` (30 % of the cells touched and the last three slots of
    every row), ``last`` (lane 1's window touched at slot C - 1 alone),
    ``full`` (every cell touched, every lane due), ``none`` (no lane due)."""
    R, F = k + 2, 3
    g = torch.Generator(device="cpu").manual_seed(seed)
    neutral = {"add": 0.0, "min": FLT_MAX, "max": -FLT_MAX}[op]
    pane_ids = torch.arange(40, 40 + R, dtype=torch.int32)
    pane_ids = pane_ids[torch.argsort(torch.remainder(pane_ids, R))]
    ends = [39 + R, 38 + R, 37 + R]
    touch = torch.rand(R, C, generator=g) < 0.3
    touch[:, -3:] = True
    lane_ok = [True, True, False]
    if shape == "last":
        # lane 1's panes: ends[1] - k + 1 .. ends[1]; lane 0's newest stays
        for j in range(k):
            row = (ends[1] - j) % R
            touch[row] = False
            touch[row, C - 1] = True
    elif shape == "full":
        touch[:] = True
        lane_ok = [True] * F
    elif shape == "none":
        lane_ok = [False] * F
    acc = torch.full((R * C, W + 1), neutral)
    t = touch.reshape(-1)
    acc[t, :W] = torch.randint(-40, 41, (int(t.sum()), W),
                               generator=g).float()
    acc[t, W] = 1.0 if op == "add" else 0.0
    table = torch.randint(-2**62, 2**62, (C,), generator=g,
                          dtype=torch.int64)
    return (acc.to(dev), pane_ids.to(dev),
            torch.tensor(ends, dtype=torch.int32, device=dev),
            torch.tensor(lane_ok, device=dev), table.to(dev), R, neutral, g)


def _fires_err(c1, v1, rows1, c2, v2, rows2):
    """(bits that differ over the counts and each lane's prefix rows, the
    lane sums' relative error)."""
    got, want = [c1], [c2]
    for f in range(c2.shape[0]):
        n = int(c2[f])
        got += [r[f, :n] for r in rows1]
        want += [r[f, :n] for r in rows2]
    rel = float(((v1.double() - v2.double()).abs()
                 / v2.double().abs().clamp_min(1.0)).max())
    return bits_err(got, want), rel


def fire_compact_edge(dev, C, W, *, op="add", k=2, shape="random",
                      fresh=False, seed=0):
    """One fire_compact call against its plain version on an edge shape
    (``fresh``: lane 2 a re-fire lane emitting by a fresh plane). Returns
    (the kernel's call, bits that differ, the lane sums' relative error)."""
    acc, pane_ids, p_f, lane_ok, table, R, neutral, g = _fire_edge_inputs(
        dev, C, W, op, k, shape, seed)
    fr = n_ontime = None
    if fresh:
        fr = (torch.rand(R * C, generator=g) < 0.05).to(dev) & (
            acc[:, W] != neutral)
        n_ontime = 2
        lane_ok = torch.ones_like(lane_ok)
    F = p_f.shape[0]
    vs = (F, C) if W == 1 else (F, C, W)
    rows = [(torch.empty(F, C, dtype=torch.int32, device=dev),
             torch.empty(F, C, dtype=torch.int32, device=dev),
             torch.empty(vs, dtype=torch.float32, device=dev))
            for _ in range(2)]
    kw = dict(C=C, R=R, k=k, op=op, neutral=neutral, fresh=fr,
              n_ontime=n_ontime)
    args = (acc, pane_ids, p_f, lane_ok, table)

    def run():
        return kernels.fire_compact(*args, *rows[0], **kw), rows[0]

    (c1, v1), _ = run()
    c2, v2 = kernels.fire_compact_plain(*args, *rows[1], **kw)
    if shape == "none":
        check(int(c1.abs().sum()) == 0 and float(v1.abs().sum()) == 0.0,
              "fire_compact: a lane that is not due emitted")
    if shape == "full":
        check(c1.tolist() == [C] * F, f"fire_compact: full lanes {c1}")
    return (run, *_fires_err(c1, v1, rows[0], c2, v2, rows[1]))


def fire_pack_edge(dev, C, W, *, shape="random", count_only=False, seed=0):
    """One fire_pack call against its plain version on an edge shape: the
    dense fire of ``_fire_edge_inputs``' lanes (lane 1 emitting slot C - 1
    alone for ``last``). Returns (the kernel's call, bits that differ, the
    lane sums' relative error)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    F = 3
    mask = torch.rand(F, C, generator=g) < 0.3
    mask[:, -3:] = True
    ok = [True, True, False]
    if shape == "last":
        mask[1] = False
        mask[1, C - 1] = True
    elif shape == "full":
        mask[:] = True
        ok = [True] * F
    elif shape == "none":
        ok = [False] * F
    vals = torch.randint(-40, 41, (F, C) if W == 1 else (F, C, W),
                         generator=g).float().to(dev)
    mask, lane_ok = mask.to(dev), torch.tensor(ok, device=dev)
    table = torch.randint(-2**62, 2**62, (C,), generator=g,
                          dtype=torch.int64).to(dev)
    outs = [None, None] if count_only else [
        (torch.empty(F, C, dtype=torch.int32, device=dev),
         torch.empty(F, C, dtype=torch.int32, device=dev),
         torch.empty(vals.shape, dtype=torch.float32, device=dev))
        for _ in range(2)]

    def run():
        return kernels.fire_pack(table, mask, vals, lane_ok, outs[0]), \
            outs[0]

    (c1, v1), _ = run()
    c2, v2 = kernels.fire_pack_plain(table, mask, vals, lane_ok, outs[1])
    if count_only:
        return (run, *_fires_err(c1, v1, (), c2, v2, ()))
    return (run, *_fires_err(c1, v1, outs[0], c2, v2, outs[1]))


def launches_a_call(dev, calls) -> Tuple[Optional[int], dict]:
    """Device kernels one call launches, by torch.profiler over each of
    ``calls`` (None when the profiler records no device kernel), and how
    many of each name it recorded. The count a call rounds up: the
    profiler may miss a launch (it has recorded 3 of 4 of each of G6's
    two kernels in one session), while a call with two kernels shows
    twice as many, or a second name."""
    from torch.profiler import ProfilerActivity, profile as profiler

    if dev.type != "cuda":
        return None, {}
    torch.cuda.synchronize()
    with profiler(activities=[ProfilerActivity.CUDA]) as prof:
        for run in calls:
            run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "memcpy" not in e.name.lower()
             and "memset" not in e.name.lower()]
    seen = {}
    for name in names:
        seen[name[:80]] = seen.get(name[:80], 0) + 1
    if not names:
        return None, seen
    return -(-len(names) // len(calls)), seen


def fire_edge_checks(dev) -> dict:
    """G6's single pass on the shapes its tiling makes risky, each bit for
    bit against its plain version (the lane sums at rtol 1e-5): C at a tile
    ± 1 and ± 2 (odd C takes the scalar loads, even C the float4 cells of a
    W = 1 plane; C a multiple of 4 fire_pack's mask words), one emitting
    slot in the last tile, every lane emitting every slot, no lane due,
    min and max, a fresh plane's re-fire lane, W = 2, W = 3 and W = 16 at k
    = 64 (kMaxPanes), fire_pack with W = 3 and without rows; then two calls
    on one scratch (the epoch): A, B, A again, A's outputs the same both
    times; then the device kernels a call launches (torch.profiler): one.
    Returns {"fire_compact": {"edges": ...}, "fire_pack": {"edges": ...}}."""
    fc, fp = [], []
    T, t = G6_TILE, G6_SMALL_TILE
    for C in (T - 1, T + 1, T - 2, T + 2, 2 * T):
        for shape in ("random", "last"):
            fc.append((f"W1 C={C} {shape}", dict(C=C, W=1, shape=shape)))
    fc += [(f"W1 C={T + 2} {s}", dict(C=T + 2, W=1, shape=s))
           for s in ("full", "none")]
    fc += [(f"W1 C={T + 2} {op}", dict(C=T + 2, W=1, op=op))
           for op in ("min", "max")]
    fc += [(f"W1 C={C} fresh", dict(C=C, W=1, fresh=True))
           for C in (T + 2, T + 1)]
    fc += [(f"W2 C={C} {s}", dict(C=C, W=2, shape=s))
           for C in (T - 1, T + 1) for s in ("random", "last")]
    fc += [(f"W3 C={C} {s}", dict(C=C, W=3, shape=s))
           for C in (t - 1, t + 1) for s in ("random", "last", "full")]
    fc += [(f"W16 k=64 C={t + 1} {op}", dict(C=t + 1, W=16, k=64, op=op))
           for op in ("add", "max")]
    fc.append((f"W1 k=64 C={T + 2}", dict(C=T + 2, W=1, k=64)))
    for C in (T - 1, T + 1, T - 4, T + 4):
        for shape in ("random", "last"):
            fp.append((f"W1 C={C} {shape}", dict(C=C, W=1, shape=shape)))
    fp += [(f"W1 C={T + 4} {s}", dict(C=T + 4, W=1, shape=s))
           for s in ("full", "none")]
    fp.append((f"W1 C={T + 4} counts only",
               dict(C=T + 4, W=1, count_only=True)))
    fp += [(f"W3 C={C} {s}", dict(C=C, W=3, shape=s))
           for C in (t - 1, t + 1) for s in ("random", "last")]
    out, runs = {}, {}
    for name, edge, cases in (("fire_compact", fire_compact_edge, fc),
                              ("fire_pack", fire_pack_edge, fp)):
        bits, rel = 0.0, 0.0
        for i, (label, kw) in enumerate(cases):
            _run, b, r = edge(dev, seed=i, **kw)
            check(b == 0.0 and r <= 1e-5,
                  f"{name} ({label}) disagrees with its plain version: {b} "
                  f"elements differ, lane sums rel err {r}")
            bits, rel = max(bits, b), max(rel, r)
        # two calls in a row on one scratch: A, B, A
        kw = dict(C=T + 2 if name == "fire_compact" else T + 4, W=1)
        run_a, b_a, _ = edge(dev, seed=100, **kw)
        (c_a, v_a), rows_a = run_a()
        first = [c_a.clone(), v_a.clone()] + [r.clone() for r in rows_a]
        _run_b, b_b, r_b = edge(dev, seed=101, **kw)
        (c_a, v_a), rows_a = run_a()
        again = bits_err(first, [c_a, v_a] + list(rows_a))
        check(b_a == b_b == 0.0 and r_b <= 1e-5 and again == 0.0,
              f"{name}: two calls on one scratch disagree ({b_a}, {b_b}, "
              f"{again} elements)")
        runs[name] = run_a
        out[name] = {"edges": {"cases": len(cases) + 2,
                               "max_abs_err": bits, "max_rel_err": rel,
                               "scratch_twice_err": again,
                               "shapes": [label for label, _ in cases]}}
    # one profiler session over 4 calls of each entry point
    n_launch, seen = launches_a_call(dev, [runs["fire_compact"],
                                        runs["fire_pack"]] * 4)
    check(n_launch in (None, 1) and all("compact_kernel" in k for k in seen),
          f"G6: {n_launch} device kernels a call, not one: {seen}")
    for name in out:
        out[name]["edges"]["kernels_a_call"] = n_launch
    return out


def hold(name, make, timing, kinds=("main", "edge")):
    """Hold one kernel mode against its plain version on each input kind
    (bit for bit; a fire's float lane sums, which the card adds in another
    order, at rtol 1e-5) and time the main one: a record with the PERF.md
    numbers."""
    errs, rels, main = [], [], None
    for kind in kinds:
        c = make(kind)
        rel = c.get("float_rel", 0.0)
        check(c["err"] == 0.0 and rel <= 1e-5,
              f"{name} ({kind} inputs) disagrees with its plain version: "
              f"{c['err']} elements differ, lane sums rel err {rel}")
        errs.append(c["err"])
        rels.append(rel)
        if kind == "main":
            main = c
        else:
            del c
    rec = {"max_abs_err": max(errs), "max_rel_err": max(rels),
           "bound_ms": bound_ms(main["bytes"])}
    if timing:
        rec["ms"] = time_ms(main["run"])
        rec["plain_ms"] = time_ms(main["plain"], reps=3)
        rec["library_ms"] = (time_ms(main["library"])
                             if main["library"] is not None else None)
        for name_y, fn in main.get("yardsticks", {}).items():
            rec[f"{name_y}_ms"] = time_ms(fn)
    del main
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rec


def reduce_kernel_phase(dev, timing=True):
    """Hold the new kernel modes and G16 against their plain versions at
    the three reduce jobs' shapes. Returns {kernel: {mode: record}} for the
    modes of G1-G4, G6, G7 and G9, and {kernel: record} for fresh_rows,
    fire_pack, rep_gather and rep_set."""
    full = full_table(dev, SPARSE_CAPACITY, BATCH, report=False)
    modes = {
        "scatter_update": {
            "max": lambda kind: case_scatter_reduce(dev, kind, "maxprice",
                                                    full),
            "mean": lambda kind: case_scatter_reduce(dev, kind, "mean",
                                                     full)},
        "clear_rows": {s: (lambda kind, s=s: case_clear_reduce(dev, kind, s))
                       for s in ("max", "min", "mean", "generic")},
        "fire_reduced": {s: (lambda kind, s=s: case_fire_reduce(
            dev, kind, s, False)) for s in ("maxprice", "mean", "fresh")},
        "fire_compact": {s: (lambda kind, s=s: case_fire_reduce(
            dev, kind, s, True)) for s in ("maxprice", "mean", "fresh")},
        "compact_table": {"max": lambda kind: case_compact_reduce(dev,
                                                                  kind)},
        "route_lanes": {"lateness": lambda kind: case_route_late(dev, kind)},
        "ring_append": {"mean": lambda kind: case_ring_mean(dev, kind)},
    }
    out = {}
    for name, by_mode in modes.items():
        for mode, make in by_mode.items():
            out.setdefault(name, {})[mode] = part(
                f"3_kernels/reduce/{name}",
                lambda m=make, n=name, md=mode: hold(f"{n} ({md})", m,
                                                     timing))
    _FIRE_SETUPS.clear()
    del full
    out["fresh_rows"] = hold("fresh_rows", lambda k: case_fresh_rows(dev, k),
                             timing)
    out["fire_pack"] = hold("fire_pack", lambda k: case_fire_pack(dev, k),
                            timing)
    for phase in ("gather", "set"):
        out[f"rep_{phase}"] = hold(
            f"rep_{phase}", lambda k, p=phase: case_rep_update(dev, k, p),
            timing)
    for name, rec in part("3_kernels/reduce/edges",
                          lambda: fire_edge_checks(dev)).items():
        out[name].update(rec)
    out["clear_rows"]["edges"] = part("3_kernels/reduce/clear_edges",
                                      lambda: clear_edge_checks(dev))
    out["route_lanes"]["edges"] = part("3_kernels/reduce/route_edges",
                                       lambda: route_edge_checks(dev))
    out["scatter_update"]["edges"] = part("3_kernels/reduce/update_edges",
                                          lambda: update_edge_checks(dev))
    return out


# ------------------------------------------- phase 3, G1's fill, G17, G18

KG_EDGE_MAXP = 1 << 15        # Flink's largest max parallelism


def case_route_fill(dev, kind):
    """G1 with the key-group fill. ``main``: the north-star job's batch
    (B = 262,144, maxp 128); ``sparse``: the sparse job's; ``edge``: maxp
    32,768 and every lane on one key (one key group), with G1's edge lanes
    — dead, late by the watermark and by the purge cursor. Held exactly:
    pane, kg, live, the stats and the fill. Library: torch.bincount over
    G1's own kg with the lanes not owned moved to an extra bin."""
    if kind == "sparse":
        inp = sparse_lane_inputs(dev, BATCH, "main")
        slide, k, maxp = SPARSE_SLIDE_MS, SPARSE_SIZE_MS // SPARSE_SLIDE_MS, \
            MAX_PARALLELISM
    else:
        inp = lane_inputs(dev, N_KEYS, BATCH, WINDOW_MS, kind)
        slide, k = WINDOW_MS, 1
        maxp = MAX_PARALLELISM if kind == "main" else KG_EDGE_MAXP
    if kind == "edge":
        inp["hi"] = torch.zeros_like(inp["hi"])
        inp["lo"] = torch.full_like(inp["lo"], 7)
    args = (inp["hi"], inp["lo"], inp["ts"], inp["valid"], inp["watermark"],
            inp["purged_through"])
    kw = dict(slide=slide, k=k, maxp=maxp, kg_start=0, kg_end=maxp - 1)
    fill_g = torch.zeros(maxp, dtype=torch.int32, device=dev)
    fill_w = torch.zeros(maxp, dtype=torch.int32, device=dev)
    got = kernels.route_lanes(*args, **kw, fill=fill_g)
    want = kernels.route_lanes_plain(*args, **kw, fill=fill_w)
    if kind == "edge":
        check(int(got[3][0]) > 0 and not bool(inp["valid"].all())
              and int(fill_g.count_nonzero()) == 1,
              "route_lanes (kg fill): the edge lanes are not as built")
    idx = torch.where(inp["valid"], got[1], maxp).long()
    B = inp["hi"].shape[0]
    run_fill = torch.zeros(maxp, dtype=torch.int32, device=dev)
    return {
        "err": max_abs_err(list(got) + [fill_g], list(want) + [fill_w]),
        "run": lambda: kernels.route_lanes(*args, **kw, fill=run_fill),
        "plain": lambda: kernels.route_lanes_plain(*args, **kw,
                                                   fill=run_fill),
        "library": lambda: torch.bincount(idx, minlength=maxp + 1),
        "nofill": lambda: kernels.route_lanes(*args, **kw),
        "bytes": B * (4 + 4 + 4 + 1 + 4 + 4 + 1) + 4 * maxp,
    }


def occupancy_bytes(alive_rows, alive, col_bytes, fresh_rows=None):
    """The least bytes G17 moves on this data: each slot's touch cells up
    to its first touched row (all R when none), a fresh plane's the same,
    and the key of each alive slot."""
    n = int(alive_rows.sum()) * col_bytes + 8 * int(alive.sum())
    if fresh_rows is not None:
        n += int(fresh_rows.sum())
    return n


def _rows_to_first(mask2):
    """Per slot of a [R, C] bool: rows read up to the first True (R when
    none)."""
    R = mask2.shape[0]
    first = torch.where(mask2.any(0), mask2.int().argmax(0), R - 1)
    return first + 1


def case_kg_occupancy(dev, kind):
    """G17 over a window state. ``main``: the north-star job's (direct
    identity table, packed sum plane, C = 1M, R = 8, a third of the cells
    touched); ``sparse``: the sparse job's (hash table of the 1M ids in
    2^21 slots — half of them empty — packed count plane, R = 12);
    ``split``: the distinct job's split touched plane (C = 2^14, R = 12,
    10,004 channels); ``fresh``: the late-reduce job's split float planes
    with lateness (C = 2^21, R = 8, touched and fresh); ``edge``: maxp
    32,768 and every slot holding one key (one key group), a packed
    plane of C = 2^20, R = 8, and half the slots dead. Held exactly."""
    g = torch.Generator(device="cpu").manual_seed(17)
    maxp = KG_EDGE_MAXP if kind == "edge" else MAX_PARALLELISM
    kw = {}
    if kind in ("main", "edge"):
        C, R = (N_KEYS, RING_PANES) if kind == "main" else (1 << 20, 8)
        acc = packed_plane(dev, C, R, 0.33 if kind == "main" else 0.1)
        table = torch.arange(C, dtype=torch.int64, device=dev)
        if kind == "edge":
            table = torch.full((C,), 7, dtype=torch.int64, device=dev)
            dead = (torch.rand(C, generator=g) < 0.5).to(dev)
            acc.view(R, C, 2)[:, dead] = 0.0
        kw = dict(acc=acc, neutral=0.0)
        touch2 = acc.view(R, C, 2)[:, :, 1] != 0.0
        col = 4
    elif kind == "sparse":
        C, R = SPARSE_CAPACITY, SPARSE_RING
        table = full_table(dev, C, BATCH, report=False)
        acc = packed_plane(dev, C, R, 0.4)
        acc.view(R, C, 2)[:, table == EMPTY_WORD] = 0.0
        kw = dict(acc=acc, neutral=0.0)
        touch2 = acc.view(R, C, 2)[:, :, 1] != 0.0
        col = 4
    else:
        C, R = ((SKETCH_CAPACITY, DISTINCT_RING) if kind == "split"
                else (LATE_CAPACITY, LATE_RING))
        table = torch.full((C,), EMPTY_WORD, dtype=torch.int64)
        n_keys = BID_HOT + BID_COLD if kind == "split" else N_KEYS
        slots = torch.randperm(C, generator=g)[:n_keys]
        table[slots] = (torch.arange(n_keys, dtype=torch.int64) if
                        kind == "split" else torch.from_numpy(
                            sparse_ids(np.arange(n_keys)).view(np.int64)))
        table = table.to(dev)
        held = (table != EMPTY_WORD)
        touched = ((torch.rand(R * C, generator=g) < 0.3).to(dev)
                   & held.repeat(R))
        kw = dict(touched=touched)
        if kind == "fresh":
            kw["fresh"] = ((torch.rand(R * C, generator=g) < 0.02).to(dev)
                           & held.repeat(R))
        touch2 = touched.view(R, C)
        col = 1
    fresh2 = kw["fresh"].view(R, C) if "fresh" in kw else None
    alive = touch2.any(0) if fresh2 is None else (touch2 | fresh2).any(0)
    got = kernels.kg_occupancy(table, R=R, maxp=maxp, **kw)
    want = kernels.kg_occupancy_plain(table, R=R, maxp=maxp, **kw)
    check(int(got.sum()) == int(alive.sum()),
          f"kg_occupancy ({kind}): {int(got.sum())} alive slots counted, "
          f"{int(alive.sum())} alive")
    nbytes = occupancy_bytes(
        _rows_to_first(touch2 if fresh2 is None else touch2 | fresh2),
        alive, col,
        None if fresh2 is None else _rows_to_first(touch2 | fresh2)) \
        + 4 * maxp
    return {
        "err": max_abs_err(got, want),
        "run": lambda: kernels.kg_occupancy(table, R=R, maxp=maxp, **kw),
        "plain": lambda: kernels.kg_occupancy_plain(table, R=R, maxp=maxp,
                                                    **kw),
        "library": None,
        "bytes": nbytes,
    }


def _slot_inputs(dev, wm_before, wm_after, Ft, fill_on, g):
    """One slot's G18 inputs: G1's stats, activity, Ft fire lanes, the
    state's counters after the fire, the fill and the snapshot."""
    i32 = dict(dtype=torch.int32, device=dev)
    lane_valid = (torch.rand(Ft, generator=g) < 0.6).to(dev)
    counts = torch.where(lane_valid, torch.randint(
        0, N_KEYS, (Ft,), generator=g).to(dev), 0).to(torch.int32)
    late0, cap0 = 1234, 56
    return dict(
        lane_stats=torch.tensor([17, 3, 1, BATCH - 9], **i32),
        activity=torch.tensor(int(torch.randint(0, 999, (1,), generator=g)),
                              **i32),
        lane_valid=lane_valid, counts=counts,
        dropped_late=torch.tensor(late0 + 17, **i32),
        dropped_capacity=torch.tensor(cap0 + 5, **i32),
        ovf_n=torch.tensor(4096, **i32),
        fill=(torch.randint(0, 5000, (MAX_PARALLELISM,), generator=g).to(
            dev, torch.int32) if fill_on else None),
        watermark=torch.tensor(wm_after, **i32),
        snap=torch.tensor([wm_before, late0, cap0], **i32))


SLOT_EDGES = (
    # (wm_before, wm_after, Ft, fill): the first advance from the MIN
    # sentinel; a jump of more than 2^20 ticks; negative watermarks across
    # a pane; a watermark that stays put; kg-fill off with the 2F lanes of
    # a lateness drain; the end-of-stream jump to the MAX watermark
    (-(2**31) + 1, 130, FIRES_PER_STEP, True),
    (9_999, 9_999 + 3 * (1 << 20), FIRES_PER_STEP, True),
    (-12_001, -4_999, FIRES_PER_STEP, True),
    (-7, -7, FIRES_PER_STEP, True),
    (4_998, 10_002, 2 * FIRES_PER_STEP, False),
    (14_998, 2**31 - 4, FIRES_PER_STEP, True),
)


def case_slot_stats(dev, kind):
    """G18 (and its companion, slot_stats_begin) on one drain slot.
    ``main``: a north-star slot whose watermark crosses a window end (F = 2
    lanes, maxp 128); ``edge``: each of SLOT_EDGES, with and without the
    chained drain's deferred fire columns. Held exactly, row for row, and
    the begin kernel's snapshot likewise."""
    g = torch.Generator(device="cpu").manual_seed(18)
    edges = ((4_998, 5_129, FIRES_PER_STEP, True),) if kind == "main" \
        else SLOT_EDGES
    err = 0.0
    for wb, wa, Ft, fill_on in edges:
        inp = _slot_inputs(dev, wb, wa, Ft, fill_on, g)
        row_g = torch.full((9,), -1, dtype=torch.int32, device=dev)
        row_w = torch.full((9,), -1, dtype=torch.int32, device=dev)
        args = [inp[n] for n in ("lane_stats", "activity", "lane_valid",
                                 "counts", "dropped_late", "dropped_capacity",
                                 "ovf_n", "fill", "watermark", "snap")]
        for defer in ((False,) if kind == "main" else (False, True)):
            kernels.slot_stats(row_g, *args, slide=WINDOW_MS, defer=defer)
            kernels.slot_stats_plain(row_w, *args, slide=WINDOW_MS,
                                     defer=defer)
            err = max(err, max_abs_err(row_g, row_w))
        snap_g = torch.empty(3, dtype=torch.int32, device=dev)
        snap_w = torch.empty(3, dtype=torch.int32, device=dev)
        before = (inp["watermark"], inp["dropped_late"],
                  inp["dropped_capacity"])
        kernels.slot_stats_begin(*before, snap_g)
        kernels.slot_stats_begin_plain(*before, snap_w)
        err = max(err, max_abs_err(snap_g, snap_w))
    maxp = MAX_PARALLELISM
    row = torch.empty(9, dtype=torch.int32, device=dev)
    snap = torch.empty(3, dtype=torch.int32, device=dev)
    return {
        "err": err,
        "run": lambda: kernels.slot_stats(row, *args, slide=WINDOW_MS),
        "plain": lambda: kernels.slot_stats_plain(row, *args,
                                                  slide=WINDOW_MS),
        "begin": lambda: kernels.slot_stats_begin(*before, snap),
        "begin_plain": lambda: kernels.slot_stats_begin_plain(*before, snap),
        "library": None,
        # 4 stats, activity, Ft flags, Ft counts, late, cap, ovf_n,
        # watermark, the 3-int snap and maxp bins in; the 9-int row out
        "bytes": 16 + 4 + Ft + 4 * Ft + 16 + 12 + 4 * maxp + 36,
        "begin_bytes": 12 + 12,
    }


def telemetry_kernel_phase(dev, timing=True):
    """Hold G1's fill, G17 and G18 against their plain versions on the
    main and edge inputs, and time the main ones. Returns {"route_lanes":
    {"kg_fill": record}, "kg_occupancy": record, "slot_stats": record,
    "slot_stats_begin": record}; G1's fill record carries G1's time
    without the fill from the same inputs (``nofill_ms``) and G17's its
    times at the other jobs' states (``<job>_ms``)."""
    out = {}
    rec = hold("route_lanes (kg fill)", lambda k: case_route_fill(dev, k),
               False, kinds=("main", "sparse", "edge"))
    if timing:
        c = case_route_fill(dev, "main")
        rec["ms"] = time_ms(c["run"])
        rec["nofill_ms"] = time_ms(c["nofill"])
        rec["plain_ms"] = time_ms(c["plain"], reps=5)
        rec["library_ms"] = time_ms(c["library"])
        rec["library"] = "torch.bincount over G1's kg"
        c = case_route_fill(dev, "sparse")
        rec["sparse_ms"] = time_ms(c["run"])
        rec["sparse_nofill_ms"] = time_ms(c["nofill"])
        del c
    out["route_lanes"] = {"kg_fill": rec}
    occ = {}
    for kind in ("main", "sparse", "split", "fresh", "edge"):
        c = case_kg_occupancy(dev, kind)
        check(c["err"] == 0.0, f"kg_occupancy ({kind} inputs) disagrees "
                               f"with its plain version: {c['err']} bins")
        r = {"max_abs_err": c["err"], "bound_ms": bound_ms(c["bytes"])}
        if timing:
            r["ms"] = time_ms(c["run"])
            r["plain_ms"] = time_ms(c["plain"], reps=3)
        occ[kind] = r
        del c
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    rec = dict(occ["main"], library_ms=None,
               max_abs_err=max(r["max_abs_err"] for r in occ.values()))
    for kind in ("sparse", "split", "fresh"):
        rec[kind] = occ[kind]
    out["kg_occupancy"] = rec
    rec = hold("slot_stats", lambda k: case_slot_stats(dev, k), False)
    c = case_slot_stats(dev, "main")
    begin = {"max_abs_err": rec["max_abs_err"],
             "bound_ms": bound_ms(c["begin_bytes"]), "library_ms": None}
    if timing:
        rec["ms"] = time_ms(c["run"])
        rec["plain_ms"] = time_ms(c["plain"], reps=5)
        rec["library_ms"] = None
        begin["ms"] = time_ms(c["begin"])
        begin["plain_ms"] = time_ms(c["begin_plain"], reps=5)
    out["slot_stats"] = rec
    out["slot_stats_begin"] = begin
    return out


def fire_latency(m) -> dict:
    """A job's fire latency: p50 and p99 over its windows, in ms, with the
    sample count and the windows the samples weigh."""
    lat = m.fire_latency
    return {"p50": m.fire_latency_pct(50.0), "p99": m.fire_latency_pct(99.0),
            "samples": len(lat) if lat else 0,
            "windows": int(sum(n for n, _ in lat._samples)) if lat else 0}


TELEMETRY_CONFIG = {
    # the flight recorder exists only on the drains
    "pipeline.resident-loop": "on",
    "observability.drain-stats": True,
    "observability.drain-stats-every": 1,
    "observability.kg-stats": True,
    "observability.kg-stats-interval-ms": 0,
}


def live_key_groups(total, events_per_ms, window_ms, n_keys, maxp,
                    chunk=1 << 22):
    """numpy's bincount of the key groups of the keys that hold state at
    the end-of-stream flush: the keys of the last window's events (the
    windows before it fired and purged while the stream ran)."""
    last = (total - 1) // events_per_ms // window_ms
    first = last * window_ms * events_per_ms
    seen = np.zeros(n_keys, bool)
    for off in range(first, total, chunk):
        keys, _ts, _ = gen_batch(off, min(chunk, total - off), n_keys,
                                 events_per_ms)
        seen[keys] = True
    keys = torch.from_numpy(np.nonzero(seen)[0].astype(np.int32))
    kg = assign_to_key_group(route_hash(torch.zeros_like(keys), keys), maxp)
    return np.bincount(kg.numpy().astype(np.int64), minlength=maxp)


def check_telemetry(env, job, total, batch, events_per_ms, window_ms,
                    n_keys, maxp) -> dict:
    """The telemetry phase's checks against what the north-star job must
    have recorded; returns the numbers it checked."""
    m = job.metrics
    rep = env._pipeline_report()
    check(rep["available"] and rep["payload_fetches"] == rep["drains"]
          == m.resident_drains,
          f"pipeline report: {rep.get('payload_fetches')} payloads for "
          f"{m.resident_drains} drains")
    tot = rep["shards"][0]["totals"]
    check(tot["events"] == total and tot["late_dropped"] == 0
          and tot["nofit_dropped"] == 0,
          f"flight recorder totals {tot} against {total} events")
    drain_fires = m.fires - m.fire_step_fires
    check(tot["fired_keys"] == drain_fires,
          f"fired_keys {tot['fired_keys']} != the drains' fires "
          f"{drain_fires}")
    # the watermark after the first and the last batch (monotonous: the
    # batch's max tick - 1), and the end-of-stream flush to the MAX
    # watermark, counted with the recorder's jump clamp
    wm_first = (min(batch, total) - 1) // events_per_ms - 1
    wm_last = (total - 1) // events_per_ms - 1
    want_panes = (wm_last // window_ms - wm_first // window_ms
                  + panes_crossed(wm_last, 2**31 - 4, window_ms))
    check(tot["panes_advanced"] + m.fire_step_panes == want_panes,
          f"panes: {tot['panes_advanced']} in the drains + "
          f"{m.fire_step_panes} in watermark-only advances != {want_panes}")
    kg = env._kg_report(maxp)
    occ = np.zeros(maxp, np.int64)
    for r in kg["occupancy_top"]:
        occ[r["group"]] = r["count"]
    want_occ = live_key_groups(total, events_per_ms, window_ms, n_keys, maxp)
    check(np.array_equal(occ, want_occ)
          and kg["occupied_groups"] == int((want_occ > 0).sum()),
          f"occupancy differs from numpy's in "
          f"{int((occ != want_occ).sum())} groups")
    fill = sum(r["count"] for r in kg["fill_top"])
    n_batches = -(-total // batch)
    last_len = total - (n_batches - 1) * batch
    sampled = kg["fill_sampled_batches"]
    check(sampled > 0 and fill in (sampled * batch,
                                   (sampled - 1) * batch + last_len),
          f"fill sums to {fill} over {sampled} sampled batches of {batch}")
    return {"totals": tot, "levels": rep["shards"][0]["levels"],
            "drains": rep["drains"], "fire_step_fires": m.fire_step_fires,
            "fire_step_panes": m.fire_step_panes, "want_panes": want_panes,
            "occupied_groups": kg["occupied_groups"],
            "occupancy_keys": int(occ.sum()), "fill_sum": fill,
            "fill_sampled_batches": sampled,
            "latency_ms": rep["latency_ms"],
            "kg_heat_skew_ratio": rep["kg_heat"].get("skew_ratio")}


# ------------------------------------------------------------ profile

# ------------------------------------------------ CEP: G19, G20, two jobs

CEP_TOTAL = 400_000            # bench_configs.py:2915 (run_cep)
CEP_BATCH = 16_384             # bench_configs.py:276
CEP_KEYS = 1_000
CEP_SEED = 3
CEP_CAPACITY = 1 << 16         # the env's default slots, as the bench runs
# 20 s of event time, two within() horizons (8M, eight, until the script
# was cut back under 800 s)
CEPW_TOTAL = 2_000_000
CEPW_EVENTS_PER_MS = 100
CEPW_KEYS = 1_000_000
CEPW_CAPACITY = 1 << 22
CEPW_BATCH = Configuration().get(CoreOptions.BATCH_SIZE)   # 8,192
CEPW_WITHIN_MS = 10_000
CEPW_OOO_MS = 16               # run_cep_event_time's bounded out-of-orderness
CEPW_SAMPLE = 10_000           # keys whose rows the host NFA re-derives
CEPW_SEED = 8                  # --seed
# the columnar cep-within event: (key, id, sub, volume, name, ts, seq)
CW_KEY, CW_ID, CW_SUB, CW_VOL, CW_NAME, CW_TS, CW_SEQ = range(7)
CEP_KERNELS = ("hash_upsert", "segment_sort", "cep_scan")
CEPW_KERNELS = CEP_KERNELS + ("cep_expire",)


class CepEvent:
    """bench_configs.py's CEP event (``_cep_events``)."""

    __slots__ = ("name", "key", "ts")

    def __init__(self, name, key, ts):
        self.name = name
        self.key = key
        self.ts = ts


def cep_arrays(total, seed=CEP_SEED):
    """bench_configs.py:290-307's stream as arrays: names a, b, x, y at
    0.05, 0.05, 0.45, 0.45 and 1,000 keys from ``seed``."""
    rng = np.random.default_rng(seed)
    names = rng.choice(["a", "b", "x", "y"], total,
                       p=[0.05, 0.05, 0.45, 0.45])
    return names, rng.integers(0, CEP_KEYS, total)


def cep_events(total, seed=CEP_SEED):
    """``cep_arrays``' stream as events; returns (events, names, keys)."""
    names, keys = cep_arrays(total, seed)
    events = [CepEvent(n, k, i) for i, (n, k) in
              enumerate(zip(names.tolist(), keys.tolist()))]
    return events, names, keys


def cep_pattern():
    from flink_tpu_torch.cep import Pattern
    return (Pattern.begin("a").where(lambda e: e.name == "a")
            .followed_by("b").where(lambda e: e.name == "b"))


def cep_reference(names, keys) -> int:
    """numpy's count of ``a followedBy b`` matches in arrival order: for
    each b event, the a events of its key before it."""
    order = np.argsort(keys, kind="stable")
    k_s = keys[order]
    a_s = (names[order] == "a").astype(np.int64)
    b_s = names[order] == "b"
    before = np.cumsum(a_s) - a_s
    starts = np.r_[True, k_s[1:] != k_s[:-1]]
    first = np.maximum.accumulate(np.where(starts, np.arange(len(k_s)), 0))
    return int(((before - before[first]) * b_s).sum())


def cep_job(device, events, parallelism=1):
    """BASELINE #5 as bench_configs.py:264-287 runs it: processing time,
    batches of 16,384, select(1.0) into a CountingSink; at
    ``parallelism`` count-NFA shards."""
    from flink_tpu_torch.cep import CEP
    env = StreamExecutionEnvironment(Configuration(), device=device)
    env.set_parallelism(parallelism)
    env.batch_size = CEP_BATCH
    sink = CountingSink()
    stream = env.from_collection(events).key_by(lambda e: e.key)
    CEP.pattern(stream, cep_pattern()).select(lambda m: 1.0).add_sink(sink)
    return _timed_job(env, "chip-smoke-cep", sink)


class _SubEventType(type):
    """A columnar event is a tuple; a SubEvent is one whose ``sub`` column
    is set, so ``subtype(SubEvent)`` reads as the documentation's."""

    def __instancecheck__(cls, e):
        return bool(e[CW_SUB])


class SubEvent(metaclass=_SubEventType):
    pass


def cepw_gen(offset, n, seed=None):
    """The Getting Started pattern's events: 1M sparse keys (splitmix64 of
    a uniform index), ``id`` uniform in [0, 64), SubEvent with p 0.5,
    ``volume`` uniform in [0, 20), ``name`` "end" with p 0.1, 100 events a
    ms arriving up to 16 ms out of order; every draw a hash of the event's
    index salted by the seed."""
    salt = (CEPW_SEED if seed is None else seed) << 40
    idx = np.arange(offset, offset + n, dtype=np.int64)
    key = sparse_ids((unit_draw(idx, salt + 1) * CEPW_KEYS).astype(np.int64))
    back = (unit_draw(idx, salt + 6) * CEPW_OOO_MS).astype(np.int64)
    ts = np.maximum(idx // CEPW_EVENTS_PER_MS - back, 0)
    cols = {
        "key": key,
        "id": (unit_draw(idx, salt + 2) * 64).astype(np.int64),
        "sub": unit_draw(idx, salt + 3) < 0.5,
        "volume": unit_draw(idx, salt + 4) * 20.0,
        "name": np.where(unit_draw(idx, salt + 5) < 0.1, "end", "other"),
        "ts": ts,
        "seq": idx,
    }
    return cols, ts


def cepw_pattern():
    """docs/dev/libs/cep.md's Getting Started pattern (Flink 1.2)."""
    from flink_tpu_torch.cep import Pattern
    return (Pattern.begin("start").where(lambda e: e[CW_ID] == 42)
            .next("middle").subtype(SubEvent)
            .where(lambda e: e[CW_VOL] >= 10.0)
            .followed_by("end").where(lambda e: e[CW_NAME] == "end")
            .within(CEPW_WITHIN_MS))


def cepw_select(m):
    return (m["start"][CW_KEY], m["start"][CW_SEQ], m["middle"][CW_SEQ],
            m["end"][CW_SEQ])


def cepw_job(device, total, capacity=CEPW_CAPACITY, parallelism=1):
    """The pattern keyed by ``key``, in event time, from a columnar
    GeneratorSource through to_elements, at the port's default batch, at
    ``parallelism`` count-NFA shards."""
    from flink_tpu_torch.cep import CEP
    from flink_tpu_torch.runtime.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    env = StreamExecutionEnvironment(Configuration(), device=device)
    check(env.batch_size == CEPW_BATCH, f"cep-within job: batch "
          f"{env.batch_size}, the kernel phase times G19 at {CEPW_BATCH}")
    env.set_parallelism(parallelism)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(capacity)
    sink = CollectSink()
    stream = (env.add_source(GeneratorSource(cepw_gen, total=total))
              .assign_timestamps_and_watermarks(
                  lambda e: e[CW_TS],
                  WatermarkStrategy.for_bounded_out_of_orderness(
                      CEPW_OOO_MS))
              .key_by(lambda e: e[CW_KEY]))
    CEP.pattern(stream, cepw_pattern()).select(cepw_select).add_sink(sink)
    return _timed_job(env, "chip-smoke-cep-within", sink)


def cepw_columns(total, chunk=1 << 22):
    parts = [cepw_gen(off, min(chunk, total - off))[0]
             for off in range(0, total, chunk)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def cepw_reference(cols, pane_ms) -> np.ndarray:
    """numpy's matches over every key: events in (key, ts, arrival) order
    on pane-quantised timestamps; each start directly followed by a
    middle of its key within the horizon pairs with every later end of
    its key within the horizon of the start. Returns int64 rows [M, 4] of
    cepw_select's (key, start, middle, end seq), each key's in the host
    NFA's emission order: by end event, then by start (its partials stay
    in the order they started)."""
    order = np.lexsort((cols["seq"], cols["ts"], cols["key"]))
    key = cols["key"][order]
    qts = cols["ts"][order] // pane_ms * pane_ms
    start = cols["id"][order] == 42
    mid = cols["sub"][order] & (cols["volume"][order] >= 10.0)
    end = cols["name"][order] == "end"
    rank = np.cumsum(np.r_[True, key[1:] != key[:-1]])
    comp = rank.astype(np.int64) * (1 << 40) + qts
    n = len(key)
    i = np.nonzero(start[:-1] & mid[1:] & (key[1:] == key[:-1])
                   & (qts[1:] - qts[:-1] <= CEPW_WITHIN_MS))[0]
    last = np.searchsorted(comp, comp[i] + CEPW_WITHIN_MS, side="right") - 1
    ends = np.nonzero(end)[0]
    lo = np.searchsorted(ends, i + 2)
    n_per = np.maximum(np.searchsorted(ends, np.minimum(last, n - 1),
                                       side="right") - lo, 0)
    first = np.cumsum(n_per) - n_per
    pair = np.repeat(np.arange(len(i)), n_per)
    j = ends[lo[pair] + np.arange(int(n_per.sum())) - first[pair]]
    si = i[pair]
    seq = cols["seq"][order]
    rows = np.stack([key[si], seq[si], seq[si + 1], seq[j]], axis=1)
    return rows[np.lexsort((si, j))]


def _rows_by_key(rows):
    out = {}
    for r in rows:
        out.setdefault(int(r[0]), []).append(tuple(int(x) for x in r))
    return out


def check_cepw_rows(results, cols, pane_ms, seed):
    """Every key's rows, in order, against numpy's enumeration of its
    matches; for a seeded sample of keys, each key's rows, in order,
    against the copied host NFA run over that key's events in (timestamp,
    arrival) order on pane-quantised timestamps
    (tests/test_cep_device.py:194-204). Returns (rows, numpy's rows,
    sampled keys with a match, their rows)."""
    from flink_tpu_torch.cep import NFA
    want_rows = cepw_reference(cols, pane_ms)
    got_all = _rows_by_key(results)
    want_all = _rows_by_key(want_rows.tolist())
    bad = [k for k in set(got_all) | set(want_all)
           if got_all.get(k) != want_all.get(k)]
    check(len(results) == len(want_rows) and not bad,
          f"cep-within: {len(results)} rows, numpy {len(want_rows)}; "
          f"{len(bad)} keys' rows differ from numpy's")
    rng = np.random.default_rng(seed)
    sample = sparse_ids(rng.choice(CEPW_KEYS, CEPW_SAMPLE, replace=False))
    pick = np.isin(cols["key"], sample)
    sub = {k: v[pick] for k, v in cols.items()}
    order = np.lexsort((sub["seq"], sub["ts"], sub["key"]))
    names = list(sub)
    rows = list(zip(*[sub[k][order].tolist() for k in names]))
    nfa = NFA(cepw_pattern())
    want, partials = {}, {}
    for e in rows:
        k = e[CW_KEY]
        p, ms = nfa.process(partials.get(k, []), e,
                            e[CW_TS] // pane_ms * pane_ms)
        partials[k] = p
        want.setdefault(k, []).extend(cepw_select(m) for m in ms)
    want = {k: v for k, v in want.items() if v}
    got = {k: got_all[k] for k in sample.tolist() if k in got_all}
    check(got == want,
          f"cep-within: the sampled keys' rows differ from the host NFA's "
          f"({sum(map(len, got.values()))} rows against "
          f"{sum(map(len, want.values()))})")
    return (len(results), len(want_rows), len(want),
            sum(map(len, want.values())))


def cep_lanes(dev, C, B, n_keys, S, Q, kind, seed):
    """G19's inputs: ``n_keys`` keys on random distinct slots (one key in
    every lane for ``one_segment``; a fifth of the lanes on one hot key
    and 5 % of the lanes dead for ``edge``), the stage bits of the job
    whose shape this is, a carry of small counts."""
    rng = np.random.default_rng(seed)
    slots = rng.choice(C, n_keys, replace=False)
    if kind == "one_segment":
        slot = np.full(B, slots[0])
    else:
        slot = slots[rng.integers(0, n_keys, B)]
    live = np.ones(B, bool)
    if kind == "edge":
        slot = np.where(rng.random(B) < 0.2, slots[0], slot)
        live = rng.random(B) < 0.95
    if S == 2:      # the cep job's a, b names
        u = rng.random(B)
        masks = np.stack([u < 0.05, (u >= 0.05) & (u < 0.1)], axis=1)
    elif S == 3:    # the cep-within job's stage probabilities
        masks = rng.random((B, 3)) < np.array([1 / 64, 0.25, 0.1])
    else:
        masks = rng.random((B, S)) < 0.05
    D = (S - 1) * Q + 2
    carry = np.zeros((C + 1, D), np.float32)
    carry[:, D - 1] = 1.0
    carry[slots, :D - 2] = rng.integers(0, 3, (n_keys, D - 2)) * \
        (rng.random((n_keys, D - 2)) < 0.1)
    order, key_s, seg_start = slot_lanes(dev, slot, live, C)
    return (order, key_s, seg_start, _t(masks, dev, torch.bool),
            _t(carry, dev, torch.float32), int(np.unique(slot[live]).size))


def case_cep_scan(dev, C, B, n_keys, S, Q, relaxed, kind, seed=31):
    order, key_s, seg_start, masks, carry0, touched = cep_lanes(
        dev, C, B, n_keys, S, Q, kind, seed)
    q_t = seed % Q
    args = dict(relaxed=relaxed, Q=Q, q_t=q_t)
    c1, c2 = carry0.clone(), carry0.clone()
    d1 = kernels.cep_scan(order, key_s, seg_start, masks, c1, **args)
    d2 = kernels.cep_scan_plain(order, key_s, seg_start, masks, c2, **args)
    D = carry0.shape[1]
    return {
        "err": max_abs_err((d1, c1), (d2, c2)),
        "matches": float(d2.sum()),
        "run": lambda: kernels.cep_scan(order, key_s, seg_start, masks, c1,
                                        **args),
        "plain": lambda: kernels.cep_scan_plain(order, key_s, seg_start,
                                                masks, c2, **args),
        "library": None,
        # stage bits, order, sorted key, flag in and the delta out per
        # lane; a touched key's carry row read and written
        "bytes": B * (S + 4 + 8 + 1 + 4) + touched * D * 4 * 2,
    }


def cep_stale_cols(S, Q, stale):
    """The carry columns s * Q + q (s < S - 1) of the stale ring slots."""
    return [s * Q + q for s in range(S - 1) for q in range(Q) if stale[q]]


def cep_expire_sectors(rows, D, cols) -> int:
    """The 32-byte sectors that zeroing ``cols`` of every row of a float32
    [rows, D] carry (32-byte aligned) writes into. Whole sectors repeat
    every ``per`` rows, and no sector straddles two such periods."""
    per = 32 // math.gcd(4 * D, 32)

    def touched(n):
        return len({(r * D + c) * 4 // 32 for r in range(n) for c in cols})

    return touched(per) * (rows // per) + touched(rows % per)


def case_cep_expire(dev, C, S, Q, seed=32, stale=None):
    """G20 on a random carry [C + 1, D]; ``stale`` the ring slots (the
    slot seed % Q alone by default)."""
    rng = np.random.default_rng(seed)
    D = (S - 1) * Q + 2
    carry0 = _t(rng.integers(0, 4, (C + 1, D)).astype(np.float32), dev,
                torch.float32)
    if stale is None:
        stale = [q == seed % Q for q in range(Q)]
    c1, c2 = carry0.clone(), carry0.clone()
    del carry0
    kernels.cep_expire(c1, stale, S=S, Q=Q)
    kernels.cep_expire_plain(c2, stale, S=S, Q=Q)
    cols = cep_stale_cols(S, Q, stale)
    idx = torch.tensor(cols, dtype=torch.int64, device=dev)
    return {
        "err": bits_err(c1, c2),
        "run": lambda: kernels.cep_expire(c1, stale, S=S, Q=Q),
        "plain": lambda: kernels.cep_expire_plain(c2, stale, S=S, Q=Q),
        # one call over the stale columns, their indices on the card
        "library": lambda: c2.index_fill_(1, idx, 0.0),
        # the zeros written into the stale columns
        "bytes": (C + 1) * len(cols) * 4,
        # the 32-byte sectors the zeros land in
        "sector_bytes": cep_expire_sectors(C + 1, D, cols) * 32,
    }


def cep_kernel_phase(dev, timing=True, cep_b=CEP_BATCH,
                     cepw_c=CEPW_CAPACITY, cepw_b=CEPW_BATCH,
                     stress_b=BATCH, cepw_keys=CEPW_KEYS):
    """Hold G19 and G20 against their plain versions, bit for bit (every
    count stays below 2^24): G19 at (a) the cep job's shape (16,384 lanes
    of 1,000 keys, D = 3, capacity 2^16), (b) the cep-within job's (8,192
    lanes, its batch, of 1M keys, D = 20, capacity 2^22) and the same at
    262,144 lanes (stress), (c) one segment of 262,144 lanes at D = 20
    (the non-keyed stream), and an edge case at the largest D, 128 (15
    stages, Q = 9; a hot key, dead lanes); G20 at (d), carry [2^22 + 1,
    20] with one stale bucket. D = 129 must raise. Then G19's edge shapes
    (``cep_edge_checks``). Returns {"cep_scan": record of (b) with the
    others and the edges nested, "cep_expire": record of (d)}."""
    within = (True, False, True)         # begin, next, followedBy
    shapes = {
        "cep_job": (CEP_CAPACITY, cep_b, CEP_KEYS, 2, 1, (True, True),
                    "main"),
        "cep_within": (cepw_c, cepw_b, cepw_keys, 3, 9, within, "main"),
        "cep_within_stress": (cepw_c, stress_b, cepw_keys, 3, 9, within,
                              "main"),
        "one_segment": (cepw_c, stress_b, 1, 3, 9, within, "one_segment"),
        "edge_d128": (1 << 16, cep_b, 500, 15, 9,
                      (True, True) + (False,) * 13, "edge"),
    }
    recs = {}
    for name, (C, B, nk, S, Q, relaxed, kind) in shapes.items():
        c = case_cep_scan(dev, C, B, nk, S, Q, relaxed, kind)
        check(c["err"] == 0.0, f"cep_scan ({name}) disagrees with its "
                               f"plain version: max abs err {c['err']}")
        check(c["matches"] < 2**24, f"cep_scan ({name}): counts reach 2^24")
        rec = {"max_abs_err": c["err"], "bound_ms": bound_ms(c["bytes"]),
               "lanes": B, "D": (S - 1) * Q + 2, "matches": c["matches"]}
        if timing:
            rec["ms"] = time_ms(c["run"])
            rec["plain_ms"] = time_ms(c["plain"], reps=3)
            rec["library_ms"] = None
        recs[name] = rec
        del c
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    try:
        kernels.cep_scan(*(torch.zeros(1, dtype=dt, device=dev) for dt in
                           (torch.int32, torch.int64, torch.bool)),
                         torch.zeros(1, 2, dtype=torch.bool, device=dev),
                         torch.zeros(2, 129, dtype=torch.float32, device=dev),
                         relaxed=(True, True), Q=127, q_t=0)
        raised = False
    except ValueError:
        raised = True
    check(raised, "cep_scan took D = 129")
    edges = cep_edge_checks(dev)
    scan = dict(recs["cep_within"],
                max_abs_err=max(r["max_abs_err"] for r in recs.values()))
    del recs["cep_within"]
    scan.update(recs)
    scan["edges"] = edges
    c = case_cep_expire(dev, cepw_c, 3, 9)
    check(c["err"] == 0.0, f"cep_expire disagrees with its plain version: "
                           f"{c['err']}")
    # beside the byte bound, the sectors the zeros land in: written once,
    # and read first as well where the card fills a partly written sector
    exp = {"max_abs_err": c["err"], "bound_ms": bound_ms(c["bytes"]),
           "sector_bytes": c["sector_bytes"],
           "sector_bound_ms": bound_ms(c["sector_bytes"]),
           "sector_read_bound_ms": bound_ms(2 * c["sector_bytes"])}
    if timing:
        exp["ms"] = time_ms(c["run"])
        exp["plain_ms"] = time_ms(c["plain"], reps=3)
        exp["library_ms"] = time_ms(c["library"])
    del c
    return {"cep_scan": scan, "cep_expire": exp}


def cep_edge_checks(dev) -> dict:
    """G19's single pass on the shapes its tiles and look-back make risky,
    each bit for bit (deltas and carry) against its plain version, two
    batches in a row on one carry: a segment that ends one lane before, at
    and one lane after a tile boundary; a hot key through every tile with
    a new segment starting mid-tile; pieces of one lane; S = 1; Q = 1;
    dead lanes crossing tiles inside a batch of few keys; B below one tile
    and B not a multiple of it; D = 128 at S = 15, Q = 9, at S = 2, Q =
    126 and at S = 127, Q = 1 (maps read from global memory), each with a
    key across tiles; S = 4, Q = 2 (the arrays in local memory); batches
    large enough for G19's 128- and 256-lane tiles (smaller ones take 64).
    Then
    calls in a row on one scratch (A, B, A again on A's inputs: the same
    outputs, the epoch) and the device kernels a call launches
    (torch.profiler): one. Returns a record nested under cep_scan."""
    rng = np.random.default_rng(19)
    T = kernels.CEP_TILE
    C = 1 << 12

    def keys(*runs):  # runs of (slot, lanes) in sorted order
        return np.concatenate([np.full(n, k) for k, n in runs])

    cases = [  # (label, slots, live, S, Q, stage-bit probability)
        ("ends a lane before a tile", keys((1, T - 1), (2, 40), (3, 300)),
         None, 3, 9, 0.2),
        ("ends at a tile", keys((1, T), (2, 40), (3, 300)), None, 3, 9, 0.2),
        ("ends a lane after a tile", keys((1, T + 1), (2, 40), (3, 300)),
         None, 3, 9, 0.2),
        ("hot key through every tile", keys((1, 9 * T + 100), (2, 70)),
         None, 3, 9, 0.05),
        ("pieces of one lane", rng.permutation(C)[:3 * T + 5], None, 3, 9,
         0.3),
        ("S = 1", rng.integers(0, 50, 4 * T + 9), None, 1, 1, 0.3),
        ("Q = 1", rng.integers(0, 7, 4 * T + 9), None, 3, 1, 0.1),
        ("dead lanes across tiles", rng.integers(0, 5, 6 * T),
         rng.random(6 * T) < 0.3, 3, 9, 0.1),
        ("B below one tile", rng.integers(0, 9, 100), None, 3, 9, 0.2),
        ("B not a multiple of the tile", rng.integers(0, 30, 5 * T + 37),
         None, 2, 1, 0.2),
        ("D = 128, S = 15", keys((1, 3 * T), (5, 500)), None, 15, 9, 0.05),
        ("D = 128, S = 2", keys((1, 3 * T), (5, 100)), None, 2, 126, 0.1),
        ("D = 128, S = 127", keys((1, 4 * T), (5, 100)), None, 127, 1,
         0.02),
        ("S = 4, Q = 2", keys((1, 2 * T + 3), (2, T)), None, 4, 2, 0.1),
        # batches large enough for 128- and 256-lane tiles
        ("128-lane tiles", np.concatenate([keys((1, 127), (2, 129), (3, 2000)),
                                           np.sort(rng.integers(9, C, 36_000))]),
         None, 3, 9, 0.1),
        ("256-lane tiles", np.concatenate([keys((1, 255), (2, 257), (3, 600)),
                                           np.sort(rng.integers(9, C, 70_000))]),
         None, 3, 9, 0.05),
    ]
    err, matches, kept = 0.0, 0.0, {}
    for label, slots, live, S, Q, p in cases:
        B = len(slots)
        live = np.ones(B, bool) if live is None else live
        relaxed = (True, True) + tuple(rng.random(S - 2) < 0.3) \
            if S > 1 else (True,)
        order, key_s, seg_start = slot_lanes(dev, slots, live, C)
        D = (S - 1) * Q + 2
        carry0 = np.zeros((C + 1, D), np.float32)
        carry0[:, D - 1] = 1.0
        carry0[:C, :D - 2] = rng.integers(0, 3, (C, D - 2)) * (
            rng.random((C, D - 2)) < 0.2)
        c1 = _t(carry0.copy(), dev, torch.float32)
        c2 = c1.clone()
        for call in range(2):
            masks = _t(rng.random((B, S)) < p, dev, torch.bool)
            q_t = int(rng.integers(0, Q))
            args = dict(relaxed=relaxed, Q=Q, q_t=q_t)
            d1 = kernels.cep_scan(order, key_s, seg_start, masks, c1, **args)
            d2 = kernels.cep_scan_plain(order, key_s, seg_start, masks, c2,
                                        **args)
            e = max_abs_err((d1, c1), (d2, c2))
            check(e == 0.0, f"cep_scan ({label}, call {call}) differs from "
                            f"its plain version: max abs err {e}")
            check(float(c2.max()) < 2**24, f"cep_scan ({label}): counts "
                                           f"reach 2^24")
            err = max(err, e)
            matches += float(d2.sum())
        if label in ("hot key through every tile", "pieces of one lane"):
            kept[label] = (order, key_s, seg_start, masks, carry0, args)
    # calls in a row on one scratch: A, B, A again from A's carry
    outs = []
    for label in ("hot key through every tile", "pieces of one lane",
                  "hot key through every tile"):
        order, key_s, seg_start, masks, carry0, args = kept[label]
        c = _t(carry0.copy(), dev, torch.float32)
        outs.append((kernels.cep_scan(order, key_s, seg_start, masks, c,
                                      **args), c))
    again = max_abs_err(list(outs[0]), list(outs[2]))
    check(again == 0.0, f"cep_scan: a call on a used scratch differs "
                        f"({again})")
    order, key_s, seg_start, masks, carry0, args = kept[
        "hot key through every tile"]
    c = _t(carry0.copy(), dev, torch.float32)
    n_launch, seen = launches_a_call(dev, [lambda: kernels.cep_scan(
        order, key_s, seg_start, masks, c, **args)] * 4)
    check(n_launch in (None, 1) and all("cep_fast_kernel" in k
                                        for k in seen),
          f"G19: {n_launch} device kernels a call, not one: {seen}")
    return {"cases": len(cases) + 1, "max_abs_err": err,
            "scratch_twice_err": again, "kernels_a_call": n_launch,
            "matches": matches, "shapes": [c[0] for c in cases]}


# ------------------------------------- chained stages: G21, G22, two jobs

CHAIN_W1_MS = 1_000            # stage 0: the per-second aggregate
CHAIN_EDGE_LANES = 1 << 22     # pipeline.stages.exchange-lanes of both jobs
CHAIN_KERNELS = ("route_lanes", "clear_rows", "scatter_update",
                 "fire_compact", "chain_pack")
CHAIN_STATS_KERNELS = CHAIN_KERNELS + ("slot_stats", "fire_columns",
                                       "stage_record")
CHAIN_SPARSE_KERNELS = CHAIN_KERNELS + ("hash_upsert",)


def chain_window_keys(w: int, n_keys=N_KEYS, events_per_ms=EVENTS_PER_MS,
                      window_ms=CHAIN_W1_MS):
    """The north-star generator's keys of 1 s window ``w`` as stage 0 of
    the chained job fires them (ascending, the direct layout's slot order)
    with their counts."""
    per = events_per_ms * window_ms
    keys, _ts, _ = gen_batch(w * per, per, n_keys, events_per_ms)
    counts = np.bincount(keys, minlength=n_keys)
    k = np.nonzero(counts)[0]
    return k, counts[k]


def chain_main_planes():
    """The stage-0 fire planes of the chained job's second drain (batches
    D..2D-1): (slot, lane) -> (keys, counts, window end ms) for each 1 s
    window whose end the watermark crosses in that drain — with the real
    shapes, windows 2 and 3 in slots 6 and 14."""
    per = EVENTS_PER_MS * CHAIN_W1_MS
    planes = {}
    w = 0
    while True:
        # the first batch whose largest tick reaches the window's end
        i = -(-((w + 1) * per + 1) // BATCH) - 1
        if i >= 2 * RING_DEPTH:
            return planes
        if i >= RING_DEPTH:
            d = i - RING_DEPTH
            f = sum(1 for dd, _f in planes if dd == d)
            k, v = chain_window_keys(w)
            planes[(d, f)] = (k, v.astype(np.float32),
                              (w + 1) * CHAIN_W1_MS)
        w += 1


def chain_stack(dev, D, F, C, planes, W=None, seed=21):
    """A [D, F, C] stack of stage-0 fire planes: ``planes`` maps (slot,
    lane) to (keys, values, window end); the other planes have count 0 and
    invalid lanes, and every row past a plane's count is random (it must
    never be read)."""
    g = np.random.default_rng(seed)
    vshape = (D, F, C) + (() if W is None else (W,))
    khi = g.integers(-2**31, 2**31, (D, F, C), dtype=np.int64).astype(
        np.int32)
    klo = g.integers(-2**31, 2**31, (D, F, C), dtype=np.int64).astype(
        np.int32)
    vals = g.integers(-99, 99, vshape).astype(np.float32)
    counts = np.zeros((D, F), np.int32)
    lanes = np.zeros((D, F), bool)
    ends = np.full((D, F), PANE_NONE, np.int32)
    for (d, f), (k, v, end) in planes.items():
        n = min(len(k), C)
        khi[d, f, :n] = 0
        klo[d, f, :n] = k[:n]
        vals[d, f, :n] = v[:n] if W is None else np.stack(
            [v[:n]] * W, axis=-1)
        counts[d, f] = len(k)
        lanes[d, f] = True
        ends[d, f] = end
    return tuple(_t(a, dev, dt) for a, dt in (
        (khi, torch.int32), (klo, torch.int32), (vals, torch.float32),
        (counts, torch.int32), (lanes, torch.bool), (ends, torch.int32)))


def case_chain_pack(dev, kind, job_planes):
    """G21 on one stack. ``main``: the chained job's second drain
    (chain_main_planes) in its [16, 2, 1M] arena into E = 2^22, at that
    drain's watermarks. Edge kinds (CHAIN_EDGES): the same into E = 2^20
    (lanes dropped); every plane invalid (random counts); every plane
    valid and empty; counts above C (C = 2^16); W = 2 values; the
    end-of-stream flush (fired_through at 2^31 / slide, clamped)."""
    D, F, C, E = RING_DEPTH, FIRES_PER_STEP, N_KEYS, CHAIN_EDGE_LANES
    i32 = dict(dtype=torch.int32, device=dev)
    planes, W, slide = dict(job_planes), None, CHAIN_W1_MS
    # the drain's watermark (its last batch's largest tick - 1) and stage
    # 0's fired_through after it (the pane of the last window it fired)
    up_wm = (2 * D * BATCH - 1) // EVENTS_PER_MS - 1
    ft = max(e for _k, _v, e in planes.values()) // slide - 1
    if kind == "over_full":
        E = CHAIN_EDGE_LANES // 4
    elif kind == "all_invalid":
        planes = {}
    elif kind == "all_empty":
        planes = {p: (k[:0], v[:0], e) for p, (k, v, e) in planes.items()}
    elif kind == "counts_above_c":
        C = 1 << 16
        planes = {p: (k[:C + 17], v[:C + 17], e)
                  for p, (k, v, e) in planes.items()}
    elif kind == "w2":
        W = 2
    elif kind == "flush":
        up_wm, ft = 2**31 - 4, 2**31 // slide
    stack = chain_stack(dev, D, F, C, planes, W)
    if kind == "counts_above_c":
        stack[3].copy_(torch.where(stack[4], C + 17, 0))
    if kind == "all_invalid":
        stack[3].copy_(torch.randint(0, C, (D, F), generator=torch.Generator(
        ).manual_seed(5)).to(dev, torch.int32))
    kw = dict(n_lanes=E, up_wm=torch.tensor(up_wm, **i32),
              fired_through=torch.tensor(ft, **i32), slide=slide)
    got = kernels.chain_pack(*stack, **kw)
    want = kernels.chain_pack_plain(*stack, **kw)
    err = max_abs_err(list(got), list(want))
    demand = int(want.demand)
    want_demand = (C * len(planes) if kind == "counts_above_c" else
                   sum(len(k) for k, _v, _e in planes.values()))
    check(demand == want_demand,
          f"chain_pack ({kind}): demand {demand}, want {want_demand}")
    if kind == "over_full":
        check(int(want.dropped) > 0, "chain_pack: the over-full edge "
                                     "dropped nothing")
    if kind == "flush":
        check(int(want.wm) == min(up_wm, ((2**31 - 4) // slide) * slide - 2),
              f"chain_pack: flush watermark {int(want.wm)}")
    width = 1 if W is None else W
    live = min(demand, E)
    return {
        "err": err, "demand": demand, "lanes": E,
        "dropped": int(want.dropped),
        "run": lambda: kernels.chain_pack(*stack, **kw),
        "plain": lambda: kernels.chain_pack_plain(*stack, **kw),
        "library": None,
        # the E lanes written (hi, lo, ts, values, ok); the live rows read
        # once (key halves, value); the plane counts, flags and ends
        "bytes": E * (13 + 4 * width) + live * (8 + 4 * width)
        + D * F * 9 + 12,
    }


CHAIN_EDGES = ("over_full", "all_invalid", "all_empty", "counts_above_c",
               "w2", "flush")


def case_fire_columns(dev, kind):
    """G22 fire_columns on the chained job's [16, 2] stack: ``main`` its
    second drain's stage-0 fires (chain_main_planes); ``edge`` random
    lanes and counts up to 2^20 with only 3 live slots, the rest skipped
    (zero), as in the job's last drain, and 4 lanes a slot."""
    D = RING_DEPTH
    g = torch.Generator().manual_seed(22)
    F = FIRES_PER_STEP if kind == "main" else 4
    lanes = torch.zeros(D, F, dtype=torch.bool)
    counts = torch.zeros(D, F, dtype=torch.int32)
    if kind == "main":
        for (d, f), (k, _v, _e) in chain_main_planes().items():
            lanes[d, f] = True
            counts[d, f] = len(k)
    else:
        lanes = torch.rand(D, F, generator=g) < 0.5
        counts = torch.randint(0, 1 << 20, (D, F), generator=g).to(
            torch.int32)
        lanes[3:] = False
        counts[3:] = 0
    ds = torch.randint(0, 1000, (D, 9), generator=g).to(torch.int32)
    ds[:, 2:4] = 0
    lanes, counts, ds = lanes.to(dev), counts.to(dev), ds.to(dev)
    ds_g, ds_w = ds.clone(), ds.clone()
    kernels.fire_columns(ds_g, lanes, counts)
    kernels.fire_columns_plain(ds_w, lanes, counts)
    return {
        "err": max_abs_err(ds_g, ds_w),
        "run": lambda: kernels.fire_columns(ds_g, lanes, counts),
        "plain": lambda: kernels.fire_columns_plain(ds_w, lanes, counts),
        "library": lambda: counts.sum(dim=1),
        "bytes": D * F * 5 + D * 8,
    }


STAGE_RECORD_EDGES = (
    # (demand, E, lanes, dropped, wm_up, wm_j, wm_before, wm_after):
    # the first advance from the MIN sentinel; the end-of-stream flush
    (1_729_086, CHAIN_EDGE_LANES, (True, False), 0, 1_999, 998,
     PANE_NONE, 998),
    (0, CHAIN_EDGE_LANES, (True, True), 0, 2**31 - 4,
     ((2**31 - 4) // CHAIN_W1_MS) * CHAIN_W1_MS - 2, 14_998,
     ((2**31 - 4) // CHAIN_W1_MS) * CHAIN_W1_MS - 2),
    (5_000_000, CHAIN_EDGE_LANES, (True, True), 5_000_000 - (1 << 22),
     9_999, 7_998, 4_998, 7_998),
)


def case_stage_record(dev, kind):
    """G22 stage_record: ``main`` the chained job's stage 1 at a drain that
    fires its first 5 s window; ``edge`` each of STAGE_RECORD_EDGES."""
    rows = (((1_729_086, CHAIN_EDGE_LANES, (True, False), 0, 5_999, 3_998,
              2_998, 3_998),) if kind == "main" else STAGE_RECORD_EDGES)
    i32 = dict(dtype=torch.int32, device=dev)
    err = 0.0
    for dem, E, lv, drop, wu, wj, wb, wa in rows:
        args = [torch.tensor(dem, **i32), E,
                torch.tensor(lv, dtype=torch.bool, device=dev),
                torch.tensor(drop, **i32), torch.tensor(wu, **i32),
                torch.tensor(wj, **i32), torch.tensor(wb, **i32),
                torch.tensor(wa, **i32)]
        row_g = torch.full((6,), -1, **i32)
        row_w = torch.full((6,), -1, **i32)
        kernels.stage_record(row_g, *args, slide=5_000)
        kernels.stage_record_plain(row_w, *args, slide=5_000)
        err = max(err, max_abs_err(row_g, row_w))
    return {
        "err": err,
        "run": lambda: kernels.stage_record(row_g, *args, slide=5_000),
        "plain": lambda: kernels.stage_record_plain(row_w, *args,
                                                    slide=5_000),
        "library": None,
        # six scalars and F flags in, six ints out
        "bytes": 6 * 4 + len(lv) + 24,
    }


def chain_kernel_phase(dev, timing=True):
    """Hold G21 and both G22 instances against their plain versions, bit
    for bit: G21 at the chained job's real drain (main) and on each of
    CHAIN_EDGES, and above CHAIN_MAX_PLANES planes it must raise; G22's
    fire_columns and stage_record on their main and edge inputs. Returns
    {"chain_pack": record with each edge's nested, "fire_columns": record,
    "stage_record": record}."""
    planes = chain_main_planes()
    c = case_chain_pack(dev, "main", planes)
    check(c["err"] == 0.0, f"chain_pack (main) disagrees with its plain "
                           f"version: {c['err']}")
    rec = {"max_abs_err": c["err"], "bound_ms": bound_ms(c["bytes"]),
           "demand": c["demand"], "lanes": c["lanes"], "library_ms": None}
    if timing:
        rec["ms"] = time_ms(c["run"])
        rec["plain_ms"] = time_ms(c["plain"], reps=3)
    del c
    for kind in CHAIN_EDGES:
        c = case_chain_pack(dev, kind, planes)
        check(c["err"] == 0.0, f"chain_pack ({kind}) disagrees with its "
                               f"plain version: {c['err']}")
        rec[kind] = {"max_abs_err": c["err"], "demand": c["demand"],
                     "lanes": c["lanes"], "dropped": c["dropped"],
                     "bound_ms": bound_ms(c["bytes"])}
        if timing:
            rec[kind]["ms"] = time_ms(c["run"])
        rec["max_abs_err"] = max(rec["max_abs_err"], c["err"])
        del c
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    many = kernels.CHAIN_MAX_PLANES + 1
    z = torch.zeros((many, 1), dtype=torch.int32, device=dev)
    try:
        kernels.chain_pack(z, z, z.float(), z[:, 0].contiguous(),
                           z[:, 0].bool().contiguous(),
                           z[:, 0].contiguous(), n_lanes=8)
        raised = False
    except ValueError:
        raised = True
    check(raised, f"chain_pack took {many} planes")
    out = {"chain_pack": rec}
    for name, case in (("fire_columns", case_fire_columns),
                       ("stage_record", case_stage_record)):
        r = hold(name, lambda k, f=case: f(dev, k), False)
        if timing:
            c = case(dev, "main")
            r["ms"] = time_ms(c["run"])
            r["plain_ms"] = time_ms(c["plain"], reps=5)
            r["library_ms"] = (time_ms(c["library"])
                               if c["library"] is not None else None)
            if c["library"] is not None:
                r["library"] = "Tensor.sum(dim=1) over the [16, 2] counts"
        out[name] = r
    return out


def chained_job(device, total, sparse=False, config=None, parallelism=1):
    """The chained rollup through the public API: the north star's traffic
    (its dense keys, or with ``sparse`` the sparse job's splitmix64 ids)
    through key_by -> 1 s tumbling sum -> key_by(r.key) -> 5 s tumbling
    sum(r.value) into a row-keeping sink; direct layout at capacity 1M, or
    the hash layout at 2^21 probed 64 deep; no overflow ring; an edge of
    CHAIN_EDGE_LANES lanes; ``parallelism`` shards, each that capacity.
    Returns (sink, env, job, s)."""
    def gen(offset, n):
        keys, ts, vals = gen_batch(offset, n)
        key = sparse_ids(keys) if sparse else keys
        return {"key": key, "value": vals}, ts

    cfg = Configuration({
        "keys.reverse-map": False,
        "window.fires-per-step": FIRES_PER_STEP,
        "pipeline.ring-depth": RING_DEPTH,
        "state.backend.overflow-ring": 0,
        "state.backend.layout": "hash" if sparse else "direct",
        "state.probe-len": PROBE_LEN,
        "pipeline.stages.exchange-lanes": CHAIN_EDGE_LANES,
        **(config or {}),
    })
    env = StreamExecutionEnvironment(cfg, device=device)
    env.set_parallelism(parallelism)
    env.set_max_parallelism(MAX_PARALLELISM)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(SPARSE_CAPACITY if sparse else N_KEYS)
    env.batch_size = BATCH
    sink = ColumnarCollectSink()
    (
        env.add_source(GeneratorSource(gen, total=total))
        .key_by(lambda c: c["key"])
        .time_window(CHAIN_W1_MS)
        .sum(lambda c: c["value"])
        .key_by(lambda r: r.key)
        .time_window(WINDOW_MS)
        .sum(lambda r: r.value)
        .add_sink(sink)
    )
    t0 = time.perf_counter()
    job = env.execute("chip-smoke-chained" + ("-sparse" if sparse else ""))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sink, env, job, time.perf_counter() - t0


def chained_reference(total, chunk=1 << 22):
    """numpy's 5 s tumbling counts of the north star's traffic, [windows,
    N_KEYS] (the 1 s windows nest in the 5 s ones, so the rollup's rows
    are these counts), and the number of stage-0 rows (distinct (key, 1 s
    window) pairs)."""
    n5 = -(-total // (EVENTS_PER_MS * WINDOW_MS))
    n1 = -(-total // (EVENTS_PER_MS * CHAIN_W1_MS))
    counts = np.zeros(n5 * N_KEYS, np.int64)
    seen1 = np.zeros((n1, N_KEYS), bool)
    for off in range(0, total, chunk):
        keys, ts, _ = gen_batch(off, min(chunk, total - off))
        counts += np.bincount((ts // WINDOW_MS) * N_KEYS + keys,
                              minlength=n5 * N_KEYS)
        seen1[ts // CHAIN_W1_MS, keys] = True
    return counts.reshape(n5, N_KEYS), int(seen1.sum())


def check_chained_rows(cols, want, sparse=False):
    """Every row of the chained job against numpy's 5 s counts: the row
    count, each row's value, no (key, window) twice; for the sparse job the
    row count, the value sum and every row of the ids 0 mod 1024. Returns
    the row count."""
    n = len(cols.get("value", ()))
    n_want = int((want > 0).sum())
    check(n == n_want, f"chained job: {n} rows, numpy {n_want}")
    win = cols["window_end_ms"].astype(np.int64) // WINDOW_MS - 1
    kid = cols["key_id"].astype(np.uint64)
    vals = cols["value"].astype(np.float64)
    if not sparse:
        check(int(kid.max(initial=0)) < N_KEYS and win.min(initial=0) >= 0
              and win.max(initial=0) < want.shape[0],
              "chained job: a row outside numpy's keys or windows")
        cell = win * N_KEYS + kid.astype(np.int64)
        check(len(np.unique(cell)) == n, "chained job: a (key, window) "
                                         "emitted twice")
        check(np.array_equal(vals, want.reshape(-1)[cell]),
              "chained job: rows differ from numpy's 5 s counts")
        return n
    check(float(vals.sum()) == float(want.sum()),
          f"chained-sparse job: values sum to {vals.sum()}, numpy "
          f"{want.sum()}")
    ids = sparse_ids(np.arange(N_KEYS)).view(np.uint64)
    sel_keys = np.nonzero(ids % np.uint64(1024) == 0)[0]
    w_idx, k_idx = np.nonzero(want[:, sel_keys])
    exp = {(int(ids[sel_keys[k]]), int(w)): float(want[w, sel_keys[k]])
           for w, k in zip(w_idx, k_idx)}
    sel = kid % np.uint64(1024) == 0
    got = {(int(k), int(w)): float(v)
           for k, w, v in zip(kid[sel], win[sel], vals[sel])}
    check(got == exp and int(sel.sum()) == len(exp),
          "chained-sparse job: the rows of the ids 0 mod 1024 differ from "
          "numpy's")
    return n


def check_chain_stats(env, job, stage0_rows) -> dict:
    """The chained telemetry run's stage rows: every stage-0 row crossed
    the edge, none dropped, the peak demand within the edge."""
    rep = env._pipeline_report()
    check(rep["available"] and len(rep.get("stages", ())) == 1,
          "chained job: no stage rows in the pipeline report")
    st = rep["stages"][0]
    tot = st["totals"]
    check(tot["edge_events"] == tot["edge_demand"] == stage0_rows,
          f"chained job: edge events {tot['edge_events']}, demand "
          f"{tot['edge_demand']}, stage-0 rows {stage0_rows}")
    check(tot["dropped_capacity"] == 0, "chained job: the edge dropped "
                                        f"{tot['dropped_capacity']} lanes")
    check(0 < st["edge_peak_demand"] <= CHAIN_EDGE_LANES,
          f"chained job: peak edge demand {st['edge_peak_demand']}")
    return {"stage": st, "shard0_totals": rep["shards"][0]["totals"],
            "drains": rep["drains"]}


CHAIN_STATS_CONFIG = {
    "observability.drain-stats": True,
    "observability.drain-stats-every": 1,
}


def _no_env(out):
    """(sink, env, job, s) -> (sink, job, s), as profile_phase reads it."""
    sink, _env, job, secs = out
    return sink, job, secs


def chain_metrics(m) -> dict:
    return {"drains": m.resident_drains,
            "flush_drains": m.chain_flush_drains, "batches": m.steps,
            "records_in": m.records_in, "fires": m.fires,
            "dropped_late": m.dropped_late,
            "dropped_capacity": m.dropped_capacity,
            "fire_latency_ms": fire_latency(m)}


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms."""
    busy, last_end = 0.0, None
    for a, b in sorted(intervals):
        if last_end is None or a > last_end:
            busy += b - a
            last_end = b
        elif b > last_end:
            busy += b - last_end
            last_end = b
    return busy / 1e3


def profile_phase(dev, name, gen, run, total=TOTAL_EVENTS,
                  cumulative=()) -> dict:
    """Where the end-to-end time goes (``--profile`` only): the generator
    ``gen`` alone on the host (None: the job's data is made before it),
    the host profile of the job ``run()`` (cProfile, top entries by own
    time, and the cumulative seconds of the functions named in
    ``cumulative``), and its device timeline (torch.profiler): busy time
    as the union of kernel and copy intervals, and the share of wall time
    the card sat idle."""
    import cProfile
    import pstats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for off in range(0, total if gen is not None else 0, BATCH):
        gen(off, min(BATCH, total - off))
    gen_s = time.perf_counter() - t0

    prof_c = cProfile.Profile()
    prof_c.enable()
    run()
    prof_c.disable()
    st = pstats.Stats(prof_c)
    host_top = sorted(
        ((v[2], f"{k[0].rsplit('/', 2)[-1]}:{k[1]}:{k[2]}")
         for k, v in st.stats.items()), reverse=True)[:12]
    host_cum = {fn: sum(v[3] for k, v in st.stats.items() if k[2] == fn)
                for fn in cumulative}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sink, job, wall_s = run()
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        ms, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + (b - a) / 1e3, n + 1)
    busy = _busy_ms(spans)
    return {
        "phase": "profile", "job": name, "generator_s": gen_s,
        "host_top_own_s": host_top, "host_cumulative_s": host_cum,
        "profiled_wall_s": wall_s,
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / (wall_s * 1e3),
        "device_top_ms": sorted(
            ((round(ms, 3), n, name) for name, (ms, n) in by_name.items()),
            reverse=True)[:15],
        "drains": job.metrics.resident_drains,
        "compactions": job.metrics.compactions,
    }


# ---------------------- G1's residency mode; the checkpoint, tiered jobs

def tier_lane_inputs(dev):
    """G1's lane inputs at the tiered job's shape: one batch of 32,768
    lanes of ``tier_gen`` that crosses a window boundary (a batch is one
    1 s window), with the watermark the executor holds there; integer keys
    are their own 64-bit identity (hi 0, lo the key)."""
    offset = 10 * TIER_BATCH + TIER_BATCH // 2
    cols, ts = tier_gen(offset, TIER_BATCH, TIER_TOTAL)
    return {
        "hi": _t(np.zeros(TIER_BATCH, np.int32), dev, torch.int32),
        "lo": _t(cols["key"].astype(np.uint32).view(np.int32), dev,
                 torch.int32),
        "ts": _t(ts.astype(np.int32), dev, torch.int32),
        "valid": _t(np.ones(TIER_BATCH, bool), dev, torch.bool),
        "watermark": torch.tensor(int(ts[0]) - 1, dtype=torch.int32,
                                  device=dev),
        "purged_through": torch.tensor(-1, dtype=torch.int32, device=dev),
    }


def case_route_res(dev, kind):
    """G1 with the residency mask (tiered state's divert). At the north
    star's batch (B = 262,144, maxp 128): ``main``, half the key groups
    resident (a seeded random half); ``all``, every group resident, which
    must give no cold lane and G1's four outputs without the mask;
    ``none``, no group resident, every live lane cold. ``edge``: maxp
    32,768, a random mask, G1's edge lanes (dead, late, purged, past
    capacity). ``tiered`` / ``tiered_fill``: the tiered job's own shape
    (B = 32,768 lanes of its Zipf pool, maxp 64, the TierManager's
    initial 5-of-64 mask), without and with the kg fill, as its runs with
    ``observability.kg-stats`` off and on launch it. Held exactly: pane,
    kg, live, the stats, the cold mask and the fill. Library:
    ``res.index_select(0, kg)`` over G1's own kg."""
    tiered = kind.startswith("tiered")
    if tiered:
        maxp, slide = TIER_MAXP, TIER_WINDOW_MS
        inp = tier_lane_inputs(dev)
        res_np = TierManager(TIER_MAXP, [0], [TIER_MAXP - 1],
                             TIER_BUDGET).mask()
    else:
        maxp = KG_EDGE_MAXP if kind == "edge" else MAX_PARALLELISM
        slide = WINDOW_MS
        inp = lane_inputs(dev, N_KEYS, BATCH, WINDOW_MS,
                          "edge" if kind == "edge" else "main")
        rng = np.random.default_rng(17)
        res_np = {"all": np.ones(maxp, bool),
                  "none": np.zeros(maxp, bool)}.get(
            kind, rng.random(maxp) < 0.5)
    args = (inp["hi"], inp["lo"], inp["ts"], inp["valid"], inp["watermark"],
            inp["purged_through"])
    kw = dict(slide=slide, k=1, maxp=maxp, kg_start=0, kg_end=maxp - 1)
    res = _t(res_np, dev, torch.bool)
    fills = [torch.zeros(maxp, dtype=torch.int32, device=dev)
             if kind == "tiered_fill" else None for _ in range(2)]
    got = kernels.route_lanes(*args, **kw, res=res, fill=fills[0])
    want = kernels.route_lanes_plain(*args, **kw, res=res, fill=fills[1])
    err = max_abs_err(list(got), list(want))
    if fills[0] is not None:
        err = max(err, max_abs_err([fills[0]], [fills[1]]))
    live, cold = got[2], got[4]
    if kind == "all":
        # all resident: G1 as it was, no cold lane
        err = max(err, max_abs_err(list(got[:4]),
                                   list(kernels.route_lanes(*args, **kw))),
                  float(cold.sum()))
    elif kind == "none":
        err = max(err, float((cold != live).sum()))
    else:
        check(bool(cold.any()) and bool((live & ~cold).any()),
              f"route_lanes (kg_res, {kind}): no cold or no hot lane")
    kg = got[1].long()
    B = inp["hi"].shape[0]
    return {
        "err": err,
        "run": lambda: kernels.route_lanes(*args, **kw, res=res),
        "plain": lambda: kernels.route_lanes_plain(*args, **kw, res=res),
        "library": lambda: res.index_select(0, kg),
        "nores": lambda: kernels.route_lanes(*args, **kw),
        # G1's bytes, the [maxp] mask read, the [B] cold mask written
        "bytes": B * (4 + 4 + 4 + 1 + 4 + 4 + 1) + maxp + B,
    }


def res_kernel_phase(dev, timing=True):
    """Hold G1's residency mode against its plain version (half, all and
    no groups resident at the north star's batch, the edge case, and the
    tiered job's shape without and with the fill) and
    time it beside G1 without the mask: {"route_lanes": {"kg_res":
    record}}, with ``all_ms`` / ``none_ms`` at the other masks."""
    rec = hold("route_lanes (kg_res)", lambda k: case_route_res(dev, k),
               False, kinds=("main", "all", "none", "edge", "tiered",
                             "tiered_fill"))
    if timing:
        c = case_route_res(dev, "main")
        rec["ms"] = time_ms(c["run"])
        rec["nores_ms"] = time_ms(c["nores"])
        rec["plain_ms"] = time_ms(c["plain"], reps=5)
        rec["library_ms"] = time_ms(c["library"])
        rec["library"] = "res.index_select(0, kg) over G1's kg"
        for kind in ("all", "none"):
            rec[f"{kind}_ms"] = time_ms(case_route_res(dev, kind)["run"])
        del c
    return {"route_lanes": {"kg_res": rec}}


CKPT_INTERVAL = 32            # batches between two checkpoints
CKPT_PRODUCER_HIT = 50        # the producer's crash: its 51st prep
CKPT_KERNELS = ("route_lanes", "clear_rows", "scatter_update",
                "fire_compact")


def ckpt_job(device, total, ckpt_dir=None, fault=None, parallelism=1):
    """The north-star job (1M integer keys, 5 s tumbling sum, batches of
    262,144, direct layout, no overflow ring, the scan drain, the producer
    thread ahead) into a sink that keeps every row; with ``ckpt_dir``
    checkpointing sync-full every CKPT_INTERVAL batches there, and with
    ``fault`` crashed once and restarted by ``restart-strategy:
    fixed-delay`` (1 attempt, delay 0): ``step.drain`` at the first drain
    dispatch after window 2's rows reached the sink (the dispatch's read
    emitted them; the restore goes back to the cut before them, so they
    are emitted again), ``ingest.producer`` at the producer's
    CKPT_PRODUCER_HIT-th prep (the thread dies; the step loop finds it
    dead). ``parallelism`` shards (above 1 the scan drain is the sharded
    drain). Returns (sink, job, s)."""
    def gen(offset, n):
        keys, ts, vals = gen_batch(offset, n)
        return {"key": keys, "value": vals}, ts

    cfg = Configuration({
        "keys.reverse-map": False,
        "window.fires-per-step": FIRES_PER_STEP,
        "pipeline.ring-depth": RING_DEPTH,
        "state.backend.overflow-ring": 0,
        **RESIDENT_ON,
        "restart-strategy": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 1,
        "restart-strategy.fixed-delay.delay": 0,
    })
    env = StreamExecutionEnvironment(cfg, device=device)
    env.set_parallelism(parallelism)
    env.set_max_parallelism(MAX_PARALLELISM)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(N_KEYS)
    env.batch_size = BATCH
    if ckpt_dir is not None:
        env.enable_checkpointing(CKPT_INTERVAL, str(ckpt_dir))
    sink = ColumnarCollectSink()
    (env.add_source(GeneratorSource(gen, total=total))
     .key_by(lambda c: c["key"]).time_window(WINDOW_MS)
     .sum(lambda c: c["value"]).add_sink(sink))
    # step.drain: each seam hit notes the newest cut on disk; window 2's
    # rows arrive between two hits, and the crash takes the later one.
    # A cut between the two (one whose own drain fired window 2) holds the
    # window, so then the replay need not emit it again
    crashed, cuts = [], [None]

    def after_window_2(ctx):
        latest = ckpt_mod.CheckpointStorage(str(ckpt_dir)).latest()
        if not crashed and len(sink.columns().get("value", ())) > N_KEYS:
            crashed.append(latest != cuts[0])
            raise RuntimeError("injected drain crash")
        cuts[0] = latest

    rule = {"step.drain": faults.FaultRule(
                "step.drain", action="call", fn=after_window_2, times=0),
            "ingest.producer": faults.FaultRule(
                "ingest.producer", exc=RuntimeError("injected producer "
                                                    "crash"),
                at=CKPT_PRODUCER_HIT),
            None: None}[fault]
    t0 = time.perf_counter()
    if rule is None:
        job = env.execute("chip-smoke-checkpoint")
    else:
        inj = faults.FaultInjector([rule])
        with faults.active(inj):
            job = env.execute("chip-smoke-checkpoint-crash")
        check(bool(crashed) if fault == "step.drain"
              else bool(inj.fired_at(fault)), f"the {fault} fault never "
                                              f"fired")
    if device.type == "cuda":
        torch.cuda.synchronize()
    job.cut_between = bool(crashed and crashed[0])
    return sink, job, time.perf_counter() - t0


def window_counts(keys, windows, n_keys, n_windows) -> np.ndarray:
    """numpy's count of each (key, window) cell, flat key-major."""
    return np.bincount(keys.astype(np.int64) * n_windows + windows,
                       minlength=n_keys * n_windows)


def check_window_rows(cols, want, n_windows, window_ms, name) -> int:
    """Rows {"key_id", "window_end_ms", "value"} against numpy's counts
    ``want`` (flat key-major): every (key, window) numpy has, with its
    value, and no other. A window emitted twice (replayed after a
    restore) must carry the same value both times; returns how many
    such repeats there were."""
    cell = (cols["key_id"].astype(np.int64) * n_windows
            + cols["window_end_ms"] // window_ms - 1)
    order = np.argsort(cell, kind="stable")
    cell, vals = cell[order], cols["value"][order]
    dup = cell[1:] == cell[:-1]
    check(bool((vals[1:][dup] == vals[:-1][dup]).all()),
          f"{name}: a window re-emitted with another value")
    first = np.concatenate([[True], ~dup])
    have = np.nonzero(want)[0]
    check(np.array_equal(cell[first], have)
          and np.array_equal(vals[first], want[have].astype(np.float32)),
          f"{name}: rows differ from numpy's ({int(first.sum())} cells "
          f"against {len(have)})")
    return int(dup.sum())


def ckpt_reference(total, chunk=1 << 22) -> np.ndarray:
    n_windows = -(-total // (EVENTS_PER_MS * WINDOW_MS))
    want = np.zeros(N_KEYS * n_windows, np.int64)
    for off in range(0, total, chunk):
        keys, ts, _ = gen_batch(off, min(chunk, total - off))
        want += window_counts(keys, ts // WINDOW_MS, N_KEYS, n_windows)
    return want


def ckpt_stats(m) -> dict:
    stats = m.checkpoint_stats or []
    sync = [r["sync_ms"] for r in stats]
    return {"checkpoints": len(stats),
            "sync_ms_mean": float(np.mean(sync)) if sync else None,
            "sync_ms_max": max(sync) if sync else None,
            "bytes": sum(r["bytes"] for r in stats),
            "entries": sum(r["entries"] for r in stats)}


# the tiered cell, bench_configs.py:2508 run_tiered, at its shape
TIER_MAXP, TIER_BUDGET = 64, 5
TIER_KEYS = 4096
TIER_BATCH = 32_768
TIER_WINDOW_MS = 1000
TIER_CAPACITY = 1 << 14
TIER_TOTAL = 8_000_000        # run_tiered's 2M raised: ~244 windows
TIER_ZIPF, TIER_SEED = 2.5, 7
TIER_KERNELS = ("route_lanes", "route_lanes_res", "clear_rows",
                "scatter_update", "hash_upsert", "fire_compact",
                "ring_append")
_TIER_POOL = {}


def tier_pool(total) -> np.ndarray:
    """run_tiered's key pool: Zipf(2.5) draws capped at 4,096 keys, from
    one generator of seed 7 (the top 4 keys carry ~95 % of the traffic;
    the tail sprays every key group)."""
    if total not in _TIER_POOL:
        rng = np.random.default_rng(TIER_SEED)
        _TIER_POOL[total] = (np.minimum(rng.zipf(TIER_ZIPF, size=total),
                                        TIER_KEYS) - 1).astype(np.int64)
    return _TIER_POOL[total]


def tier_gen(offset, n, total=None):
    """run_tiered's generator: one pane (125 ms) every 4,096 events."""
    pool = tier_pool(total or TIER_TOTAL)
    idx = np.arange(offset, offset + n)
    return ({"key": pool[offset:offset + n],
             "value": np.ones(n, np.float32)},
            (idx // (TIER_BATCH // 8)) * (TIER_WINDOW_MS // 8))


def tier_job(device, total, budget, config=None):
    """run_tiered's job: key_by(key).time_window(1 s).sum(value) over the
    Zipf pool, max parallelism 64, capacity 2^14 in the hash layout with
    the default (auto) ring, batches of 32,768, into a sink that keeps
    every row; ``budget`` resident key groups (0: all resident). Returns
    (sink, env, job, s)."""
    opts = {"state.backend.layout": "hash", **RESIDENT_ON, **(config or {})}
    if budget:
        opts["state.tiers.resident-key-groups"] = budget
    env = StreamExecutionEnvironment(Configuration(opts), device=device)
    env.set_parallelism(1)
    env.set_max_parallelism(TIER_MAXP)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(TIER_CAPACITY)
    env.batch_size = TIER_BATCH
    sink = ColumnarCollectSink()
    (env.add_source(GeneratorSource(lambda o, n: tier_gen(o, n, total),
                                    total=total))
     .key_by(lambda c: c["key"]).time_window(TIER_WINDOW_MS)
     .sum(lambda c: c["value"]).add_sink(sink))
    t0 = time.perf_counter()
    job = env.execute(f"chip-smoke-tiered-{budget}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sink, env, job, time.perf_counter() - t0


def tier_reference(total):
    cols, ts = tier_gen(0, total, total)
    n_windows = int(ts.max()) // TIER_WINDOW_MS + 1
    return window_counts(cols["key"], ts // TIER_WINDOW_MS, TIER_KEYS,
                         n_windows), n_windows


def checkpoint_runs(dev, kind, smi, total_launches, total) -> None:
    """The checkpoint job in turns: the north star with checkpoints off,
    sync-full every CKPT_INTERVAL batches, crashed at the drain dispatch
    whose read emitted window 2 and restarted (the restore returns to the
    cut before it, so window 2 is emitted again and its values are held
    equal), and crashed on the producer thread and restarted; every run's
    rows against numpy's, each run's launches added to
    ``total_launches``. The producer runs ahead of the cuts in every
    run."""
    want_ck = ckpt_reference(total)
    n_windows_ck = len(want_ck) // N_KEYS
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as tmp:
        for name, kw in (
                ("off", {}),
                ("sync_full", dict(ckpt_dir=os.path.join(tmp, "a"))),
                ("crashed", dict(ckpt_dir=os.path.join(tmp, "b"),
                                 fault="step.drain")),
                ("crashed_producer", dict(ckpt_dir=os.path.join(tmp, "c"),
                                          fault="ingest.producer"))):
            launches, (sink, job, secs) = run_path(
                lambda kw=kw: ckpt_job(dev, total, **kw),
                total_launches)
            m = job.metrics
            cols = sink.columns()
            repeats = check_window_rows(cols, want_ck, n_windows_ck,
                                        WINDOW_MS, f"checkpoint {name}")
            rec = m.recovery_ms or []
            emit({"phase": "checkpoint", "run": name,
                  "events": total, "seconds": secs,
                  "events_per_s": total / secs,
                  "rows": len(cols["value"]), "repeated_windows": repeats,
                  "interval_batches": CKPT_INTERVAL if kw else None,
                  **ckpt_stats(m), "restarts": m.restarts,
                  "fault_to_first_drain_s": [r / 1e3 for r in rec],
                  "cut_between_emission_and_crash":
                      getattr(job, "cut_between", None),
                  "fire_latency_ms": fire_latency(m), "launches": launches,
                  "device": kind, "nvidia_smi": smi})
            check(m.dropped_late == 0 and m.dropped_capacity == 0,
                  f"checkpoint {name}: records dropped")
            check_launched(launches, CKPT_KERNELS, f"checkpoint {name}")
            if kw:
                check(bool(m.checkpoint_stats),
                      f"checkpoint {name}: no checkpoint taken")
            if name.startswith("crashed"):
                check(m.restarts == 1 and len(rec) == 1,
                      f"{name} run: {m.restarts} restarts, recovery {rec}")
            if name == "crashed":
                check(repeats > 0 or job.cut_between,
                      "crashed run: no window re-emitted")
            del sink, job, cols


def tiered_runs(dev, kind, smi, total_launches, total) -> None:
    """run_tiered's cell all-resident and tiered in turns, then tiered
    with the skew telemetry and the flight recorder feeding faults and
    heat; every run's rows against numpy's, the swaps checked."""
    want_t, n_windows_t = tier_reference(total)
    turns = {"all_resident": [], "tiered": []}
    tier_runs = (("all_resident", 0, None), ("tiered", TIER_BUDGET, None),
                 ("tiered", TIER_BUDGET, None), ("all_resident", 0, None),
                 ("tiered_kg_stats", TIER_BUDGET, TELEMETRY_CONFIG))
    for name, budget, cfg in tier_runs:
        launches, (sink, env_t, job, secs) = run_path(
            lambda b=budget, c=cfg: tier_job(dev, total, b, c),
            total_launches)
        m = job.metrics
        cols = sink.columns()
        check_window_rows(cols, want_t, n_windows_t, TIER_WINDOW_MS,
                          f"tiered job ({name})")
        eps = total / secs
        turns.setdefault(name, []).append(eps)
        line = {"phase": "tiered", "run": name, "events": total,
                "seconds": secs, "events_per_s": eps,
                "rows": len(cols["value"]),
                "fire_latency_ms": fire_latency(m),
                "spilled_records": m.spilled_records,
                "ring_drains": m.ring_drains, "compactions": m.compactions,
                "steps_fast": m.steps_fast, "launches": launches,
                "device": kind, "nvidia_smi": smi}
        check(m.dropped_late == 0 and m.dropped_capacity == 0,
              f"tiered job ({name}): records dropped")
        if budget:
            rep = env_t._pipeline_report()["tiers"]
            line.update(tiers=rep, tier_swap_host_s=m.tier_swap_s)
            check(rep["demotes"] > 0 and rep["promotes"] > 0,
                  f"tiered job ({name}): no swap ({rep})")
            check_launched(launches, TIER_KERNELS, f"tiered ({name})")
        emit(line)
        del sink, env_t, job, cols
    ratio = float(np.mean(turns["tiered"]) / np.mean(turns["all_resident"]))
    emit({"phase": "tiered_turns", "events_per_s_in_turns": turns,
          "tiered_over_all_resident": ratio,
          "reference_criterion": ">= 0.6 (information only; taken on a "
                                 "TPU, not asserted here)",
          "device": kind, "nvidia_smi": smi})


# ------------------- the ingest thread and the window runner's dispatch modes

WHILE_MAX_SLOTS = 32          # pipeline.while-drain.max-slots of the while run
RESIDENT_ON = {"pipeline.resident-loop": "on"}
NS_MODES = (
    ("auto", {}),                                     # the split path
    ("on", RESIDENT_ON),                              # the scan drain
    ("while", {"pipeline.resident-loop": "while",
               "pipeline.while-drain.max-slots": WHILE_MAX_SLOTS}),
    ("auto_prefetch_off", {"pipeline.prefetch": "off"}),
)


def device_busy(run, cpu=True):
    """``run()`` under torch.profiler: (what it returned, the card's busy
    ms — the union of kernel and copy intervals, the producer's copies
    included —). ``cpu=False`` records the card's activity alone, which
    costs the host less. The intervals come from the profiler's raw
    kineto events: building its FunctionEvent tree takes minutes on a
    job of millions of host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        out = run()
    spans = [(ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3)
             for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == DeviceType.CUDA]
    return out, _busy_ms(spans)


def north_star_modes(dev, kind, smi, total_launches, want_count) -> dict:
    """The north star through the public API in the four dispatch modes:
    ``auto`` (the split path: an update step a batch, the fire steps at
    each pane crossing, the producer thread polling and staging ahead),
    ``on`` (the scan drain), ``while`` (the while-drain, max_slots 32) and
    ``auto`` with ``pipeline.prefetch: off`` (the split path polled
    inline). Each run's count and sum against numpy, G1-G4 launched; a
    second, profiled run of each gives the card's idle share. Returns
    events/s by mode."""
    eps = {}
    for name, cfg in NS_MODES:
        launches, (sink, env, job, secs) = run_path(
            lambda c=cfg: north_star_job(dev, N_KEYS, EVENTS_PER_MS,
                                         TOTAL_EVENTS, BATCH, RING_DEPTH,
                                         config=c, with_env=True),
            total_launches)
        m = job.metrics
        check(sink.value_sum == float(TOTAL_EVENTS)
              and sink.count == want_count,
              f"north star ({name}): {sink.count} rows summing to "
              f"{sink.value_sum}, numpy {want_count} and {TOTAL_EVENTS}")
        check(m.dropped_late == 0 and m.dropped_capacity == 0,
              f"north star ({name}): records dropped")
        check_launched(launches, NORTH_STAR_KERNELS, f"north star ({name})")
        split = name.startswith("auto")
        check((m.resident_drains == 0) == split,
              f"north star ({name}): {m.resident_drains} drains")
        (_s, _e, job_p, wall_p), busy = device_busy(
            lambda c=cfg: north_star_job(dev, N_KEYS, EVENTS_PER_MS,
                                         TOTAL_EVENTS, BATCH, RING_DEPTH,
                                         config=c, with_env=True))
        eps[name] = TOTAL_EVENTS / secs
        emit({"phase": "north_star_mode", "mode": name, "config": cfg,
              "events": TOTAL_EVENTS, "seconds": secs,
              "events_per_s": eps[name],
              "fire_latency_ms": fire_latency(m),
              "device_busy_ms": busy, "profiled_wall_s": wall_p,
              "device_idle_share": 1.0 - busy / (wall_p * 1e3),
              "drains": m.resident_drains, "update_steps":
              0 if not split else m.steps, "batches": m.steps,
              "fire_steps": m.fire_steps,
              "ring_publish_refusals": m.ring_publish_refusals,
              "launches": launches, "device": kind, "nvidia_smi": smi})
        del sink, env, job, job_p
    return eps


# bench_configs.py:459 run_ingest_pipeline at its shape
INGEST_KEYS = 1 << 20
INGEST_CAPACITY = 1 << 21
INGEST_BATCH = 131_072
INGEST_WINDOW_MS = 10_000
INGEST_TOTAL = 15_000_000     # run_ingest_pipeline's 30M, cut likewise
INGEST_CKPT_INTERVAL = 8      # batches between two sync-full cuts


def ingest_gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    return ({"key": (idx * 2654435761) % INGEST_KEYS,
             "value": np.ones(n, np.float32)}, (idx // 32768) * 1000)


def ingest_job(device, total, prefetch, ckpt_dir=None, config=None):
    """run_ingest_pipeline's job: 2^20 keys, capacity 2^21, batches of
    131,072, 10 s tumbling sum into a CountingSink. Returns (sink, env,
    job, s)."""
    cfg = Configuration({"pipeline.prefetch": prefetch,
                         "keys.reverse-map": False, **(config or {})})
    env = StreamExecutionEnvironment(cfg, device=device)
    env.set_parallelism(1)
    env.set_max_parallelism(MAX_PARALLELISM)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(INGEST_CAPACITY)
    env.batch_size = INGEST_BATCH
    if ckpt_dir is not None:
        env.enable_checkpointing(INGEST_CKPT_INTERVAL, str(ckpt_dir))
    sink = CountingSink()
    (env.add_source(GeneratorSource(ingest_gen, total=total))
     .key_by(lambda c: c["key"]).time_window(INGEST_WINDOW_MS)
     .sum(lambda c: c["value"]).add_sink(sink))
    t0 = time.perf_counter()
    job = env.execute("chip-smoke-ingest")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sink, env, job, time.perf_counter() - t0


def ingest_reference(total) -> int:
    """numpy's (key, window) pairs of ingest_gen: each window's distinct
    keys."""
    per = INGEST_WINDOW_MS // 1000 * 32768
    n = 0
    for off in range(0, total, per):
        cols, _ = ingest_gen(off, min(per, total - off))
        n += len(np.unique(cols["key"]))
    return n


def ingest_runs(dev, kind, smi, total_launches, total=INGEST_TOTAL):
    """run_ingest_pipeline's three modes (prefetch off, on, on with
    sync-full cuts every 8 batches), each checked against numpy; the
    reference's incremental and async cuts raise here (ROADMAP item 13).
    Reports on-with-cuts over on."""
    want = ingest_reference(total)
    eps = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ingest-") as tmp:
        for name, prefetch, ckpt in (("prefetch_off", "off", False),
                                     ("prefetch_on", "on", False),
                                     ("prefetch_on_ckpt", "on", True)):
            launches, (sink, env, job, secs) = run_path(
                lambda p=prefetch, c=ckpt: ingest_job(
                    dev, total, p, os.path.join(tmp, "c") if c else None),
                total_launches)
            m = job.metrics
            check(sink.value_sum == float(total) and sink.count == want,
                  f"ingest {name}: {sink.count} rows summing to "
                  f"{sink.value_sum}, numpy {want} and {total}")
            check(m.dropped_late == 0 and m.dropped_capacity == 0,
                  f"ingest {name}: records dropped")
            check_launched(launches, ("route_lanes", "clear_rows",
                                      "scatter_update"), f"ingest {name}")
            eps[name] = total / secs
            emit({"phase": "ingest_pipeline", "run": name,
                  "events": total, "seconds": secs,
                  "events_per_s": eps[name], "rows": sink.count,
                  **ckpt_stats(m), "update_steps": m.steps,
                  "fire_steps": m.fire_steps,
                  "fire_latency_ms": fire_latency(m),
                  "launches": launches, "device": kind, "nvidia_smi": smi})
            if ckpt:
                check(bool(m.checkpoint_stats), "ingest: no checkpoint")
            del sink, env, job
        refused = []
        for cfg in ({"checkpoint.mode": "incremental"},
                    {"checkpoint.async": True}):
            try:
                ingest_job(dev, INGEST_BATCH, "on",
                           os.path.join(tmp, "r"), cfg)
            except NotImplementedError as e:
                refused.append(str(e))
        check(len(refused) == 2, "ingest: incremental or async cuts ran")
    emit({"phase": "ingest_pipeline_ratio",
          "ckpt_over_on": eps["prefetch_on_ckpt"] / eps["prefetch_on"],
          "on_over_off": eps["prefetch_on"] / eps["prefetch_off"],
          "reference_criterion": ">= 0.90 with incremental + async cuts "
                                 "(not ported, ROADMAP item 13; here "
                                 "sync-full, information only)",
          "refused": refused, "device": kind, "nvidia_smi": smi})


# bench_configs.py:1912 run_while_drain at its shape
WD_B, WD_C, WD_RING, WD_SLIDE, WD_BPP = 512, 4096, 9, 1000, 4
WD_D, WD_MS = 32, 64          # scan ring depth; while-drain max_slots
WD_GROUPS = 8                 # while dispatches a run (16 scan dispatches)


def while_stream(dev):
    """run_while_drain's firing stream on the card: WD_GROUPS * 64 batches
    of 512 lanes, half the lanes on 64 hot keys, 4 batches a pane, each
    batch's watermark closing the pane before it."""
    rng = np.random.default_rng(11)
    n = WD_GROUPS * WD_MS
    slots, wms, keys = [], [], []
    for j in range(n):
        p = j // WD_BPP
        hot = WD_B // 2
        lo = np.concatenate([rng.integers(0, WD_C - 1, WD_B - hot),
                             rng.integers(0, 64, hot)]).astype(np.int64)
        rng.shuffle(lo)
        keys.append(lo)
        ts = np.full(WD_B, p * WD_SLIDE + WD_SLIDE // 2, np.int32)
        slots.append(tuple(torch.from_numpy(a).to(dev) for a in (
            np.zeros(WD_B, np.int32), lo.astype(np.int32), ts,
            np.ones(WD_B, np.float32), np.ones(WD_B, bool))))
        wms.append(p * WD_SLIDE - 1)
    return slots, wms, keys


def while_drain_mirror(dev, kind, smi, total_launches) -> None:
    """run_while_drain: the scan drain at D = 32 against the while-drain
    at max_slots 64 (its cursor the whole staged burst, as the bench's
    steady state), B = 512, C = 4,096, ring 9, 4 fire lanes: events/s
    (best of 2 after a warm run), dispatches, p99 fire visibility, and
    every fired window's (keys, sum) against numpy's."""
    from flink_tpu_torch.ops import window_kernels as wk
    from flink_tpu_torch.runtime.step import (
        WindowStageSpec, build_window_resident_drain,
        build_window_while_drain, fire_only, init_shard_state)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    spec = WindowStageSpec(
        win=wk.WindowSpec(size_ticks=WD_SLIDE, slide_ticks=WD_SLIDE,
                          ring=WD_RING, fires_per_step=4),
        red=wk.ReduceSpec("sum"), capacity_per_shard=WD_C)
    slots, wms, keys = while_stream(dev)
    n = len(slots)
    n_panes = n // WD_BPP
    want = {(p + 1) * WD_SLIDE: (len(np.unique(np.concatenate(
        keys[p * WD_BPP:(p + 1) * WD_BPP]))), float(WD_B * WD_BPP))
        for p in range(n_panes)}

    def measure(group, drain, is_while):
        wmvs = [torch.tensor(wms[g * group:(g + 1) * group],
                             dtype=torch.int32, device=dev)
                for g in range(n // group)]
        lat, rows = [], {}

        def read(cf, t_d):
            c, ok, e, s = (t.cpu().numpy() for t in (
                cf.counts, cf.lane_valid, cf.window_end_ticks,
                cf.value_sums))
            for cc, oo, ee, ss in zip(c.reshape(-1), ok.reshape(-1),
                                      e.reshape(-1), s.reshape(-1)):
                if oo:
                    check(int(ee) not in rows, f"window {ee} fired twice")
                    rows[int(ee)] = (int(cc), float(ss))
            lat.append((max(int(ok.sum()), 1),
                        (time.perf_counter() - t_d) * 1e3))

        def run_once():
            rows.clear()
            state = init_shard_state(spec, MAX_PARALLELISM, dev)
            sync()
            t0 = time.perf_counter()
            pend = None
            for g in range(n // group):
                sel = slots[g * group:(g + 1) * group]
                if is_while:
                    base = g * group
                    out = drain(state, sel, wmvs[g], base + group, base,
                                group)
                else:
                    out = drain(state, sel, wmvs[g], group)
                state, fires = out[0], out[2]
                if pend is not None:
                    read(*pend)
                pend = (fires, time.perf_counter())
            read(*pend)
            sync()
            dt = time.perf_counter() - t0
            while True:                    # the last panes, at the end
                state, fr = fire_only(state, spec, 2**31 - 4)
                read(fr, time.perf_counter())
                if int(fr.lane_valid.sum()) < spec.win.fires_per_step:
                    break
            return dt

        run_once()
        lat.clear()
        dt = min(run_once() for _ in range(2))
        check(rows == want, f"while mirror: fired windows differ from "
                            f"numpy's ({len(rows)} of {len(want)})")
        return WD_B * n / dt, lat, n // group

    def p99(lat):
        return weighted_percentile(lat, 99)

    launches, res = run_path(lambda: (
        measure(WD_D, build_window_resident_drain(
            spec, WD_D, MAX_PARALLELISM, reduced=True), False),
        measure(WD_MS, build_window_while_drain(
            spec, WD_MS, MAX_PARALLELISM, reduced=True), True)),
        total_launches)
    (scan_eps, scan_lat, scan_n), (while_eps, while_lat, while_n) = res
    check_launched(launches, NORTH_STAR_KERNELS, "while mirror")
    emit({"phase": "while_drain_mirror", "B": WD_B, "C": WD_C,
          "ring": WD_RING, "batches": n, "bpp": WD_BPP,
          "scan_d32": {"events_per_s": scan_eps, "dispatches": scan_n,
                       "p99_fire_ms": p99(scan_lat)},
          "while_ms64": {"events_per_s": while_eps, "dispatches": while_n,
                         "p99_fire_ms": p99(while_lat)},
          "throughput_ratio": while_eps / scan_eps,
          "dispatch_cut": scan_n / while_n, "windows_checked": len(want),
          "launches": launches, "device": kind, "nvidia_smi": smi})


def ring_race(dev, kind, smi, m_batches=512, b=8192, depth=16) -> None:
    """A producer thread publishes into a device ring on the card (its
    copy stream, waiting while the ring is full) while the step loop
    retires slots from write-cursor snapshots: each retired slot's
    payload, read after the loop's stream waited on its copy, is the
    batch published into it, and every slot is retired once."""
    import threading

    from flink_tpu_torch.runtime.ingest import DeviceBatchRing, IngestPlan

    plan = IngestPlan(td=None, slide_ticks=1, span_limit=1, B=b,
                      staging=True, device=dev, ring_depth=depth)
    ring = DeviceBatchRing(plan, depth)
    events, errs = [], []

    def producer():
        try:
            for j in range(m_batches):
                args = (np.zeros(b, np.uint32),
                        np.full(b, j, np.uint32), np.full(b, j, np.int32),
                        np.full(b, j, np.float32))
                while True:
                    pub = ring.try_publish(plan, *args, b, "mask", 0)
                    if pub is not None:
                        break
                    time.sleep(0.0001)
                events.append(pub[2])
        except Exception as e:     # surfaced by the check below
            errs.append(e)

    t = threading.Thread(target=producer, daemon=True)
    t0 = time.perf_counter()
    t.start()
    retired, freed, snaps = 0, 0, []
    cur = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    deadline = time.monotonic() + 120
    while retired < m_batches and time.monotonic() < deadline:
        snap = min(ring.write_cursor(), len(events))
        snaps.append(snap)
        for s in range(retired, snap):
            if cur is not None:
                cur.wait_event(events[s])
            hi, lo, ts, vals, ok = ring.slot(s)
            got = torch.stack([lo.float().sum(), ts.float().sum(),
                               vals.sum(), ok.float().sum()]).cpu()
            check(got.tolist() == [float(s * b)] * 3 + [float(b)],
                  f"ring race: slot {s} holds {got.tolist()}")
            ring.note_read([s])
            freed += ring.release_through(s)
        retired = snap
    t.join(timeout=30)
    check(not t.is_alive() and not errs, f"ring race: producer {errs}")
    check(freed == m_batches and ring.occupancy() == 0
          and snaps == sorted(snaps),
          f"ring race: {freed} of {m_batches} retired")
    emit({"phase": "ring_race", "batches": m_batches, "lanes": b,
          "depth": depth, "retired": freed,
          "refusals": ring.refusals()[0], "consumer_reads": len(snaps),
          "seconds": time.perf_counter() - t0, "device": kind,
          "nvidia_smi": smi})


# ------------------------------------------------------------ megasteps

MEGA_K = 8                    # pipeline.steps-per-dispatch of the runs
MEGA_OFF = {"pipeline.resident-loop": "off",
            "pipeline.steps-per-dispatch": MEGA_K}
MEGA_MODES = (
    ("k1", {"pipeline.resident-loop": "off"}),       # the split path
    ("k8_fused_fire", MEGA_OFF),                     # fused-fire megasteps
    ("k8_fire_off", {**MEGA_OFF, "pipeline.fused-fire": "off"}),
)
CTL_RUNS = (
    ("on", {**RESIDENT_ON, "observability.drain-stats": True,
            "observability.kg-stats": True, "controller.enabled": True}),
    ("off_k8", {**MEGA_OFF, "controller.enabled": True}),
)


def mega_inputs(dev, k=MEGA_K, batch=BATCH):
    """``k`` north-star batches straddling the first 5 s window's end
    (k / 2 before it), as staged slots, and their watermarks (each
    batch's newest time less 1 ms) as an int32 [k] device tensor."""
    first = WINDOW_MS * EVENTS_PER_MS - (k // 2) * batch
    i32 = dict(dtype=torch.int32, device=dev)
    slots, wms = [], []
    for j in range(k):
        keys, ts, vals = gen_batch(first + j * batch, batch)
        slots.append((torch.zeros(batch, **i32), _t(keys, dev, torch.int32),
                      _t(ts, dev, torch.int32),
                      _t(vals, dev, torch.float32),
                      torch.ones(batch, dtype=torch.bool, device=dev)))
        wms.append(int(ts.max()) - 1)
    return slots, torch.tensor(wms, **i32)


def _fires_equal(a, b) -> bool:
    """Two fire payloads equal: every small field, and the compact rows'
    ``[:count]`` prefixes lane by lane."""
    small = ("counts", "window_end_ticks", "n_fires", "lane_valid",
             "value_sums")
    if not all(torch.equal(getattr(a, n), getattr(b, n)) for n in small):
        return False
    if not hasattr(a, "key_hi"):
        return True
    counts = a.counts.cpu().tolist()
    return all(torch.equal(getattr(a, n)[f, :c], getattr(b, n)[f, :c])
               for f, c in enumerate(counts)
               for n in ("key_hi", "key_lo", "values"))


def mega_kernel_phase(dev, timing=True, k=MEGA_K, batch=BATCH) -> dict:
    """The K-step megasteps against K sequential single steps on the card
    at the north star's shapes (C = 1M, R = 8, F = 2, B = 262,144, K = 8,
    direct layout, sum), over K batches that cross a window end half-way:
    the plain megastep against K update steps, the fused-fire megastep
    (reduced and compact) against K update-then-fire steps; every state
    field and every sub-step's fires bit-equal. Timed with the card
    synchronised around one call each (host-bound: the wall is the
    number), best of 3 on fresh states."""
    from flink_tpu_torch.ops import window_kernels as wk
    from flink_tpu_torch.runtime.step import (
        WindowStageSpec, build_window_megastep, build_window_megastep_fired,
        build_window_update_step, fire_only, init_shard_state)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    spec = WindowStageSpec(
        win=wk.WindowSpec(size_ticks=WINDOW_MS, slide_ticks=WINDOW_MS,
                          ring=RING_PANES, fires_per_step=FIRES_PER_STEP),
        red=wk.ReduceSpec("sum"), capacity_per_shard=N_KEYS)
    slots, wmv = mega_inputs(dev, k, batch)
    upd = build_window_update_step(spec, MAX_PARALLELISM)
    out = {}
    for variant in ("plain", "fired_reduced", "fired_compact"):
        fired = variant != "plain"
        reduced = variant == "fired_reduced"
        if fired:
            mega = build_window_megastep_fired(spec, k, MAX_PARALLELISM,
                                               reduced=reduced)
        else:
            mega = build_window_megastep(spec, k, MAX_PARALLELISM)

        def singles():
            st = init_shard_state(spec, MAX_PARALLELISM, dev)
            frs = []
            for i in range(k):
                st, _ = upd(st, *slots[i], wmv[i])
                if fired:
                    st, fr = fire_only(st, spec, wmv[i], reduced=reduced)
                    frs.append(fr)
            return st, frs

        def fused():
            st = init_shard_state(spec, MAX_PARALLELISM, dev)
            res = mega(st, slots, wmv)
            return res[0], res[2] if fired else None

        s1, oracle = singles()
        s2, stack = fused()
        a, b = wk.state_to_numpy(s1), wk.state_to_numpy(s2)
        diff = [n for n in wk.STATE_FIELDS if not np.array_equal(a[n], b[n])]
        check(not diff, f"megastep {variant}: state fields {diff} differ "
                        f"from {k} single steps")
        n_fired = 0
        for i, fr in enumerate(oracle):
            sub = type(stack)(*(getattr(stack, f)[i] for f in
                                type(stack).__dataclass_fields__))
            check(_fires_equal(fr, sub),
                  f"megastep {variant}: sub-step {i}'s fires differ")
            n_fired += int(fr.counts.sum())
        check(not fired or n_fired > 0, f"megastep {variant}: nothing fired")
        rec = {"max_abs_err": 0.0, "fired_keys": n_fired}
        if timing:
            def wall(fn):
                best = float("inf")
                for _ in range(3):
                    sync()
                    t0 = time.perf_counter()
                    fn()
                    sync()
                    best = min(best, time.perf_counter() - t0)
                return best * 1e3
            rec["megastep_ms"] = wall(fused)
            rec["singles_ms"] = wall(singles)
        out[variant] = rec
        del s1, s2, oracle, stack
    return out


def megastep_runs(dev, kind, smi, total_launches, want_count) -> None:
    """The north star (30M events) with ``pipeline.resident-loop: off`` at
    K = 1 (the split path), K = 8 with fused fire (every full group one
    fused-fire megastep, reduced on the card for the CountingSink) and
    K = 8 with ``pipeline.fused-fire: off`` (plain megasteps, groups
    broken at each crossing, the fire steps after); then ``auto`` at
    K = 8, which on CUDA with staging must resolve to the scan drain.
    Each run's count and sum against numpy, G1-G4 launched, events/s,
    p99 fire latency, the dispatch counters and, from a second profiled
    run, the card's idle share."""
    for name, cfg in MEGA_MODES + (("auto_k8",
                                    {"pipeline.steps-per-dispatch":
                                     MEGA_K}),):
        launches, (sink, env, job, secs) = run_path(
            lambda c=cfg: north_star_job(dev, N_KEYS, EVENTS_PER_MS,
                                         TOTAL_EVENTS, BATCH, RING_DEPTH,
                                         config=c, with_env=True),
            total_launches)
        m = job.metrics
        check(sink.value_sum == float(TOTAL_EVENTS)
              and sink.count == want_count,
              f"megastep run ({name}): {sink.count} rows summing to "
              f"{sink.value_sum}, numpy {want_count} and {TOTAL_EVENTS}")
        check(m.dropped_late == 0 and m.dropped_capacity == 0,
              f"megastep run ({name}): records dropped")
        check_launched(launches, NORTH_STAR_KERNELS, f"megastep ({name})")
        if name == "auto_k8":
            # the reference's platform gate: the scan drain on the card,
            # megasteps on the CPU
            drained = dev.type == "cuda"
            check((m.resident_drains > 0) == drained
                  and (m.fused_dispatches == 0) == drained,
                  f"auto at K = 8: {m.resident_drains} drains, "
                  f"{m.fused_dispatches} megasteps")
        elif name == "k1":
            check(m.fused_dispatches == 0 and m.resident_drains == 0,
                  "K = 1: a megastep or a drain ran")
        else:
            check(m.fused_dispatches > 0 and m.resident_drains == 0,
                  f"{name}: {m.fused_dispatches} megasteps")
            check((m.fused_fire_dispatches == m.fused_dispatches)
                  == (name == "k8_fused_fire"),
                  f"{name}: {m.fused_fire_dispatches} of "
                  f"{m.fused_dispatches} megasteps fired")
        line = {"phase": "megastep_run", "mode": name, "config": cfg,
                "events": TOTAL_EVENTS, "seconds": secs,
                "events_per_s": TOTAL_EVENTS / secs,
                "fire_latency_ms": fire_latency(m), "batches": m.steps,
                "fused_dispatches": m.fused_dispatches,
                "fused_fire_dispatches": m.fused_fire_dispatches,
                "drains": m.resident_drains, "fire_steps": m.fire_steps,
                "steps_per_dispatch":
                    env._pipeline_report()["steps_per_dispatch"],
                "launches": launches}
        if name != "auto_k8":
            (_s, _e, _j, wall_p), busy = device_busy(
                lambda c=cfg: north_star_job(dev, N_KEYS, EVENTS_PER_MS,
                                             TOTAL_EVENTS, BATCH,
                                             RING_DEPTH, config=c,
                                             with_env=True))
            line.update({"device_busy_ms": busy, "profiled_wall_s": wall_p,
                         "device_idle_share": 1.0 - busy / (wall_p * 1e3)})
        emit({**line, "device": kind, "nvidia_smi": smi})
        del sink, env, job


def controller_runs(dev, kind, smi, total_launches, want_count) -> None:
    """The north star with ``controller.enabled: true`` on ``on`` (the
    recorder and key-group heat on: its ``ring-fill-target`` and
    ``drain-stats-cadence`` arms) and on ``off`` at K = 8 (its
    ``dispatch-group`` arm): rows against numpy, then one line each of
    the controller's actions, reverts and actuators, and of the doctor's
    findings."""
    for name, cfg in CTL_RUNS:
        launches, (sink, env, job, secs) = run_path(
            lambda c=cfg: north_star_job(dev, N_KEYS, EVENTS_PER_MS,
                                         TOTAL_EVENTS, BATCH, RING_DEPTH,
                                         config=c, with_env=True),
            total_launches)
        check(sink.value_sum == float(TOTAL_EVENTS)
              and sink.count == want_count,
              f"controller run ({name}): {sink.count} rows summing to "
              f"{sink.value_sum}")
        check_launched(launches, NORTH_STAR_KERNELS, f"controller ({name})")
        ctl = env._controller_report()
        doc = env._doctor_report()
        check(ctl["available"] and doc["available"],
              f"controller run ({name}): no controller or doctor report")
        check(ctl["rebalances"] == 0, "one shard rebalanced")
        emit({"phase": "controller", "mode": name, "events": TOTAL_EVENTS,
              "seconds": secs, "events_per_s": TOTAL_EVENTS / secs,
              "cycles": ctl["cycle"], "actions": ctl["actions"],
              "reverts": ctl["reverts"], "actuators": ctl["actuators"],
              "ledger": [{k: e.get(k) for k in ("kind", "actuator",
                                                "before", "after")}
                         for e in ctl["ledger"]][-12:],
              "fused_dispatches": job.metrics.fused_dispatches,
              "drains": job.metrics.resident_drains,
              "device": kind, "nvidia_smi": smi})
        emit({"phase": "doctor", "mode": name, "clean": doc["clean"],
              "findings": [{k: f[k] for k in ("rule", "severity", "score")}
                           for f in doc["findings"]],
              "fire_latency_ms": doc["snapshot"]["fire_latency_ms"],
              "device": kind, "nvidia_smi": smi})
        del sink, env, job


# bench_configs.py:1306 run_device_update_ceiling's fire_grid, cut to
# FG_BATCHES batches a cell (its 1,024 x K would take minutes eagerly)
FG_B, FG_C, FG_RING, FG_SLIDE, FG_BPP, FG_F = 512, 4096, 9, 1000, 4, 4
FG_BATCHES = 256
FG_KS = (1, 4, 8)
FG_DUPS = (0.0, 0.5)


def fire_grid_stream(dev, dup, n):
    """The grid's firing stream: ``n`` batches of FG_B lanes, a share
    ``dup`` of them on 64 hot keys, pane j // FG_BPP, each batch's
    watermark closing the pane before it; and numpy's (keys, sum) per
    window end."""
    rng = np.random.default_rng(11)
    slots, wms, panes = [], [], {}
    for j in range(n):
        p = j // FG_BPP
        n_hot = int(FG_B * dup)
        lo = np.concatenate([rng.integers(0, FG_C - 1, FG_B - n_hot),
                             rng.integers(0, 64, n_hot)]).astype(np.int64)
        rng.shuffle(lo)
        panes.setdefault(p, []).append(lo)
        ts = np.full(FG_B, p * FG_SLIDE + FG_SLIDE // 2, np.int32)
        slots.append(tuple(torch.from_numpy(a).to(dev) for a in (
            np.zeros(FG_B, np.int32), lo.astype(np.int32), ts,
            np.ones(FG_B, np.float32), np.ones(FG_B, bool))))
        wms.append(p * FG_SLIDE - 1)
    want = {(p + 1) * FG_SLIDE: (len(np.unique(np.concatenate(v))),
                                 float(FG_B * len(v)))
            for p, v in panes.items()}
    return slots, wms, want


def fire_grid(dev, kind, smi, total_launches, n=FG_BATCHES) -> None:
    """run_device_update_ceiling's fire_grid on the card: B = 512, C =
    4,096, ring 9, 4 fire lanes, 4 batches a pane, K in {1, 4, 8}, dup in
    {0, 0.5}, each cell in the two disciplines — ``split`` (a group breaks
    at each crossing, partial groups run as single steps, then the
    reduced fire step and its blocking small-field read) and ``fused``
    (fused-fire megasteps throughout, reduced, read one dispatch late) —:
    events/s and host us a batch (one timed run after a warm run), and every
    window fired equal to numpy's (keys, sum)."""
    from flink_tpu_torch.ops import window_kernels as wk
    from flink_tpu_torch.runtime.step import (
        WindowStageSpec, build_window_fire_reduced_step,
        build_window_megastep, build_window_megastep_fired,
        build_window_update_step, init_shard_state)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    spec = WindowStageSpec(
        win=wk.WindowSpec(size_ticks=FG_SLIDE, slide_ticks=FG_SLIDE,
                          ring=FG_RING, fires_per_step=FG_F),
        red=wk.ReduceSpec("sum"), capacity_per_shard=FG_C)
    step1 = build_window_update_step(spec, MAX_PARALLELISM)
    fire = build_window_fire_reduced_step(spec)
    i32 = dict(dtype=torch.int32, device=dev)

    def read(fr, rows):
        c, ok, e, v = (t.cpu().numpy() for t in (
            fr.counts, fr.lane_valid, fr.window_end_ticks, fr.value_sums))
        for cc, oo, ee, vv in zip(c.reshape(-1), ok.reshape(-1),
                                  e.reshape(-1), v.reshape(-1)):
            if oo:
                check(int(ee) not in rows, f"fire grid: {ee} fired twice")
                rows[int(ee)] = (int(cc), float(vv))

    def split(K, slots, wms, rows):
        mega = build_window_megastep(spec, K, MAX_PARALLELISM) \
            if K > 1 else None
        st = init_shard_state(spec, MAX_PARALLELISM, dev)
        pend, last = [], -(2**31) + 1
        for j in range(len(slots)):
            pend.append(j)
            crossing = wms[j] > last
            if crossing or len(pend) == K:
                if len(pend) == K and mega is not None:
                    st, _ = mega(st, [slots[i] for i in pend],
                                 torch.tensor([wms[i] for i in pend],
                                              **i32))
                else:
                    for i in pend:
                        st, _ = step1(st, *slots[i],
                                      torch.tensor(wms[i], **i32))
                pend = []
                if crossing:
                    st, fr = fire(st, torch.tensor(wms[j], **i32))
                    read(fr, rows)
                    last = wms[j]

    def fused(K, slots, wms, rows):
        mega = build_window_megastep_fired(spec, K, MAX_PARALLELISM,
                                           reduced=True)
        st = init_shard_state(spec, MAX_PARALLELISM, dev)
        lag = None
        for g in range(len(slots) // K):
            sel = range(g * K, (g + 1) * K)
            st, _mon, fr = mega(st, [slots[i] for i in sel],
                                torch.tensor([wms[i] for i in sel], **i32))
            if lag is not None:
                read(lag, rows)
            lag = fr
        read(lag, rows)

    cells = {}
    for dup in FG_DUPS:
        slots, wms, want = fire_grid_stream(dev, dup, n)
        for K in FG_KS:
            for name, run in (("split", split), ("fused", fused)):
                best = float("inf")
                for rep in range(2):   # a warm run, then the timed one
                    rows = {}
                    sync()
                    t0 = time.perf_counter()
                    run(K, slots, wms, rows)
                    sync()
                    if rep:
                        best = min(best, time.perf_counter() - t0)
                fired = {e: want.get(e) for e in rows}
                check(rows == fired and len(rows) == len(want) - 1,
                      f"fire grid {name} K{K} dup {dup}: {len(rows)} "
                      f"windows, numpy {len(want) - 1} closed, rows "
                      f"{'equal' if rows == fired else 'differ'}")
                cells[f"{name}_K{K}_dup_{dup}"] = {
                    "events_per_s": FG_B * n / best,
                    "host_us_per_batch": best / n * 1e6}
    ratio = {f"K{K}_dup_{dup}": cells[f"fused_K{K}_dup_{dup}"]
             ["events_per_s"] / cells[f"split_K{K}_dup_{dup}"]
             ["events_per_s"] for K in FG_KS for dup in FG_DUPS}
    emit({"phase": "fire_grid", "B": FG_B, "C": FG_C, "ring": FG_RING,
          "bpp": FG_BPP, "fire_lanes": FG_F, "batches": n, "cells": cells,
          "fused_over_split": ratio, "device": kind, "nvidia_smi": smi})


# ------------------------------------------------------------ phase 23

LIB_SEED = 13                 # every library workload's data
TPCH_LINEITEM = 6_001_215     # lineitem rows at SF1
TPCH_ORDERS = 1_500_000       # orders at SF1
TPCH_SUPPLIERS = 10_000       # supplier rows at SF1
TPCH_CURRENT = 1263           # dbgen's CURRENTDATE 1995-06-17, days from 1992-01-01
TPCH_Q1_SHIPDATE = 2436       # 1998-12-01 - 90 days
WC_WORDS = 1_000_000
JOIN_PROBES = 1_000_000
G500_SCALE = 20
G500_EDGE_FACTOR = 16
G500_DENSE_SCALE = 12         # the dense metrics' V = 4,096
# the iterations of the timed runs, cut (from 30, 30, 20 and 10) to hold
# the whole script under 800 s: every check holds at any count
PR_ITERS = 5
HITS_ITERS = 5
SSSP_SUPERSTEPS = 128
KM_N, KM_D, KM_K, KM_ITERS = 1 << 20, 16, 64, 5
KNN_Q, KNN_K, KNN_SAMPLE = 4096, 10, 64
MLR_N, MLR_D = 1 << 20, 64
ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS = 6040, 3706, 1_000_209
ALS_F, ALS_ITERS = 10, 5
Q1_RTOL = 1e-3                # Q1's float32 sums against float64: both
                              # packages accumulate in float32
PR_RTOL = 1e-3                # PageRank's float32 ranks against float64
LIB_KERNELS = ("scatter_ids", "sorted_probe", "row_argmin", "row_argmax")
LIB_WALL = []                 # each workload's seconds, for the phase line

Q1_SQL = (
    "SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty, "
    "SUM(l_extendedprice) AS sum_base_price, "
    "SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price, "
    "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge, "
    "AVG(l_quantity) AS avg_qty, AVG(l_extendedprice) AS avg_price, "
    "AVG(l_discount) AS avg_disc, COUNT(*) AS count_order "
    f"FROM lineitem WHERE l_shipdate <= {TPCH_Q1_SHIPDATE} "
    "GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag")
Q18_SQL = ("SELECT l_orderkey, SUM(l_quantity) AS sum_qty FROM lineitem "
           "GROUP BY l_orderkey")


_LINEITEM = {}


def tpch_lineitem(seed=LIB_SEED) -> dict:
    """A lineitem table at SF1 (6,001,215 rows) with dbgen's value
    distributions: 1-7 lines an order (moved to SF1's total one line at a
    time), dbgen's sparse order keys, quantity 1-50, extended price =
    quantity x the part's retail price, discount 0-0.10 and tax 0-0.08 in
    hundredths, order date uniform over 1992-01-01 .. 1998-08-02, ship 1-121
    days later, receipt 1-30 after that; return flag R or A (even odds)
    when received by 1995-06-17, else N; line status O when shipped after
    it, else F. Dates are days from 1992-01-01; also ``order_index``, each
    line's order 0..1.5M-1, and ``suppkey`` 1..10,000. Made once a
    seed."""
    if seed in _LINEITEM:
        return _LINEITEM[seed]
    rng = np.random.default_rng(seed)
    lines = rng.integers(1, 8, TPCH_ORDERS)
    diff = TPCH_LINEITEM - int(lines.sum())
    room = np.nonzero(lines < 7 if diff > 0 else lines > 1)[0][:abs(diff)]
    lines[room] += 1 if diff > 0 else -1
    check(int(lines.sum()) == TPCH_LINEITEM, "lineitem: wrong row count")
    o = np.arange(TPCH_ORDERS, dtype=np.int64)
    orderkey = ((o >> 3) << 5) + (o & 7) + 1
    order_index = np.repeat(o, lines)
    n = TPCH_LINEITEM
    orderdate = rng.integers(0, 2406, TPCH_ORDERS)[order_index]
    shipdate = orderdate + rng.integers(1, 122, n)
    receipt = shipdate + rng.integers(1, 31, n)
    partkey = rng.integers(1, 200_001, n)
    retail = (90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)) \
        / 100.0
    qty = rng.integers(1, 51, n)
    flag = np.where(receipt <= TPCH_CURRENT,
                    np.where(rng.random(n) < 0.5, "R", "A"), "N")
    _LINEITEM[seed] = {
        "l_orderkey": orderkey[order_index],
        "l_quantity": qty.astype(np.float64),
        "l_extendedprice": qty * retail,
        "l_discount": rng.integers(0, 11, n) / 100.0,
        "l_tax": rng.integers(0, 9, n) / 100.0,
        "l_returnflag": flag,
        "l_linestatus": np.where(shipdate > TPCH_CURRENT, "O", "F"),
        "l_shipdate": shipdate,
        "order_index": order_index,
        "l_suppkey": rng.integers(1, TPCH_SUPPLIERS + 1, n),
    }
    return _LINEITEM[seed]


def q1_groups(li):
    """Each row's Q1 group code (R/A/N x F/O), int64."""
    f = np.searchsorted(np.array(["A", "N", "R"]), li["l_returnflag"])
    return f * 2 + (li["l_linestatus"] == "O")


def kronecker_edges(scale, edge_factor, seed):
    """Graph500's Kronecker generator (A, B, C = 0.57, 0.19, 0.19): edge
    factor x 2^scale edges over 2^scale vertices, vertex labels permuted
    at random. Returns (src, dst) int64."""
    rng = np.random.default_rng(seed)
    m = edge_factor << scale
    a, b, c = 0.57, 0.19, 0.19
    ab = a + b
    c_norm, a_norm = c / (1 - ab), a / ab
    i = np.zeros(m, np.int64)
    j = np.zeros(m, np.int64)
    for bit in range(scale):
        ii = rng.random(m, dtype=np.float32) > ab
        jj = rng.random(m, dtype=np.float32) > np.where(ii, c_norm, a_norm)
        i |= ii.astype(np.int64) << bit
        j |= jj.astype(np.int64) << bit
    perm = rng.permutation(1 << scale)
    return perm[i], perm[j]


def g500_graph(scale, seed):
    """Graph500's graph at ``scale`` (edge factor 16) made undirected by
    doubling, with Graph500's SSSP weights uniform(0, 1) (one an edge,
    both directions): (src, dst) int32 and w float32, 2^(scale + 5)
    directed edges."""
    i, j = kronecker_edges(scale, G500_EDGE_FACTOR, seed)
    w = np.random.default_rng(seed + 1).random(len(i), dtype=np.float32)
    return (np.concatenate([i, j]).astype(np.int32),
            np.concatenate([j, i]).astype(np.int32), np.concatenate([w, w]))


def blob_points(n, d, k, seed):
    """n points around k centers uniform in [-100, 100]^d, sd 0.05, and
    each point's blob: blobs this tight and far apart make k-means++ seed
    one center a blob (a second seed in a blob would split it, and the
    points along the split would tie within float32's rounding)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-100, 100, (k, d))
    lab = rng.integers(0, k, n)
    return (means[lab] + rng.normal(0, 0.05, (n, d))).astype(np.float32), \
        lab


def lib_run(name, run, total_launches, kind, smi, n, unit,
            need=LIB_KERNELS) -> tuple:
    """Run one library workload through the port's public API with the
    launch counts set to 0 just before and read just after, under
    torch.profiler for the card's busy time; returns (what run returned,
    the line's timing fields)."""
    t0 = time.perf_counter()
    launches, (out, busy) = run_path(lambda: device_busy(run),
                                     total_launches)
    secs = time.perf_counter() - t0
    LIB_WALL.append(secs)
    check_launched(launches, need, name)
    return out, {"phase": "libraries", "workload": name, "seconds": secs,
                 f"{unit}_per_s": n / secs, "busy_ms": busy,
                 "idle_share": 1.0 - busy / (secs * 1e3),
                 "launches": {k: launches[k] for k in LIB_KERNELS},
                 "device": kind, "nvidia_smi": smi}


def lib_table_runs(dev, kind, smi, total_launches, li) -> None:
    from flink_tpu_torch.table import TableEnvironment

    cols = {k: v for k, v in li.items() if k.startswith("l_")}
    tenv = TableEnvironment.create(device=dev)
    tenv.register_table("lineitem", tenv.from_columns(cols))
    t, line = lib_run("tpch_q1", lambda: tenv.sql_query(Q1_SQL),
                      total_launches, kind, smi, TPCH_LINEITEM, "rows",
                      ("scatter_ids",))
    keep = li["l_shipdate"] <= TPCH_Q1_SHIPDATE
    g = q1_groups(li)[keep]
    price = li["l_extendedprice"][keep]
    disc = li["l_discount"][keep]
    want = {"sum_qty": li["l_quantity"][keep], "sum_base_price": price,
            "sum_disc_price": price * (1 - disc),
            "sum_charge": price * (1 - disc) * (1 + li["l_tax"][keep]),
            "avg_qty": li["l_quantity"][keep], "avg_price": price,
            "avg_disc": disc}
    cnt = np.bincount(g, minlength=6)
    got_g = (np.searchsorted(np.array(["A", "N", "R"]),
                             t.cols["l_returnflag"]) * 2
             + (t.cols["l_linestatus"] == "O"))
    check(t.n == 4 and sorted(got_g.tolist()) == sorted(
        np.nonzero(cnt)[0].tolist()), f"tpch_q1: {t.n} groups")
    check(np.array_equal(t.cols["count_order"], cnt[got_g]),
          "tpch_q1: COUNT(*) differs from numpy")
    rel = 0.0
    for name, v in want.items():
        ref = np.bincount(g, weights=v, minlength=6)[got_g]
        if name.startswith("avg"):
            ref = ref / cnt[got_g]
        rel = max(rel, float(np.max(np.abs(t.cols[name] - ref) / ref)))
    check(rel <= Q1_RTOL, f"tpch_q1: sums {rel} from float64, over "
                          f"{Q1_RTOL}")
    emit({**line, "groups": t.n, "rows_in": int(keep.sum()),
          "aggregates": 8, "max_rel_err_vs_float64": rel,
          "rtol": Q1_RTOL})
    del t

    t, line = lib_run("tpch_q18_inner", lambda: tenv.sql_query(Q18_SQL),
                      total_launches, kind, smi, TPCH_LINEITEM, "rows",
                      ("scatter_ids",))
    ref = np.bincount(li["order_index"], weights=li["l_quantity"])
    okeys = li["l_orderkey"][np.r_[0, np.nonzero(
        np.diff(li["order_index"]))[0] + 1]]
    check(t.n == TPCH_ORDERS
          and np.array_equal(t.cols["l_orderkey"], okeys)
          and np.array_equal(t.cols["sum_qty"], ref.astype(np.float32)),
          "tpch_q18_inner: the per-order sums differ from numpy")
    emit({**line, "groups": t.n, "exact": True})


def lib_dataset_runs(dev, kind, smi, total_launches, li) -> None:
    from flink_tpu_torch.dataset import ExecutionEnvironment

    env = ExecutionEnvironment.get_execution_environment(device=dev)
    ranks = word_ranks(np.arange(WC_WORDS, dtype=np.int64))
    words = [f"w{r}" for r in ranks.tolist()]
    rows, line = lib_run(
        "dataset_wordcount",
        lambda: env.from_collection(words).map(lambda w: (w, 1))
        .group_by(0).sum(1).collect(),
        total_launches, kind, smi, WC_WORDS, "words", ("scatter_ids",))
    uniq, cnt = np.unique(ranks, return_counts=True)
    want = dict(zip([f"w{r}" for r in uniq.tolist()], cnt.tolist()))
    check(dict(rows) == want, "dataset_wordcount: counts differ from numpy")
    emit({**line, "distinct_words": len(rows), "exact": True})
    del rows, words

    sup = [(k, f"Supplier#{k:09d}") for k in range(1, TPCH_SUPPLIERS + 1)]
    rng = np.random.default_rng(LIB_SEED + 2)
    keys = li["l_suppkey"][:JOIN_PROBES].copy()
    miss = rng.random(JOIN_PROBES) < 0.2
    keys[miss] += TPCH_SUPPLIERS          # no such supplier
    probe = list(zip(keys.tolist(), range(JOIN_PROBES)))

    def join():
        j = (env.from_collection(probe).join(env.from_collection(sup))
             .where(0).equal_to(0).apply(lambda p, s: (p[1], s[0])))
        return j.collect(), j.strategy

    (pairs, strategy), line = lib_run(
        "dataset_broadcast_join", join, total_launches, kind, smi,
        JOIN_PROBES, "probes", ("sorted_probe",))
    got = np.asarray(pairs, np.int64).reshape(-1, 2)
    got = got[np.argsort(got[:, 0], kind="stable")]
    want_i = np.nonzero(~miss)[0]
    check(np.array_equal(got[:, 0], want_i)
          and np.array_equal(got[:, 1], keys[want_i]),
          "dataset_broadcast_join: the matched pairs differ from numpy")
    check("broadcast-hash" in strategy and "device" in strategy,
          f"dataset_broadcast_join: strategy {strategy}")
    emit({**line, "matched": len(pairs), "build_rows": TPCH_SUPPLIERS,
          "strategy": strategy, "exact": True})


def lib_gelly_runs(dev, kind, smi, total_launches) -> None:
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from flink_tpu_torch.gelly.graph import state_from_numpy

    mark = Marks("23_libraries/gelly")
    V = 1 << G500_SCALE
    src, dst, w = g500_graph(G500_SCALE, LIB_SEED)
    E = len(src)
    g = state_from_numpy({"vertex_values": np.arange(V, dtype=np.float32),
                          "src": src, "dst": dst, "edge_values": w},
                         device=dev)
    s64, d64 = src.astype(np.int64), dst.astype(np.int64)
    out_deg = np.bincount(s64, minlength=V)
    mark("graph")

    pr, line = lib_run("gelly_page_rank",
                       lambda: g.page_rank(num_iterations=PR_ITERS),
                       total_launches, kind, smi, E * PR_ITERS, "edges",
                       ("scatter_ids",))
    rank = np.full(V, 1.0 / V)
    inv = 1.0 / np.maximum(out_deg, 1)
    for _ in range(PR_ITERS):
        agg = np.bincount(d64, weights=(rank * inv)[s64], minlength=V)
        dangling = rank[out_deg == 0].sum()
        rank = (1 - 0.85) / V + 0.85 * (agg + dangling / V)
    got = np.fromiter(pr.values(), np.float64, V)
    rel = float(np.max(np.abs(got - rank) / rank))
    check(rel <= PR_RTOL, f"gelly_page_rank: {rel} from float64")
    emit({**line, "vertices": V, "edges": E, "iterations": PR_ITERS,
          "max_rel_err_vs_float64": rel, "rtol": PR_RTOL})
    del pr
    mark("page_rank")

    adj = sp.csr_matrix((np.ones(E, np.int8), (s64, d64)), shape=(V, V))
    cc, line = lib_run("gelly_connected_components",
                       g.connected_components, total_launches, kind, smi,
                       E, "edges", ("scatter_ids",))
    n_comp, lab = csgraph.connected_components(adj, directed=False)
    low = np.full(n_comp, V, np.int64)
    np.minimum.at(low, lab, np.arange(V))
    check(np.array_equal(np.fromiter(cc.values(), np.int64, V), low[lab]),
          "gelly_connected_components: differs from scipy")
    emit({**line, "components": int(n_comp),
          "largest": int(np.bincount(lab).max()), "exact": True})
    del cc, adj
    mark("connected_components")

    source = int(np.argmax(out_deg))
    dist, line = lib_run(
        "gelly_sssp", lambda: g.single_source_shortest_paths(
            source, max_supersteps=SSSP_SUPERSTEPS),
        total_launches, kind, smi, E, "edges", ("scatter_ids",))
    order = np.argsort(s64 * V + d64, kind="stable")
    key = (s64 * V + d64)[order]
    first = np.r_[0, np.nonzero(np.diff(key))[0] + 1]
    wmin = np.minimum.reduceat(w[order].astype(np.float64), first)
    wg = sp.csr_matrix((wmin, (key[first] // V, key[first] % V)),
                       shape=(V, V))
    want = csgraph.dijkstra(wg, indices=source)
    got = np.fromiter(dist.values(), np.float64, V)
    reach = np.isfinite(want)
    check(np.array_equal(np.isfinite(got), reach)
          and np.allclose(got[reach], want[reach], rtol=1e-5, atol=0),
          "gelly_sssp: differs from scipy's dijkstra at rtol 1e-5")
    emit({**line, "source": source, "reached": int(reach.sum()),
          "max_dist": float(want[reach].max()), "rtol": 1e-5})
    del dist, wg
    mark("sssp")

    hv, line = lib_run("gelly_hits", lambda: g.hits(HITS_ITERS),
                       total_launches, kind, smi, 2 * E * HITS_ITERS,
                       "edges", ("scatter_ids",))
    hub = np.fromiter((h for h, _ in hv.values()), np.float64, V)
    auth = np.fromiter((a for _, a in hv.values()), np.float64, V)
    check(np.isfinite(hub).all() and abs(np.linalg.norm(hub) - 1) < 1e-4
          and abs(np.linalg.norm(auth) - 1) < 1e-4 and (hub >= 0).all(),
          "gelly_hits: hub or authority vector not unit and non-negative")
    emit({**line, "iterations": HITS_ITERS})
    del hv
    mark("hits")

    deg, line = lib_run("gelly_degrees", g.out_degrees, total_launches,
                        kind, smi, E, "edges", ("scatter_ids",))
    check(np.array_equal(np.fromiter(deg.values(), np.int64, V), out_deg),
          "gelly_degrees: differ from numpy")
    emit({**line, "max_degree": int(out_deg.max()), "exact": True})
    del deg, g
    mark("degrees")

    Vs = 1 << G500_DENSE_SCALE
    s2, d2, _w = g500_graph(G500_DENSE_SCALE, LIB_SEED + 3)
    small = state_from_numpy({"vertex_values": np.arange(Vs, dtype=np.float32),
                              "src": s2, "dst": d2}, device=dev)

    def dense():
        return small.triangle_count(), small.community_detection()

    (tri, comm), line = lib_run("gelly_dense_scale12", dense,
                                total_launches, kind, smi, len(s2), "edges",
                                ("scatter_ids", "row_argmax"))
    a = sp.csr_matrix((np.ones(len(s2)), (s2, d2)), shape=(Vs, Vs))
    a = ((a + a.T) > 0).astype(np.float64)
    a.setdiag(0)
    a.eliminate_zeros()
    want_tri = int(round((a @ a).multiply(a).sum() / 6))
    labels = np.fromiter(comm.values(), np.int64, Vs)
    check(tri == want_tri, f"gelly_dense: {tri} triangles, scipy "
                           f"{want_tri}")
    check(((labels >= 0) & (labels < Vs)).all(),
          "gelly_dense: community labels out of range")
    emit({**line, "vertices": Vs, "triangles": tri,
          "communities": int(len(np.unique(labels))), "exact": True})
    mark("dense_scale12")


def lib_ml_runs(dev, kind, smi, total_launches) -> None:
    from flink_tpu_torch import ml

    mark = Marks("23_libraries/ml")
    X, lab = blob_points(KM_N, KM_D, KM_K, LIB_SEED)
    km = ml.KMeans(k=KM_K, iterations=KM_ITERS, seed=LIB_SEED, device=dev)
    init = km.seed_centers(X).cpu().numpy().astype(np.float64)
    (fitted, a), line = lib_run(
        "ml_kmeans", lambda: (lambda m: (m, m.predict(X).cpu().numpy()))(
            km.fit(X)),
        total_launches, kind, smi, KM_N * KM_ITERS, "points",
        ("scatter_ids", "row_argmin"))
    X64 = X.astype(np.float64)
    C = init
    for it in range(KM_ITERS + 1):
        # argmin over centers of |c|^2 - 2 x.c (|x|^2 is the row's own)
        d = (C * C).sum(1) - 2 * (X64 @ C.T)
        want = np.argmin(d, 1)
        if it == KM_ITERS:
            break
        cnt = np.bincount(want, minlength=KM_K)
        sums = np.stack([np.bincount(want, weights=X64[:, c],
                                     minlength=KM_K) for c in range(KM_D)],
                        1)
        C = np.where(cnt[:, None] > 0, sums / np.maximum(cnt, 1)[:, None],
                     C)
    two = np.partition(d, 1, axis=1)[:, :2]
    margin = float((two[:, 1] - two[:, 0]).min())
    check(np.array_equal(a, want),
          f"ml_kmeans: {int((a != want).sum())} assignments differ from "
          f"numpy's float64 Lloyd")
    emit({**line, "n": KM_N, "d": KM_D, "k": KM_K,
          "iterations": KM_ITERS, "min_margin": margin, "exact": True})
    del fitted, a, d
    mark("kmeans")

    knn = ml.KNN(k=KNN_K, device=dev).fit(X, lab.astype(np.float32))
    Q, qlab = blob_points(KNN_Q, KM_D, KM_K, LIB_SEED)   # the same blobs
    pred, line = lib_run("ml_knn", lambda: knn.predict(Q).cpu().numpy(),
                         total_launches, kind, smi, KNN_Q, "queries", ())
    for q in range(0, KNN_Q, KNN_Q // KNN_SAMPLE):
        dq = ((X64 - Q[q].astype(np.float64)) ** 2).sum(1)
        nn = np.argpartition(dq, KNN_K)[:KNN_K]
        check(pred[q] == np.float32(lab[nn].mean()),
              f"ml_knn: query {q} predicts {pred[q]}, numpy "
              f"{lab[nn].mean()}")
    emit({**line, "q": KNN_Q, "n": KM_N, "k": KNN_K,
          "checked_queries": KNN_SAMPLE})
    del knn, pred
    mark("knn")

    rng = np.random.default_rng(LIB_SEED + 4)
    Xl = rng.normal(size=(MLR_N, MLR_D)).astype(np.float32)
    wt = rng.normal(size=MLR_D)
    y = (Xl @ wt + 3.0).astype(np.float32)
    m, line = lib_run("ml_linear_regression",
                      lambda: ml.MultipleLinearRegression(device=dev)
                      .fit(Xl, y), total_launches, kind, smi, MLR_N, "rows",
                      ())
    wf = m.weights.cpu().numpy()
    err = float(max(np.abs(wf[:-1] - wt).max(), abs(wf[-1] - 3.0)))
    check(err < 0.05, f"ml_linear_regression: coefficients off by {err}")
    emit({**line, "n": MLR_N, "d": MLR_D, "max_coef_err": err})
    del Xl, y, m
    mark("linear_regression")

    rng = np.random.default_rng(LIB_SEED + 5)
    cells = rng.choice(ML1M_USERS * ML1M_ITEMS, ML1M_RATINGS, replace=False)
    u, i = cells // ML1M_ITEMS, cells % ML1M_ITEMS
    truth = (rng.normal(size=(ML1M_USERS, 3)) @
             rng.normal(size=(ML1M_ITEMS, 3)).T)
    r = np.clip(np.round(3.5 + truth[u, i] + rng.normal(0, 0.3, len(u))),
                1, 5)
    rows = list(zip(u.tolist(), i.tolist(), r.tolist()))
    als = ml.ALS(num_factors=ALS_F, iterations=ALS_ITERS, seed=LIB_SEED,
                 device=dev)
    uf0, vf0 = als.initial_factors(ML1M_USERS, ML1M_ITEMS)

    def risk(uf, vf):
        uf, vf = uf.cpu().double().numpy(), vf.cpu().double().numpy()
        e = (uf[u] * vf[i]).sum(1) - r
        return float((e * e).sum() + 0.1 * ((uf * uf).sum() +
                                              (vf * vf).sum()))

    fitted, line = lib_run("ml_als", lambda: als.fit(rows), total_launches,
                           kind, smi, ML1M_RATINGS * ALS_ITERS, "ratings",
                           ())
    before = risk(uf0, vf0)
    after = risk(fitted.user_factors, fitted.item_factors)
    check(after < before, f"ml_als: risk {after} did not fall from "
                          f"{before}")
    emit({**line, "users": ML1M_USERS, "items": ML1M_ITEMS,
          "ratings": ML1M_RATINGS, "factors": ALS_F,
          "iterations": ALS_ITERS, "risk_before": before,
          "risk_after": after})
    mark("als")


def library_runs(dev, kind, smi, total_launches) -> None:
    """Phase 23: the batch libraries at their sizes, each workload through
    the port's public API (module docstring); the last line splits the
    phase's wall between the workloads and the data and checks around
    them."""
    LIB_WALL.clear()
    t0 = time.perf_counter()
    li = part("23_libraries/lineitem", tpch_lineitem)
    part("23_libraries/table", lambda: lib_table_runs(
        dev, kind, smi, total_launches, li))
    part("23_libraries/dataset", lambda: lib_dataset_runs(
        dev, kind, smi, total_launches, li))
    del li
    part("23_libraries/gelly", lambda: lib_gelly_runs(
        dev, kind, smi, total_launches))
    part("23_libraries/ml", lambda: lib_ml_runs(dev, kind, smi,
                                               total_launches))
    emit({"phase": "libraries", "seconds": time.perf_counter() - t0,
          "workload_seconds": sum(LIB_WALL),
          "data_and_check_seconds": time.perf_counter() - t0
          - sum(LIB_WALL)})


# -------------------------------------------- phase 3: G23-G25

def nan_bits_err(a, b) -> float:
    """Elements that differ: NaN against a number, or two numbers whose
    bits differ (signed zeros count; any two NaN agree: an add of NaN on
    the card gives its canonical NaN whatever the payload)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    same = (a.view(torch.int32) == b.view(torch.int32)) | (na & nb)
    return float((~same).sum())


def case_scatter_ids(dev, kind, li=None):
    """G23 against its plain version, exactly (integer-valued data whose
    sums stay under 2^24; min and max exact in any order): ``main`` TPC-H
    Q1's shape, SUM(l_discount x 100) over 6,001,215 rows into its 4
    groups (int64 ids; the blocks' shared copies); ``avg`` the same with
    the count column (AVG); ``minmax`` MIN and MAX of l_extendedprice at
    Q1's shape; ``q18`` SUM(l_quantity) into Q18's 1,500,000 orders (the
    global path); ``kmeans`` W = 16 with counts, 2^20 points into 64
    centers; ``community`` 2^25 lanes into V^2 = 2^24 cells; ``edge`` NaN,
    +-0, negative and out-of-range lanes (int32 ids), min, max and add,
    the touched-row flag, 7 and 2^20 rows."""
    g = torch.Generator().manual_seed(23)
    if kind in ("main", "avg", "minmax", "q18"):
        idx = torch.from_numpy(
            li["order_index"] if kind == "q18"
            else np.unique(q1_groups(li), return_inverse=True)[1]).to(dev)
        G = TPCH_ORDERS if kind == "q18" else 4
        col = {"main": li["l_discount"] * 100, "avg": li["l_tax"] * 100,
               "minmax": li["l_extendedprice"],
               "q18": li["l_quantity"]}[kind]
        vals = torch.from_numpy(np.round(col, 2).astype(np.float32)).to(dev)
        runs = [dict(op="add", counts=kind == "avg")] if kind != "minmax" \
            else [dict(op="min"), dict(op="max")]
    elif kind == "kmeans":
        idx = torch.randint(0, KM_K, (KM_N,), generator=g).to(dev)
        vals = torch.randint(-50, 51, (KM_N, KM_D), generator=g).float().to(
            dev)
        G = KM_K
        runs = [dict(op="add", counts=True)]
    elif kind == "community":
        V = 1 << G500_DENSE_SCALE
        n = 1 << 25
        idx = (torch.randint(0, V, (n,), generator=g) * V
               + torch.randint(0, V, (n,), generator=g)).to(dev)
        vals = torch.randint(0, 4, (n,), generator=g).float().to(dev)
        G = V * V
        runs = [dict(op="add")]
    else:
        n = 1 << 20
        vals = torch.randint(-9, 10, (n,), generator=g).float()
        vals[::97] = float("nan")
        vals[1::31] = -0.0
        vals[2::29] = 0.0
        vals = vals.to(dev)
        runs = []
        for G in (7, 1 << 20):
            idx = torch.randint(-3, G + 5, (n,), generator=g).to(
                torch.int32).to(dev)
            runs += [dict(op=op, counts=True, has=True, _idx=idx, _G=G)
                     for op in ("add", "min", "max")]
    err = 0.0
    for r in runs:
        i = r.pop("_idx", idx)
        n_g = r.pop("_G", G)
        a = kernels.scatter_ids(i, vals, n_g, **r)
        b = kernels.scatter_ids_plain(i, vals, n_g, **r)
        for x, y in zip(a, b):
            if x is not None:
                err = max(err, nan_bits_err(x, y)
                          if x.is_floating_point() else max_abs_err(x, y))
    r = runs[0]
    W = 1 if vals.dim() == 1 else vals.shape[1]
    lib = None
    if r["op"] == "add":
        lib = (lambda: torch.zeros((G,) + tuple(vals.shape[1:]),
                                   device=dev).index_add_(0, idx, vals))
    elif kind == "minmax":
        lib = (lambda: torch.full((G,), float("inf"), device=dev)
               .scatter_reduce_(0, idx, vals, "amin", include_self=True))
    return {
        "err": err,
        "run": lambda: kernels.scatter_ids(idx, vals, G, **r),
        "plain": lambda: kernels.scatter_ids_plain(idx, vals, G, **r),
        "library": lib,
        "bytes": idx.numel() * (idx.element_size() + 4 * W)
        + G * 4 * (W + int(r.get("counts", False))),
    }


def case_sorted_probe(dev, kind):
    """G24 against its plain version, exactly: ``main`` the DataSet join's
    1,000,000 probes (SF1's 10,000 supplier keys, a fifth of the probes
    missing) into the sorted keys; ``edge`` hits and misses at the first
    and the last key, below and above every key, negative and 2^62 keys,
    one build key, and no build key at all."""
    g = torch.Generator().manual_seed(24)
    cases = []
    if kind == "main":
        tk = torch.arange(1, TPCH_SUPPLIERS + 1, dtype=torch.int64)
        keys = torch.randint(1, TPCH_SUPPLIERS + 1, (JOIN_PROBES,),
                             generator=g)
        keys[torch.rand(JOIN_PROBES, generator=g) < 0.2] += TPCH_SUPPLIERS
        cases.append((keys, tk))
    else:
        tk = torch.sort(torch.randint(-(1 << 62), 1 << 62, (5000,),
                                      generator=g)).values.unique()
        keys = torch.cat([tk[:3], tk[-3:], tk[:1] - 1, tk[-1:] + 1,
                          torch.randint(-(1 << 62), 1 << 62, (4096,),
                                        generator=g), tk[::7]])
        cases += [(keys, tk), (keys, tk[:1]), (keys, tk[:0])]
    err = 0.0
    for keys, tk in cases:
        keys, tk = keys.to(dev), tk.to(dev)
        tv = torch.arange(tk.numel(), dtype=torch.float32, device=dev)
        a = kernels.sorted_probe(keys, tk, tv)
        b = kernels.sorted_probe_plain(keys, tk, tv)
        err = max(err, max(max_abs_err(x, y) for x, y in zip(a, b)))
    keys, tk = cases[0][0].to(dev), cases[0][1].to(dev)
    tv = torch.arange(tk.numel(), dtype=torch.float32, device=dev)
    return {
        "err": err,
        "run": lambda: kernels.sorted_probe(keys, tk, tv),
        "plain": lambda: kernels.sorted_probe_plain(keys, tk, tv),
        "library": lambda: torch.searchsorted(tk, keys),
        "bytes": keys.numel() * (8 + 4 + 1 + 4) + tk.numel() * 12,
    }


def case_row_argmin(dev, kind):
    """G25's arg-min mode against its plain version, exactly: ``main``
    KMeans' assignment at [2^20, 64] (P = X C^T of the blob points and 64
    of them as centers, torch.matmul); ``edge`` integer-valued rows full
    of ties, rows holding NaN (first NaN wins), all-equal rows, K = 1 and
    K = 100."""
    g = torch.Generator().manual_seed(25)
    cases = []
    if kind == "main":
        X, _ = blob_points(KM_N, KM_D, KM_K, LIB_SEED)
        X = torch.from_numpy(X).to(dev)
        C = X[torch.randint(0, KM_N, (KM_K,), generator=g).to(dev)]
        cases.append((X @ C.T, torch.sum(X * X, 1), torch.sum(C * C, 1)))
    else:
        for K in (64, 1, 100):
            P = torch.randint(-3, 4, (4096, K), generator=g).float()
            P[::5, K // 2] = float("nan")
            P[1::7, :] = float("nan")
            P[2::11, :] = 1.0
            xx = torch.randint(0, 9, (4096,), generator=g).float()
            cc = torch.randint(0, 3, (K,), generator=g).float()
            cases.append((P.to(dev), xx.to(dev), cc.to(dev)))
    err = 0.0
    for P, xx, cc in cases:
        err = max(err, max_abs_err(kernels.row_argmin(P, xx, cc),
                                   kernels.row_argmin_plain(P, xx, cc)))
    P, xx, cc = cases[0]
    N, K = P.shape
    d = (xx[:, None] - 2.0 * P) + cc
    return {
        "err": err,
        "run": lambda: kernels.row_argmin(P, xx, cc),
        "plain": lambda: kernels.row_argmin_plain(P, xx, cc),
        "library": lambda: torch.argmin(d, 1),
        "bytes": N * K * 4 + N * 4 + K * 4 + N * 8,
    }


def case_row_argmax(dev, kind):
    """G25's arg-max mode against its plain version, exactly: ``main``
    community detection's first superstep at V = 4,096 (the score mass of
    the scale-12 graph, integer counts full of ties); ``edge`` rows with
    NaN, rows of zeros (no adoption), negative rows and ties."""
    g = torch.Generator().manual_seed(26)
    V = 1 << G500_DENSE_SCALE
    if kind == "main":
        s, d, _w = g500_graph(G500_DENSE_SCALE, LIB_SEED + 3)
        m = kernels.scatter_ids_plain(
            torch.from_numpy(d.astype(np.int64) * V + s),
            torch.ones(len(s)), V * V)[0].view(V, V)
    else:
        m = torch.randint(-2, 3, (V, V), generator=g).float()
        m[::9, 5] = float("nan")
        m[1::13, :] = 0.0
        m[2::17, :] = -1.0
    m = m.to(dev)
    labels = torch.arange(V, dtype=torch.float32, device=dev)
    scores = torch.rand(V, generator=g).to(dev) + 0.5
    a = kernels.row_argmax(m, labels, scores, 0.5)
    b = kernels.row_argmax_plain(m, labels, scores, 0.5)
    return {
        "err": max(nan_bits_err(x, y) for x, y in zip(a, b)),
        "run": lambda: kernels.row_argmax(m, labels, scores, 0.5),
        "plain": lambda: kernels.row_argmax_plain(m, labels, scores, 0.5),
        "library": lambda: torch.max(m, 1),
        "bytes": V * V * 4 + 4 * V * 4,
    }


def argmax_edge_checks(dev) -> dict:
    """G25's arg-max mode on the shapes its split rows make risky, its
    labels and scores bit for bit (NaN bits too) against its plain
    version: K in 1, 3, 31, 33, 4,095, 4,096 and 4,097 at N = 1 and N = 65
    (a warp a row below 1,024 columns, a block above; float4 loads where
    K % 4 == 0, scalar loads otherwise), a row through an offset view (4-
    byte aligned: the scalar loads), and at K = 4,096 and 4,097: a NaN
    first, last and inside one float4, two NaN, ties between columns that
    different warps and load slots read (the first wins), all-zero rows
    and negative rows. Returns a record nested under row_argmax."""
    g = torch.Generator().manual_seed(251)

    def rows(n, K):
        return torch.randint(-3, 4, (n, K), generator=g).float()

    cases = []   # (label, m)
    for K in (1, 3, 31, 33, 4095, 4096, 4097):
        cases += [(f"K={K} N=1", rows(1, K)), (f"K={K} N=65", rows(65, K))]
    for K in (4096, 4097):
        m = rows(16, K)
        m[0, 0] = m[1, K - 1] = m[2, 4 * 100 + 2] = float("nan")
        m[3, 7] = m[3, 3000] = float("nan")
        m[4, :] = 0.0
        m[5, :] = -torch.rand(K, generator=g) - 0.5
        m[6, :] = 1.0
        m[6, [900, 1030, 4000]] = 9.0   # warp 7 slot 0, warp 0 slot 1
        m[7, :] = 2.0
        m[7, [4095, 2049, 1023]] = 5.0
        cases.append((f"K={K} NaN, ties, zero and negative rows", m))
    buf = rows(1, 65 * 4096 + 1).view(-1)
    cases.append(("offset view", buf.to(dev)[1:].view(65, 4096)))
    err = 0.0
    for label, m in cases:
        m = m.to(dev)
        N = m.shape[0]
        labels = torch.arange(N, dtype=torch.float32, device=dev) + 0.5
        scores = torch.rand(N, generator=g).to(dev) + 0.5
        a = kernels.row_argmax(m, labels, scores, 0.5)
        b = kernels.row_argmax_plain(m, labels, scores, 0.5)
        e = max(float((x.view(torch.int32) != y.view(torch.int32)).sum())
                for x, y in zip(a, b))
        check(e == 0.0, f"row_argmax ({label}) disagrees with its plain "
                        f"version: {e} elements differ")
        err = max(err, e)
    return {"cases": len(cases), "max_abs_err": err,
            "shapes": [label for label, _ in cases]}


def scatter_block_path(idx, vals, G) -> bool:
    """Whether G23 takes a block path (registers or shared memory) for
    these inputs, not the global one: the scratch its blocks' partial
    copies need."""
    W = 1 if vals is None or vals.dim() == 1 else vals.shape[1]
    return kernels.build().scatter_ids_scratch(
        idx.numel(), kernels._ptr(vals), W, G) > 0


def scatter_edge_checks(dev) -> dict:
    """G23's block paths on the shapes their tiling makes risky, each
    against its plain version exactly (integer-valued data; NaN against
    NaN): W = 3 through an offset view of its buffer (4-byte aligned only:
    the scalar loads) with N not a multiple of a chunk, NaN and +-0 lanes
    and lanes out of range, add, min and max with counts and the touched
    flag; G (W + 1) at the shared limit (a block path) and past it (the
    global path), with W = 3 and with counts alone; the register path at
    its limit (W = 2 into 4 groups, counts alone into 8) and past it (9
    groups: the shared path); and KMeans' shape on random floats twice
    (within rtol 1e-5 of the plain version; how many bits differ between
    the two calls is reported: lanes of one warp instruction on one cell
    meet in shared-memory atomics of unspecified order). Returns a record
    nested under scatter_ids."""
    g = torch.Generator().manual_seed(123)
    N = (1 << 20) + 13
    lim = kernels.SCATTER_SHARED_CELLS

    def offset_vals(n, W):
        buf = torch.randint(-9, 10, (n * W + 1,), generator=g).float()
        buf[::97] = float("nan")
        buf[1::31] = -0.0
        v = buf.to(dev)[1:].view(n, W)
        check(v.is_contiguous() and v.data_ptr() % 16 != 0,
              "scatter_ids: the offset view is 16-byte aligned")
        return v

    cases = []   # (label, idx, vals, G, op, shared expected)
    v3 = offset_vals(N, 3)
    idx = torch.randint(-3, 105, (N,), generator=g).to(dev)
    cases += [(f"W3 offset view {op}", idx, v3, 100, op, True)
              for op in ("add", "min", "max")]
    for G, shared in ((lim // 4, True), (lim // 4 + 1, False)):
        i = torch.randint(-2, G + 3, (N,), generator=g).to(dev)
        cases += [(f"W3 G={G} {op}", i, v3, G, op, shared)
                  for op in ("add", "max")]
    for G, shared in ((lim - 1, True), (lim, True), (lim + 1, False),
                      (8, True), (9, True)):
        i = torch.randint(-2, G + 3, (N,), generator=g).to(
            torch.int32).to(dev)
        cases.append((f"counts G={G}", i, None, G, "add", shared))
    v2 = offset_vals(N, 2)
    i = torch.randint(-1, 6, (N,), generator=g).to(dev)
    cases += [(f"W2 G=4 registers {op}", i, v2, 4, op, True)
              for op in ("add", "min", "max")]
    err, paths = 0.0, {}
    for label, i, v, G, op, shared in cases:
        if dev.type == "cuda":   # the plain version has no paths
            got = scatter_block_path(i, v, G)
            check(got == shared, f"scatter_ids ({label}): the "
                                 f"{'shared' if got else 'global'} path")
            paths[label] = "shared" if got else "global"
        a = kernels.scatter_ids(i, v, G, op=op, counts=True, has=True)
        b = kernels.scatter_ids_plain(i, v, G, op=op, counts=True, has=True)
        for x, y in zip(a, b):
            if x is not None:
                e = (nan_bits_err(x, y) if x.is_floating_point()
                     else max_abs_err(x, y))
                check(e == 0.0, f"scatter_ids ({label}) disagrees with its "
                                f"plain version: {e} elements differ")
                err = max(err, e)
    # KMeans' shape on random floats: the same bits twice
    i = torch.randint(0, KM_K, (KM_N,), generator=g).to(dev)
    x = torch.rand(KM_N, KM_D, generator=g).to(dev)
    check(dev.type != "cuda" or scatter_block_path(i, x, KM_K),
          "scatter_ids: KMeans' shape took the global path")
    r1 = kernels.scatter_ids(i, x, KM_K, counts=True)
    r2 = kernels.scatter_ids(i, x, KM_K, counts=True)
    rp = kernels.scatter_ids_plain(i, x, KM_K, counts=True)
    twice = bits_err([r1[0], r1[1]], [r2[0], r2[1]])
    rel = float(((r1[0].double() - rp[0].double()).abs()
                 / rp[0].double().abs().clamp_min(1.0)).max())
    check(rel <= 1e-5 and max_abs_err(r1[1], rp[1]) == 0,
          f"scatter_ids: KMeans' float sums differ from the plain version "
          f"(rel {rel})")
    return {"cases": len(cases) + 1, "max_abs_err": err, "paths": paths,
            "kmeans_float_twice_err": twice, "kmeans_float_rel_err": rel}


def library_kernel_phase(dev, timing=True) -> dict:
    """Hold G23-G25 against their plain versions on every input kind (the
    case functions say which) and time the main ones, with the other
    timed shapes of G23 nested under ``modes``. Returns {wrapper:
    record}."""
    li = tpch_lineitem()
    out = {}
    rec = hold("scatter_ids", lambda k: case_scatter_ids(dev, k, li),
               timing, ("main", "avg", "minmax", "q18", "kmeans",
                        "community", "edge"))
    rec["modes"] = {}
    for mode in ("avg", "minmax", "q18", "kmeans", "community"):
        c = case_scatter_ids(dev, mode, li)
        m = {"bound_ms": bound_ms(c["bytes"])}
        if timing:
            m["ms"] = time_ms(c["run"])
            m["library_ms"] = (time_ms(c["library"])
                               if c["library"] is not None else None)
        rec["modes"][mode] = m
        del c
    rec["edges"] = scatter_edge_checks(dev)
    out["scatter_ids"] = rec
    del li
    for name, case in (("sorted_probe", case_sorted_probe),
                       ("row_argmin", case_row_argmin),
                       ("row_argmax", case_row_argmax)):
        out[name] = hold(name, lambda k, f=case: f(dev, k), timing)
    out["row_argmax"]["edges"] = argmax_edge_checks(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 24

SHARDS = 4                    # parallelism of the sharded runs
SHARD_TOTAL = 10_000_000      # the events of every other sharded run
SHARD_MODES = (
    ("all_to_all", {"exchange.mode": "all_to_all"}),
    ("mask", {"exchange.mode": "mask"}),
    ("sharded_drain", RESIDENT_ON),                   # data-parallel auto
    ("sharded_while", {"pipeline.resident-loop": "while"}),
    ("exchange_drain", {**RESIDENT_ON, "pipeline.data-parallel": "off"}),
    ("megastep_k4", {"pipeline.resident-loop": "off",
                     "pipeline.steps-per-dispatch": 4}),
    ("megastep_k4_fire_off", {"pipeline.resident-loop": "off",
                              "pipeline.steps-per-dispatch": 4,
                              "pipeline.fused-fire": "off"}),
)
# the route each mode must have taken: "exchange", "sharded" or "mask"
SHARD_ROUTES = {"auto": "exchange", "all_to_all": "exchange",
                "mask": "mask", "sharded_drain": "sharded",
                "sharded_while": "sharded", "exchange_drain": "exchange",
                "megastep_k4": "exchange", "megastep_k4_fire_off": "exchange"}
SHARD_KERNELS = ("route_lanes", "clear_rows", "scatter_update",
                 "fire_reduced", "exchange_pack")
SHARD_ROLLING_KERNELS = ("route_lanes", "hash_upsert", "segment_sort",
                         "rolling_update", "shard_sum")


def _i32(a: np.ndarray, dev) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a).to(dev)


def case_exchange_pack(dev, kind):
    """G26 against its plain version, exactly: ``main`` one source shard's
    slice of the north star's batch (B / n = 65,536 lanes of its traffic,
    n = 4, cap = 32,768, the exchange's default capacity); ``edge`` one key
    in every lane (every lane past the first 32,768 of one bucket
    overflows), no valid lane, two value words a lane, a ragged batch (its
    last lanes the padding of a batch not divisible by n), and n = 8."""
    from flink_tpu_torch.parallel.exchange import bucket_capacity

    bpd = BATCH // SHARDS
    keys, ts, vals = gen_batch(0, bpd)
    cases = []
    if kind == "main":
        cases.append((keys, ts, vals, np.ones(bpd, bool), SHARDS))
    else:
        cases.append((np.full(bpd, 7), ts, vals, np.ones(bpd, bool), SHARDS))
        cases.append((keys, ts, vals, np.zeros(bpd, bool), SHARDS))
        w2 = np.stack([vals, np.arange(bpd, dtype=np.float32)], 1)
        cases.append((keys, ts, w2, np.ones(bpd, bool), SHARDS))
        ragged = np.ones(bpd, bool)
        ragged[-(bpd // 3):] = False
        cases.append((keys, ts, vals, ragged, SHARDS))
        cases.append((keys, ts, vals, np.ones(bpd, bool), 8))
    err = 0.0
    for k, t, v, ok, n in cases:
        cap = bucket_capacity(bpd, n, 2.0)
        args = (_i32(np.zeros(bpd, np.uint32), dev),
                _i32(k.astype(np.uint32), dev), _i32(t.astype(np.int32), dev),
                torch.from_numpy(v).to(dev), torch.from_numpy(ok).to(dev))
        a = kernels.exchange_pack(*args, n=n, maxp=MAX_PARALLELISM, cap=cap)
        b = kernels.exchange_pack_plain(*args, n=n, maxp=MAX_PARALLELISM,
                                        cap=cap)
        err = max(err, max_abs_err(list(a), list(b)))
    k, t, v, ok, n = cases[0]
    cap = bucket_capacity(bpd, n, 2.0)
    args = (_i32(np.zeros(bpd, np.uint32), dev),
            _i32(k.astype(np.uint32), dev), _i32(t.astype(np.int32), dev),
            torch.from_numpy(v).to(dev), torch.from_numpy(ok).to(dev))
    W = int(np.prod(v.shape[1:], dtype=np.int64))
    return {
        "err": err,
        "run": lambda: kernels.exchange_pack(*args, n=n,
                                             maxp=MAX_PARALLELISM, cap=cap),
        "plain": lambda: kernels.exchange_pack_plain(
            *args, n=n, maxp=MAX_PARALLELISM, cap=cap),
        "library": None,
        "bytes": bpd * (13 + 4 * W) + n * cap * (13 + 4 * W),
    }


def case_shard_sum(dev, kind):
    """G27 against its plain version, exactly: ``main`` the rolling job's
    B = 262,144 outputs of 4 shards, each lane owned by one shard or none;
    ``edge`` two value words a lane, no valid lane, 8 shards, and lanes
    valid on several shards at once (a general sum in shard order)."""
    g = torch.Generator().manual_seed(27)
    B = BATCH

    def make(n, W, share=1.0, overlap=False):
        shape = (B, W) if W > 1 else (B,)
        outs = [torch.rand(shape, generator=g).to(dev) for _ in range(n)]
        if overlap:
            valids = [(torch.rand(B, generator=g) < 0.5).to(dev)
                      for _ in range(n)]
        else:
            owner = torch.randint(0, n, (B,), generator=g)
            owner[torch.rand(B, generator=g) >= share] = n
            valids = [(owner == s).to(dev) for s in range(n)]
        return outs, valids

    cases = ([make(SHARDS, 1, 0.9)] if kind == "main" else
             [make(SHARDS, 2, 0.9), make(SHARDS, 1, 0.0), make(8, 1, 0.9),
              make(SHARDS, 1, overlap=True)])
    err = 0.0
    for outs, valids in cases:
        err = max(err, max_abs_err(list(kernels.shard_sum(outs, valids)),
                                   list(kernels.shard_sum_plain(outs,
                                                                valids))))
    outs, valids = cases[0]
    masked = [torch.where(v.reshape(v.shape + (1,) * (o.dim() - 1)), o,
                          torch.zeros((), device=dev))
              for o, v in zip(outs, valids)]
    n = len(outs)
    return {
        "err": err,
        "run": lambda: kernels.shard_sum(outs, valids),
        "plain": lambda: kernels.shard_sum_plain(outs, valids),
        "library": lambda: torch.stack(masked).sum(0),
        "bytes": n * B * 5 + B * 5,
    }


def shard_kernel_phase(dev, timing=True) -> dict:
    """Hold G26 and G27 against their plain versions on every input kind
    and time the main ones. Returns {wrapper: record}."""
    return {"exchange_pack": hold("exchange_pack",
                                  lambda k: case_exchange_pack(dev, k),
                                  timing),
            "shard_sum": hold("shard_sum", lambda k: case_shard_sum(dev, k),
                              timing)}


def _routed(m, route: str) -> bool:
    return {"exchange": m.steps_exchanged > 0,
            "sharded": m.steps_sharded > 0,
            "mask": m.steps_exchanged == 0 and m.steps_sharded == 0}[route]


def sharded_runs(dev, kind, smi, total_launches, want_count) -> None:
    """Phase 24: the mesh at parallelism SHARDS, its SHARDS shards forced
    onto the one card (``force_device_count``). The north star at full
    size in the default mode (the adaptive exchange on the split path),
    every other mode of the slice at SHARD_TOTAL events (rows by count and
    sum against numpy, nothing dropped, the route each mode must take),
    the sparse job in the hash layout, the rolling WordCount (every output
    against numpy) and the checkpoint job crashed at a sharded drain and
    restarted (every row against numpy)."""
    from flink_tpu_torch.parallel.mesh import forced_device_count, \
        mesh_devices

    t_phase = time.perf_counter()
    with forced_device_count(SHARDS):
        devs = mesh_devices(dev)
        emit({"phase": "sharded_mesh", "shards": SHARDS,
              "devices": [str(d) for d in devs],
              "note": f"{SHARDS} shards share the one card: their "
                      f"collectives are copies within it, and the times "
                      f"say nothing of several cards",
              "device": kind, "nvidia_smi": smi})
        want_small = numpy_reference(SHARD_TOTAL, N_KEYS, EVENTS_PER_MS,
                                     WINDOW_MS)
        for name, cfg, total, want in (
                (("auto", {}, TOTAL_EVENTS, want_count),)
                + tuple((n, c, SHARD_TOTAL, want_small)
                        for n, c in SHARD_MODES)):
            launches, (sink, job, secs) = run_path(
                lambda c=cfg, t=total: north_star_job(
                    dev, N_KEYS, EVENTS_PER_MS, t, BATCH, RING_DEPTH,
                    config=c, parallelism=SHARDS), total_launches)
            m = job.metrics
            emit({"phase": "sharded", "mode": name, "config": cfg,
                  "events": total, "seconds": secs,
                  "events_per_s": total / secs, "batches": m.steps,
                  "exchange_mode": m.exchange_mode,
                  "steps_exchanged": m.steps_exchanged,
                  "steps_sharded": m.steps_sharded,
                  "drains": m.resident_drains,
                  "fused_dispatches": m.fused_dispatches,
                  "fire_steps": m.fire_steps,
                  "dropped_capacity": m.dropped_capacity,
                  "count": sink.count, "count_ref": want,
                  "fire_latency_ms": fire_latency(m), "launches": launches,
                  "device": kind, "nvidia_smi": smi})
            check(sink.value_sum == float(total) and sink.count == want,
                  f"sharded {name}: {sink.count} rows summing to "
                  f"{sink.value_sum}, numpy {want} and {total}")
            check(m.dropped_late == 0 and m.dropped_capacity == 0,
                  f"sharded {name}: records dropped")
            check(_routed(m, SHARD_ROUTES[name]),
                  f"sharded {name}: the {SHARD_ROUTES[name]} route never "
                  f"ran ({m.steps_exchanged} exchanged, {m.steps_sharded} "
                  f"sharded)")
            check_launched(launches, SHARD_KERNELS if
                           SHARD_ROUTES[name] == "exchange" else
                           SHARD_KERNELS[:-1], f"sharded {name}")
            del sink, job
            if name == "auto":
                # the card's idle share of the default mode, from a
                # second, profiled run
                (_s, _j, wall_p), busy = device_busy(
                    lambda: north_star_job(dev, N_KEYS, EVENTS_PER_MS,
                                           total, BATCH, RING_DEPTH,
                                           parallelism=SHARDS))
                emit({"phase": "sharded_idle", "mode": name,
                      "device_busy_ms": busy, "profiled_wall_s": wall_p,
                      "device_idle_share": 1.0 - busy / (wall_p * 1e3),
                      "device": kind, "nvidia_smi": smi})

        launches, (sink, job, secs) = run_path(
            lambda: sparse_job(dev, SHARD_TOTAL, BATCH, RING_DEPTH,
                               parallelism=SHARDS), total_launches)
        cols = sink.columns()
        m = job.metrics
        emit({"phase": "sharded_sparse", "events": SHARD_TOTAL,
              "seconds": secs, "events_per_s": SHARD_TOTAL / secs,
              "rows": len(cols.get("value", ())),
              "layout": job.state[0].layout,
              "steps_exchanged": m.steps_exchanged,
              "spilled_records": m.spilled_records,
              "steps_fast": m.steps_fast, "launches": launches,
              "device": kind, "nvidia_smi": smi})
        check(job.state[0].layout == "hash",
              f"sharded sparse: layout {job.state[0].layout}")
        check(m.dropped_late == 0 and m.dropped_capacity == 0,
              "sharded sparse: records dropped")
        check_sparse_rows(cols, SHARD_TOTAL)
        check_launched(launches, ("route_lanes", "clear_rows",
                                  "scatter_update", "hash_upsert",
                                  "fire_compact", "ring_append",
                                  "exchange_pack"), "sharded sparse")
        del sink, cols, job

        ranks = all_word_ranks(SHARD_TOTAL)
        launches, (sink, job, secs) = run_path(
            lambda: wordcount_job(dev, SHARD_TOTAL, parallelism=SHARDS),
            total_launches)
        m = job.metrics
        hot = check_wordcount_rows(sink.columns(), ranks)
        emit({"phase": "sharded_rolling", "events": SHARD_TOTAL,
              "seconds": secs, "events_per_s": SHARD_TOTAL / secs,
              "hot_word_count": hot, "steps": m.steps,
              "dropped_capacity": m.dropped_capacity, "launches": launches,
              "device": kind, "nvidia_smi": smi})
        check(m.dropped_capacity == 0,
              f"sharded rolling: {m.dropped_capacity} records dropped")
        check_launched(launches, SHARD_ROLLING_KERNELS, "sharded rolling")
        del sink, job, ranks

        want_ck = ckpt_reference(TOTAL_EVENTS)
        with tempfile.TemporaryDirectory(prefix="chip-smoke-shard-") as tmp:
            launches, (sink, job, secs) = run_path(
                lambda: ckpt_job(dev, TOTAL_EVENTS,
                                 ckpt_dir=os.path.join(tmp, "c"),
                                 fault="step.drain", parallelism=SHARDS),
                total_launches)
        m = job.metrics
        cols = sink.columns()
        repeats = check_window_rows(cols, want_ck, len(want_ck) // N_KEYS,
                                    WINDOW_MS, "sharded crash")
        emit({"phase": "sharded_crash", "events": TOTAL_EVENTS,
              "seconds": secs, "rows": len(cols["value"]),
              "repeated_windows": repeats, "restarts": m.restarts,
              "steps_sharded": m.steps_sharded, **ckpt_stats(m),
              "fault_to_first_drain_s": [r / 1e3
                                         for r in (m.recovery_ms or [])],
              "launches": launches, "device": kind, "nvidia_smi": smi})
        check(m.restarts == 1 and m.steps_sharded > 0,
              f"sharded crash: {m.restarts} restarts, {m.steps_sharded} "
              f"sharded batches")
        check(m.dropped_late == 0 and m.dropped_capacity == 0,
              "sharded crash: records dropped")
        del sink, job, cols
    emit({"phase": "sharded_done",
          "seconds": time.perf_counter() - t_phase})



# ------------------------------------- phase 25 (and its phase 3 checks)

SHARD_KEYED_CEP_B = (CEP_BATCH, CEPW_BATCH)   # the two CEP jobs' batches
# the late-reduce job's events at parallelism 4: at SHARD_TOTAL its 5 s of
# event time fire no window before the end of the stream, so nothing
# could re-fire; 10 s fire the first window while late records still come
SHARD_LATE_TOTAL = 20_000_000
# cep-within's events at parallelism 4: 20 s of event time, two within()
# horizons, so panes expire (as the one-shard run); cut from 8M to 4M,
# then to 2M, to hold the whole script near 800 s beside phase 26
SHARD_CEPW_TOTAL = 2_000_000
# the kernels each phase-25 path must launch (G1's owner mask a shard)
SHARD_SESSION_KERNELS = ("route_lanes", "hash_upsert", "segment_sort",
                         "session_update")
SHARD_WINDOWCOUNT_KERNELS = ("route_lanes", "hash_upsert", "segment_sort",
                             "count_update")
SHARD_CEP_KERNELS = ("route_lanes", "shard_sum") + CEP_KERNELS
SHARD_CEPW_KERNELS = SHARD_CEP_KERNELS + ("cep_expire",)


def _shard_ranges():
    from flink_tpu_torch.parallel.mesh import MeshContext
    ctx = MeshContext.create(SHARDS, MAX_PARALLELISM,
                             devices=["cpu"] * SHARDS)
    return [(r.start, r.end) for r in ctx.key_group_ranges]


def _cep_key_lanes(dev, B, kind):
    """A CEP batch's key halves as the job encodes them: the cep job's
    1,000 integer keys (B = 16,384) or the cep-within job's sparse ids
    (B = 8,192)."""
    if B == CEP_BATCH:
        _e, _n, keys = cep_events(B)
        hi, lo = np.zeros(B, np.uint32), keys.astype(np.uint32)
    else:
        ids = cepw_gen(0, B)[0]["key"].view(np.uint64)
        hi = (ids >> np.uint64(32)).astype(np.uint32)
        lo = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    valid = np.ones(B, bool)
    if kind == "edge":
        hi[: B // 5] = hi[0]          # a fifth of the lanes on one key
        lo[: B // 5] = lo[0]
        valid[-(B // 20):] = False    # dead lanes
    return _i32(hi, dev), _i32(lo, dev), torch.from_numpy(valid).to(dev)


def case_route_owner(dev, kind, B):
    """G1's owner mask (``parallel/exchange.py owned_lanes``: slide 1,
    zero ticks, the MIN watermark) on a CEP batch for each of the four
    shard ranges, against its plain version; timed on shard 0's."""
    hi, lo, valid = _cep_key_lanes(dev, B, kind)
    ts = torch.zeros_like(hi)
    none = torch.tensor(PANE_NONE, dtype=torch.int32, device=dev)
    err, owned = 0.0, 0
    for k0, k1 in _shard_ranges():
        kw = dict(slide=1, k=1, maxp=MAX_PARALLELISM, kg_start=k0,
                  kg_end=k1)
        a = kernels.route_lanes(hi, lo, ts, valid, none, none, **kw)
        b = kernels.route_lanes_plain(hi, lo, ts, valid, none, none, **kw)
        err = max(err, max_abs_err(list(a), list(b)))
        owned += int(a[2].sum())
    check(owned == int(valid.sum()), f"owner masks ({kind}, B = {B}) "
          f"own {owned} lanes of {int(valid.sum())}")
    k0, k1 = _shard_ranges()[0]
    kw = dict(slide=1, k=1, maxp=MAX_PARALLELISM, kg_start=k0, kg_end=k1)
    return {
        "err": err,
        "run": lambda: kernels.route_lanes(hi, lo, ts, valid, none, none,
                                           **kw),
        "plain": lambda: kernels.route_lanes_plain(hi, lo, ts, valid, none,
                                                   none, **kw),
        "library": None,
        # hi, lo, ts, valid read; pane, kg, live written
        "bytes": B * 22,
    }


def case_shard_sum_cep(dev, kind, B):
    """G27 at CEP's delta shape: four shards' float32 [B] match deltas
    (small counts on a tenth of the lanes), each masked by its owner mask
    of the batch's keys (disjoint: the sum is exact), against its plain
    version; its library time ``torch.stack(...).sum(0)`` over the masked
    deltas."""
    from flink_tpu_torch.parallel.exchange import owned_lanes
    hi, lo, valid = _cep_key_lanes(dev, B, kind)
    g = torch.Generator().manual_seed(20)
    mines = [owned_lanes(hi, lo, valid, k0, k1, MAX_PARALLELISM)
             for k0, k1 in _shard_ranges()]
    outs = []
    for m in mines:
        d = torch.randint(0, 4, (B,), generator=g).float()
        d[torch.rand(B, generator=g) > 0.1] = 0.0
        outs.append(torch.where(m.cpu(), d, 0.0).to(dev))
    a = kernels.shard_sum(outs, mines)
    b = kernels.shard_sum_plain(outs, mines)
    masked = [torch.where(m, o, 0.0) for o, m in zip(outs, mines)]
    err = max_abs_err(list(a), list(b))
    err = max(err, max_abs_err(a[0], torch.stack(masked).sum(0)))
    return {
        "err": err,
        "run": lambda: kernels.shard_sum(outs, mines),
        "plain": lambda: kernels.shard_sum_plain(outs, mines),
        "library": lambda: torch.stack(masked).sum(0),
        "bytes": SHARDS * B * 5 + B * 5,
    }


def case_chain_pack_shard(dev, kind):
    """G21 on one shard's fire stack of the chained job at parallelism
    four: the stage-0 fires of its second drain restricted to the keys
    shard 0 owns, in the shard's [16, 2, 1M] arena, into an edge of
    CHAIN_EDGE_LANES (``edge``: a quarter of them, so lanes drop)."""
    planes = chain_main_planes()
    k0, k1 = _shard_ranges()[0]
    mine = {}
    for key, (k, v, end) in planes.items():
        kt = torch.from_numpy(k.astype(np.int32))
        kg = assign_to_key_group(route_hash(torch.zeros_like(kt), kt),
                                 MAX_PARALLELISM).numpy()
        own = (kg >= k0) & (kg <= k1)
        mine[key] = (k[own], v[own], end)
    E = CHAIN_EDGE_LANES if kind == "main" else CHAIN_EDGE_LANES // 16
    i32 = dict(dtype=torch.int32, device=dev)
    up_wm = (2 * RING_DEPTH * BATCH - 1) // EVENTS_PER_MS - 1
    ft = max(e for _k, _v, e in planes.values()) // CHAIN_W1_MS - 1
    stack = chain_stack(dev, RING_DEPTH, FIRES_PER_STEP, N_KEYS, mine)
    kw = dict(n_lanes=E, up_wm=torch.tensor(up_wm, **i32),
              fired_through=torch.tensor(ft, **i32), slide=CHAIN_W1_MS)
    got = kernels.chain_pack(*stack, **kw)
    want = kernels.chain_pack_plain(*stack, **kw)
    demand = int(want.demand)
    check(demand == sum(len(k) for k, _v, _e in mine.values()),
          f"chain_pack (shard, {kind}): demand {demand}")
    live = min(demand, E)
    return {
        "err": max_abs_err(list(got), list(want)),
        "run": lambda: kernels.chain_pack(*stack, **kw),
        "plain": lambda: kernels.chain_pack_plain(*stack, **kw),
        "library": None,
        "bytes": E * 17 + live * 12 + RING_DEPTH * FIRES_PER_STEP * 9 + 12,
    }


def sharded_keyed_kernel_phase(dev, timing=True) -> dict:
    """Phase 3's checks of the kernels phase 25's jobs run per shard:
    G1's owner mask on both CEP batches for each shard range, G27 at both
    CEP delta shapes and G21 on one shard's fire stack. Returns {kernel:
    {mode: record}}."""
    out = {"route_lanes": {}, "shard_sum": {}, "chain_pack": {}}
    for B in SHARD_KEYED_CEP_B:
        out["route_lanes"][f"owner_cep_{B}"] = hold(
            f"route_lanes (owner mask, B = {B})",
            lambda k, b=B: case_route_owner(dev, k, b), timing)
        out["shard_sum"][f"cep_{B}"] = hold(
            f"shard_sum (CEP deltas, B = {B})",
            lambda k, b=B: case_shard_sum_cep(dev, k, b), timing)
    out["chain_pack"]["shard"] = hold(
        "chain_pack (one shard's stack)",
        lambda k: case_chain_pack_shard(dev, k), timing)
    return out


def check_sharded_telemetry(env, job, total, want_count, sink) -> dict:
    """The north star at parallelism 4 with the flight recorder: a report
    row a shard (the sharded ring), their events every record, their
    fired keys the drains' fires, nothing dropped; the live keys per key
    group against numpy's."""
    m = job.metrics
    rep = env._pipeline_report()
    rows = rep["shards"]
    check(sink.count == want_count and sink.value_sum == float(total),
          f"telemetry at parallelism {SHARDS}: {sink.count} rows summing "
          f"to {sink.value_sum}")
    check(rep["available"] and rep["n_shards"] == SHARDS
          and len(rows) == SHARDS,
          f"telemetry at parallelism {SHARDS}: {len(rows)} report rows")
    tot = {f: sum(r["totals"][f] for r in rows) for f in rows[0]["totals"]}
    check(tot["events"] == total and tot["late_dropped"] == 0
          and tot["nofit_dropped"] == 0
          and all(r["totals"]["events"] > 0 for r in rows),
          f"telemetry at parallelism {SHARDS}: totals {tot}")
    check(tot["fired_keys"] == m.fires - m.fire_step_fires,
          f"telemetry at parallelism {SHARDS}: fired keys "
          f"{tot['fired_keys']}, the drains' fires "
          f"{m.fires - m.fire_step_fires}")
    kg = env._kg_report(MAX_PARALLELISM)
    occ = np.zeros(MAX_PARALLELISM, np.int64)
    for r in kg["occupancy_top"]:
        occ[r["group"]] = r["count"]
    want_occ = live_key_groups(total, EVENTS_PER_MS, WINDOW_MS, N_KEYS,
                               MAX_PARALLELISM)
    check(np.array_equal(occ, want_occ),
          f"telemetry at parallelism {SHARDS}: occupancy differs from "
          f"numpy's in {int((occ != want_occ).sum())} groups")
    return {"totals": tot, "rows": len(rows),
            "publish_refusals": [r.get("publish_refusals") for r in rows],
            "drains": rep["drains"]}


def sharded_keyed_runs(dev, kind, smi, total_launches) -> None:
    """Phase 25: every keyed job kind but tiered state at parallelism
    SHARDS, its shards forced onto the one card, each job once under
    torch.profiler recording the card's activity (events/s and the card's
    idle share from that run):
    nexmark q11 sessions and WindowWordCount (G1's owner mask a shard,
    then G5, G10, G11 / G12), the cep and cep-within jobs (the sharded
    count NFA: G1, G5, G10, G19, G20 a shard, G27's delta sum), the
    chained rollup on the mask drain and on the sharded chained drain
    (``pipeline.data-parallel: on``), the late-reduce job (the split
    path's fire steps with re-fires a shard) and the north star with the
    flight recorder on every shard. Each at SHARD_TOTAL events or its
    one-shard size where that is smaller (the late-reduce job at
    SHARD_LATE_TOTAL, cep-within at SHARD_CEPW_TOTAL); every row against
    numpy's (CEP key by key)."""
    from flink_tpu_torch.parallel.mesh import forced_device_count

    t_phase = time.perf_counter()
    mark = Marks("25_sharded_keyed")

    def run(name, job_fn, total, kernels_of, unit="events"):
        mark("before " + name)   # the previous job's checks, this one's data
        launches, (out, busy) = run_path(
            lambda: device_busy(job_fn, cpu=False), total_launches)
        mark(name)
        secs = out[-1]
        check_launched(launches, kernels_of, f"parallelism-{SHARDS} {name}")
        line = {"phase": "sharded_keyed", "job": name, unit: total,
                "seconds": secs, f"{unit}_per_s": total / secs,
                "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / (secs * 1e3),
                "timed": "under torch.profiler (the card's activity)",
                "launches": launches,
                "device": kind, "nvidia_smi": smi}
        return out, line

    with forced_device_count(SHARDS):
        total = SHARD_TOTAL
        (sink, job, _s), line = run(
            "sessions", lambda: sessions_job(dev, total, SHARDS), total,
            SHARD_SESSION_KERNELS)
        m = job.metrics
        n_rows, _early = check_session_rows(sink.columns(), total)
        check(m.dropped_late == 0 and m.dropped_capacity == 0,
              "sharded sessions: records dropped")
        emit({**line, "rows": n_rows, "steps": m.steps})
        del sink, job

        ranks = all_word_ranks(total)
        (sink, job, _s), line = run(
            "windowcount", lambda: windowcount_job(dev, total, SHARDS),
            total, SHARD_WINDOWCOUNT_KERNELS)
        n_rows = check_windowcount_rows(sink.columns(), ranks)
        check(job.metrics.dropped_capacity == 0,
              "sharded windowcount: records dropped")
        emit({**line, "rows": n_rows})
        del sink, job, ranks

        events, names, keys = cep_events(CEP_TOTAL)
        want = cep_reference(names, keys)
        (sink, job, _s), line = run(
            "cep", lambda: cep_job(dev, events, SHARDS), CEP_TOTAL,
            SHARD_CEP_KERNELS)
        m = job.metrics
        check(sink.count == want == m.cep_matches_detected
              == m.cep_matches_extracted and m.dropped_capacity == 0,
              f"sharded cep: {sink.count} matches, numpy {want}, detected "
              f"{m.cep_matches_detected}, extracted "
              f"{m.cep_matches_extracted}")
        emit({**line, "matches": sink.count, "matches_numpy": want,
              "device_steps": m.cep_device_steps})
        del sink, job, events, names, keys

        (sink, job, _s), line = run(
            "cep_within", lambda: cepw_job(dev, SHARD_CEPW_TOTAL,
                                           parallelism=SHARDS),
            SHARD_CEPW_TOTAL, SHARD_CEPW_KERNELS)
        m = job.metrics
        cols = cepw_columns(SHARD_CEPW_TOTAL)
        pane_ms = DevicePatternSpec.from_pattern(cepw_pattern()).pane_ms
        n_rows, want, keys_matched, sample_rows = check_cepw_rows(
            sink.results, cols, pane_ms, CEPW_SEED)
        check(m.cep_matches_detected == m.cep_matches_extracted == n_rows
              and m.dropped_capacity == 0,
              f"sharded cep-within: detected {m.cep_matches_detected}, "
              f"extracted {m.cep_matches_extracted}, rows {n_rows}")
        emit({**line, "rows": n_rows, "rows_numpy": want,
              "sampled_keys_with_matches": keys_matched,
              "sampled_rows": sample_rows,
              "device_steps": m.cep_device_steps})
        del sink, job, cols

        want5, _stage0 = chained_reference(total)
        for name, dp, route in (("chained_mask", "off", "mask"),
                                ("chained_sharded", "on", "sharded")):
            (sink, _env, job, _s), line = run(
                name, lambda d=dp: chained_job(
                    dev, total, config={"pipeline.data-parallel": d},
                    parallelism=SHARDS), total, CHAIN_KERNELS)
            m = job.metrics
            n_rows = check_chained_rows(sink.columns(), want5)
            check(m.dropped_late == 0 and m.dropped_capacity == 0,
                  f"sharded {name}: records dropped")
            check(_routed(m, route), f"sharded {name}: the {route} route "
                  f"never ran ({m.steps_sharded} sharded batches)")
            emit({**line, "rows": n_rows, "steps_sharded": m.steps_sharded,
                  **chain_metrics(m)})
            del sink, _env, job

        late_total = SHARD_LATE_TOTAL
        (sink, job, _s), line = run(
            "late_reduce", lambda: late_job(dev, late_total, SHARDS),
            late_total, LATE_KERNELS)
        m = job.metrics
        n_rows, n_refired, n_refire_rows = check_late_rows(
            sink.columns(), late_total, m.dropped_late)
        check(m.dropped_capacity == 0 and n_refire_rows > 0,
              f"sharded late-reduce: capacity drops {m.dropped_capacity}, "
              f"re-fire rows {n_refire_rows}")
        emit({**line, "rows": n_rows, "windows_refired": n_refired,
              "refire_rows": n_refire_rows, "dropped_late": m.dropped_late,
              "fire_steps": m.fire_steps})
        del sink, job

        want_small = numpy_reference(total, N_KEYS, EVENTS_PER_MS,
                                     WINDOW_MS)
        (sink, env_t, job, _s), line = run(
            "north_star_telemetry", lambda: north_star_job(
                dev, N_KEYS, EVENTS_PER_MS, total, BATCH, RING_DEPTH,
                config=TELEMETRY_CONFIG, with_env=True,
                parallelism=SHARDS), total, TELEMETRY_KERNELS)
        checked = check_sharded_telemetry(env_t, job, total, want_small,
                                          sink)
        check(job.metrics.steps_sharded > 0,
              "sharded telemetry: the sharded drain never ran")
        emit({**line, **checked, "steps_sharded": job.metrics.steps_sharded})
        del sink, env_t, job
    mark("last checks")
    emit({"phase": "sharded_keyed_done",
          "seconds": time.perf_counter() - t_phase})


# ------------------------------------------------------------ main

# ------------------------------------------------------------ phase 26

DCN_PROCS = 2                  # worker processes on the one card
DCN_LOCAL = 2                  # forced shards a worker: n = 4
DCN_WINDOW_EVENTS = 4_000_000  # a host's events of the window jobs
# the window jobs' events a ms of the global stream: 2 x 4M span 16 s, so
# three 5 s windows fire before the end of the stream and one at it
DCN_EVENTS_PER_MS = 500
DCN_KEYED_EVENTS = 2_000_000   # a host's events of sessions and rolling
DCN_RING_DEPTH = 8             # the resident window job's ring
# hash slots a shard of the window and rolling jobs: a quarter of the 1M
# keys a shard at a load of 0.24, where no key sits 16 probes deep (at
# 2^19 some do, and are lost)
DCN_CAPACITY = 1 << 20
DCN_WALL_S = 300               # a worker's wall limit
DCN_GLOO_TIMEOUT_S = 120       # the Gloo group's limit on one collective
DCN_WINDOW_KERNELS = ("route_lanes", "clear_rows", "scatter_update",
                      "hash_upsert", "fire_compact", "exchange_pack")
DCN_SESSION_KERNELS = ("route_lanes", "hash_upsert", "segment_sort",
                       "session_update")
DCN_ROLLING_KERNELS = ("exchange_pack", "route_lanes", "hash_upsert",
                       "segment_sort", "rolling_update")
DCN_CEP_KERNELS = ("route_lanes", "hash_upsert", "segment_sort", "cep_scan")
CEP_TS_DIV = 16                # the DCN cep job's events a ms


def _interleaved(events_of, total):
    """A host's partition of a global stream: host p of P takes the
    events p, p + P, p + 2P, ..., ``total`` of them, so every host's
    event time advances with the others'. ``events_of(idx)`` gives
    (keys, ts ms, values) of global event indices."""
    def factory(pid, nproc):
        from flink_tpu_torch.runtime.dcn import GeneratorPartitionSource

        def fn(offset, n):
            return events_of(pid + nproc * np.arange(offset, offset + n,
                                                     dtype=np.int64))
        return GeneratorPartitionSource(fn, total)
    return factory


def north_star_events(idx, per_ms=EVENTS_PER_MS):
    return ((idx * 2862933555777941757) % N_KEYS, idx // per_ms,
            np.ones(len(idx), np.float32))


def session_events(idx):
    b, t = session_index(idx)
    return splitmix64(b).view(np.int64), t, np.ones(len(idx), np.float32)


_CEP_BITS = {}


def cep_bit_events(idx):
    """The cep job's events with the stage bits in the value lane (bit 0
    ``a``, bit 1 ``b``: the pattern's predicates at the ingesting host)."""
    if "bits" not in _CEP_BITS:
        names, keys = cep_arrays(CEP_TOTAL)
        _CEP_BITS["bits"] = ((names == "a") * 1 + (names == "b") * 2)
        _CEP_BITS["keys"] = keys
    return (_CEP_BITS["keys"][idx], idx // CEP_TS_DIV,
            _CEP_BITS["bits"][idx].astype(np.float32))


def dcn_window_job(events=DCN_WINDOW_EVENTS, per_ms=DCN_EVENTS_PER_MS,
                   resident=False):
    """The window job of phase 26 (a worker's ``--builder``; ``events`` a
    host, ``per_ms`` the global stream's events a ms, given by
    ``--builder-kwargs``): the north star's keys and 5 s tumbling sum,
    262,144 lanes a host."""
    from flink_tpu_torch.runtime.dcn import DCNJobSpec
    return DCNJobSpec(
        source_factory=_interleaved(
            lambda idx: north_star_events(idx, per_ms), events),
        size_ms=WINDOW_MS, capacity_per_shard=DCN_CAPACITY,
        max_parallelism=MAX_PARALLELISM, batch_per_host=BATCH,
        fires_per_step=4, resident=resident,
        resident_ring_depth=DCN_RING_DEPTH)


def dcn_window_resident_job(**kw):
    return dcn_window_job(resident=True, **kw)


def dcn_window_resident_stalled(**kw):
    """The resident job whose second checkpoint write stalls (the
    ``dcn.ckpt.write`` seam) until the worker is killed: the first cut
    completes, then the ensemble stops."""
    faults.install(faults.FaultInjector([faults.FaultRule(
        "dcn.ckpt.write", action="sleep", delay_s=DCN_WALL_S, at=1)]))
    return dcn_window_job(resident=True, **kw)


def dcn_session_job(events=DCN_KEYED_EVENTS):
    from flink_tpu_torch.runtime.dcn import DCNJobSpec
    return DCNJobSpec(
        source_factory=_interleaved(session_events, events),
        window_kind="session", gap_ms=SESSION_GAP_MS, reduce_kind="count",
        capacity_per_shard=1 << 18, max_parallelism=MAX_PARALLELISM,
        batch_per_host=BATCH)


def dcn_rolling_job(events=DCN_KEYED_EVENTS):
    from flink_tpu_torch.runtime.dcn import DCNJobSpec
    return DCNJobSpec(
        source_factory=_interleaved(north_star_events, events),
        window_kind="rolling", capacity_per_shard=DCN_CAPACITY,
        max_parallelism=MAX_PARALLELISM, batch_per_host=BATCH)


def dcn_cep_job(events=CEP_TOTAL // DCN_PROCS):
    from flink_tpu_torch.runtime.dcn import DCNJobSpec
    return DCNJobSpec(
        source_factory=_interleaved(cep_bit_events, events),
        window_kind="cep", cep_pattern_factory=cep_pattern,
        capacity_per_shard=CEP_CAPACITY, max_parallelism=MAX_PARALLELISM,
        batch_per_host=CEP_BATCH)


def _free_port() -> int:
    """A free port below the kernel's ephemeral range, which no outgoing
    connection can take between this pick and the worker's bind."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.SystemRandom()
    while True:
        port = rng.randrange(max(1024, low - 12000), low)
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def dcn_spawn(tag, builder, tmp, extra=(), profile=False, kwargs=None,
              device=None):
    """Start the two workers of one ensemble on the card (``profile``: each
    under torch.profiler recording the card; ``device`` another device,
    ``kwargs`` the builder's keyword arguments, for a rehearsal at a
    smaller size); returns (procs, their row files)."""
    here = os.path.dirname(os.path.abspath(__file__))
    # one OpenMP thread a worker: two workers' thread pools on the
    # machine's cores spin against each other (the window job ran 1.7x
    # slower with the default pools on an H100 host of 8 cores)
    # and a bytecode cache the workers share: the installed packages may
    # carry none, and each worker would compile torch's sources anew
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPYCACHEPREFIX=os.path.join(tmp, "pycache"),
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    coord = f"127.0.0.1:{_free_port()}"
    outs = [os.path.join(tmp, f"{tag}-{p}.npz") for p in range(DCN_PROCS)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "flink_tpu_torch.runtime.dcn",
         "--coordinator", coord, "--num-processes", str(DCN_PROCS),
         "--process-id", str(p), "--builder",
         f"{os.path.join(here, 'chip_smoke.py')}:{builder}",
         "--out", outs[p], "--local-devices", str(DCN_LOCAL),
         "--timeout-s", str(DCN_GLOO_TIMEOUT_S),
         *(["--builder-kwargs", json.dumps(kwargs)] if kwargs else []),
         *(["--device", device] if device else
           ["--profile"] if profile else []),
         *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(DCN_PROCS)]
    return procs, outs


def dcn_wait(procs, tag):
    """Wait for an ensemble (killing it past the wall limit); returns each
    worker's JSON result line by process id."""
    deadline = time.time() + DCN_WALL_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1, deadline - time.time()))
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    stats = {}
    for p, log in zip(procs, logs):
        check(p.returncode == 0,
              f"dcn {tag}: a worker failed:\n{log[-4000:]}")
        for line in log.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                stats[row["pid"]] = row
    return stats


class UtilSampler:
    """nvidia-smi's ``utilization.gpu`` (the share of its sample period in
    which a kernel ran on the card, whichever process launched it) every
    100 ms while the block runs; ``busy(t0, t1)`` is (the mean over the
    samples taken between two wall-clock times, None without one; their
    count)."""

    def __enter__(self):
        self.proc = None
        self.samples = []
        if torch.cuda.is_available():
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        import datetime as dt

        for line in out.splitlines():
            try:
                stamp, util = (x.strip() for x in line.split(","))
                t = dt.datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f")
                self.samples.append((t.timestamp(), float(util)))
            except ValueError:
                continue

    def busy(self, t0, t1):
        inside = [u for t, u in self.samples if t0 <= t <= t1]
        return (sum(inside) / len(inside) / 100 if inside else None,
                len(inside))


def dcn_run(tag, builder, tmp, extra=(), profile=False, kwargs=None,
            device=None):
    t0 = time.perf_counter()
    with UtilSampler() as util:
        procs, outs = dcn_spawn(tag, builder, tmp, extra, profile, kwargs,
                                device)
        stats = dcn_wait(procs, tag)
    runs = [st["run_epoch_s"] for st in stats.values()]
    smi_busy, n = util.busy(min(r[0] for r in runs),
                            max(r[1] for r in runs))
    for st in stats.values():
        st["ensemble_s"] = time.perf_counter() - t0
        st["smi_busy"], st["smi_samples"] = smi_busy, n
    return stats, outs


def dcn_rows(outs):
    """Both workers' rows, concatenated, and each one's busy spans."""
    cols = {k: [] for k in ("key_id", "window_start_ms", "window_end_ms",
                            "value")}
    spans = []
    for path in outs:
        data = np.load(path)
        for k in cols:
            cols[k].append(data[k])
        spans += [tuple(r) for r in data["busy_spans_us"]]
    return {k: np.concatenate(v) for k, v in cols.items()}, spans


def dcn_line(name, stats, spans, events, rows, kernels_of, total_launches,
             kind, smi, extra=None) -> dict:
    """One job's phase line: events/s over the slower worker's run, the
    Gloo bytes a host sends per lockstep cycle (one exchange round; a
    resident cycle's drain runs one a live slot), the card's idle share
    over that run from nvidia-smi's utilization samples and, for a
    profiled run, from its busy time (the union of both workers' kernel
    and copy intervals); the workers' launches, each kernel of the path
    launched."""
    secs = max(st["seconds"] for st in stats.values())
    launches = {}
    for st in stats.values():
        for k, n in st["launches"].items():
            launches[k] = launches.get(k, 0) + n
    for k, n in launches.items():
        total_launches[k] = total_launches.get(k, 0) + n
    check_launched(launches, kernels_of, f"dcn {name}")
    busy = _busy_ms(spans) if spans else None
    smi_busy = stats[0].get("smi_busy")
    line = {"phase": f"dcn_{name}", "events": events, "seconds": secs,
            "events_per_s": events / secs, "rows": rows,
            "cycles": stats[0]["cycles"],
            "gloo_bytes_sent": [st["gloo_bytes_sent"]
                                for st in stats.values()],
            "gloo_bytes_per_cycle": [st["gloo_bytes_sent"] / st["cycles"]
                                     for st in stats.values()],
            "gloo_collectives": [st["gloo_rounds"]
                                 for st in stats.values()],
            "ingested": [st["ingested_local"] for st in stats.values()],
            "worker_s": {k: [st.get(k) for st in stats.values()] for k in
                         ("ensemble_s", "setup_s", "profiler_start_s",
                          "profiler_stop_s")},
            "card_busy_ms": busy,
            "card_idle_share": (None if busy is None
                                else 1 - busy / (1e3 * secs)),
            "card_idle_share_smi": (None if smi_busy is None
                                    else 1 - smi_busy),
            "smi_samples_in_run": stats[0].get("smi_samples"),
            "processes": DCN_PROCS, "shards": DCN_PROCS * DCN_LOCAL,
            "launches": launches, "device": kind, "nvidia_smi": smi}
    line.update(extra or {})
    emit(line)
    check(all(st["dropped_capacity"] == 0 for st in stats.values()),
          f"dcn {name}: records dropped: {stats}")
    return line


def check_dcn_window_rows(cols, events, per_ms):
    """Every (key, window, sum) row of the window job against numpy, each
    (key, window) once; the stream must span more than one window, so
    that windows fire before its end. Returns (rows, windows)."""
    idx_total = DCN_PROCS * events
    n_win = -(-idx_total // (per_ms * WINDOW_MS))
    check(n_win > 1, f"the window job's stream spans {n_win} window")
    counts = np.zeros(n_win * N_KEYS, np.int64)
    for off in range(0, idx_total, 1 << 22):
        idx = np.arange(off, min(off + (1 << 22), idx_total), dtype=np.int64)
        keys, ts, _ = north_star_events(idx, per_ms)
        counts += np.bincount(ts // WINDOW_MS * N_KEYS + keys,
                              minlength=n_win * N_KEYS)
    end = cols["window_end_ms"].astype(np.int64)
    cell = (end // WINDOW_MS - 1) * N_KEYS + cols["key_id"].astype(np.int64)
    check(np.all(end % WINDOW_MS == 0)
          and np.all(cols["window_start_ms"] == end - WINDOW_MS)
          and len(np.unique(cell)) == len(cell),
          "dcn window: a (key, window) emitted twice, or off the grid")
    want = np.flatnonzero(counts)
    o = np.argsort(cell)
    check(np.array_equal(cell[o], want)
          and np.array_equal(cols["value"][o], counts[want].astype(
              np.float32)),
          f"dcn window: {len(cell)} rows, numpy {len(want)}; the rows "
          f"differ from numpy's")
    return len(cell), n_win


def check_dcn_rolling_rows(cols, events):
    """Each key's emissions are its running count 1..n (every record once),
    n the key's events in numpy."""
    idx = np.arange(DCN_PROCS * events, dtype=np.int64)
    counts = np.bincount(north_star_events(idx)[0], minlength=N_KEYS)
    key = cols["key_id"].astype(np.int64)
    val = cols["value"]
    o = np.lexsort((val, key))
    key, val = key[o], val[o]
    start = np.r_[True, key[1:] != key[:-1]]
    first = np.maximum.accumulate(np.where(start, np.arange(len(key)), 0))
    check(len(key) == len(idx)
          and np.array_equal(np.bincount(key, minlength=N_KEYS), counts)
          and np.array_equal(val, (np.arange(len(key)) - first + 1)
                             .astype(np.float32)),
          "dcn rolling: the running counts differ from numpy's")
    return len(key)


def dcn_cep_order(b_host):
    """The global event indices in the plane's processing order: round by
    round, host 0's lanes then host 1's (the all_gather's order)."""
    per = CEP_TOTAL // DCN_PROCS
    hosts = [p + DCN_PROCS * np.arange(per, dtype=np.int64)
             for p in range(DCN_PROCS)]
    return np.concatenate([h[r:r + b_host] for r in range(0, per, b_host)
                           for h in hosts])


def check_dcn_cep_rows(cols):
    """Each key's matches (sum of the completions at its events) against
    numpy's ``a followedBy b`` count in the plane's processing order."""
    names, keys = cep_arrays(CEP_TOTAL)
    o = dcn_cep_order(CEP_BATCH)
    names, keys = names[o], keys[o]
    order = np.argsort(keys, kind="stable")
    k_s = keys[order]
    a_s = (names[order] == "a").astype(np.int64)
    b_s = names[order] == "b"
    before = np.cumsum(a_s) - a_s
    starts = np.r_[True, k_s[1:] != k_s[:-1]]
    first = np.maximum.accumulate(np.where(starts, np.arange(len(k_s)), 0))
    want = np.bincount(k_s, weights=(before - before[first]) * b_s,
                       minlength=CEP_KEYS)
    got = np.bincount(cols["key_id"].astype(np.int64),
                      weights=cols["value"].astype(np.float64),
                      minlength=CEP_KEYS)
    check(np.array_equal(got, want),
          f"dcn cep: {got.sum()} matches, numpy {want.sum()}; the per-key "
          f"totals differ")
    return int(want.sum())


def dcn_kill_after_first_cut(procs, ckpt, tag):
    """Wait for a checkpoint that both workers completed, then SIGKILL
    them (the lockstep failure unit is the job)."""
    deadline = time.time() + DCN_WALL_S
    cut = None
    try:
        while time.time() < deadline and cut is None:
            for d in sorted(os.listdir(ckpt)):
                if all(os.path.exists(os.path.join(
                        ckpt, d, f"proc-{p}.meta.json"))
                       for p in range(DCN_PROCS)):
                    cut = d
            check(all(p.poll() is None for p in procs) or cut is not None,
                  f"dcn {tag}: a worker ended before the first cut")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    check(cut is not None, f"dcn {tag}: no complete checkpoint")
    return cut


def cut_rows(ckpt, cut) -> int:
    """The rows emitted up to a cut: the row deltas of every checkpoint up
    to it, of every process, that a restore replays."""
    return sum(len(np.load(os.path.join(ckpt, d, f"proc-{p}.npz"))
                   ["rows_key"])
               for d in sorted(os.listdir(ckpt)) if d <= cut
               for p in range(DCN_PROCS))


def broadcast_sharded_run(dev, kind, smi, total_launches) -> None:
    """K21 sharded through its entry point: ``broadcast_join`` over 4
    forced shards (each G24 on a quarter of the lanes), the DataSet
    join's shape (1,000,000 probes, half of them missing, into SF1's
    10,000 supplier keys, shuffled), every lane against numpy."""
    from flink_tpu_torch.parallel.broadcast import broadcast_join
    from flink_tpu_torch.parallel.mesh import MeshContext

    rng = np.random.default_rng(LIB_SEED)
    tkeys = rng.permutation(np.arange(1, TPCH_SUPPLIERS + 1,
                                      dtype=np.int64))
    tvals = (tkeys % 1000).astype(np.float32)
    keys = rng.integers(1, 2 * TPCH_SUPPLIERS + 1, JOIN_PROBES)
    ctx = MeshContext.create(SHARDS, devices=[dev] * SHARDS)

    def run():
        t = time.perf_counter()
        out = broadcast_join(keys, tkeys, tvals, ctx)
        return out, time.perf_counter() - t

    launches, ((joined, hit), secs) = run_path(run, total_launches)
    want = keys <= TPCH_SUPPLIERS
    check(np.array_equal(hit, want) and np.array_equal(
        joined, np.where(want, keys % 1000, 0).astype(np.float32)),
          "sharded broadcast join: lanes differ from numpy's")
    check(dev.type != "cuda" or launches["sorted_probe"] == SHARDS,
          f"sharded broadcast join: {launches['sorted_probe']} G24 "
          f"launches, not one a shard")
    emit({"phase": "broadcast_sharded", "shards": SHARDS,
          "probes": JOIN_PROBES, "build_keys": TPCH_SUPPLIERS,
          "seconds": secs, "probes_per_s": JOIN_PROBES / secs,
          "hits": int(hit.sum()), "launches": launches, "device": kind,
          "nvidia_smi": smi})


def dcn_runs(dev, kind, smi, total_launches, events=DCN_WINDOW_EVENTS,
             per_ms=DCN_EVENTS_PER_MS, keyed_events=DCN_KEYED_EVENTS,
             worker_device=None) -> None:
    """Phase 26: the sharded broadcast join, then the cross-process plane,
    two workers on the one card. The arguments are the full size; a
    rehearsal on the CPU passes smaller ones and ``worker_device="cpu"``."""
    mark = Marks("26_dcn")
    broadcast_sharded_run(dev, kind, smi, total_launches)
    mark("broadcast_sharded")
    t0 = time.perf_counter()
    wkw = {"events": events, "per_ms": per_ms}
    kkw = {"events": keyed_events}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dcn-") as tmp:
        wevents = DCN_PROCS * events
        for name, builder in (("window", "dcn_window_job"),
                              ("window_resident", "dcn_window_resident_job")):
            # the lockstep run under the profiler too: its CUPTI start
            # costs each worker ~8 s, so the other runs take the samples
            stats, outs = dcn_run(name, builder, tmp,
                                  profile=name == "window", kwargs=wkw,
                                  device=worker_device)
            mark(f"{name}_workers")
            cols, spans = dcn_rows(outs)
            rows, n_win = check_dcn_window_rows(cols, events, per_ms)
            mark(f"{name}_check")
            dcn_line(name, stats, spans, wevents, rows, DCN_WINDOW_KERNELS,
                     total_launches, kind, smi,
                     {"ring_depth": DCN_RING_DEPTH
                      if name == "window_resident" else 1,
                      "windows": n_win, "events_per_ms": per_ms})
        ckpt = os.path.join(tmp, "ckpt")
        os.makedirs(ckpt)
        extra = ["--checkpoint-dir", ckpt, "--ckpt-every", "1"]
        procs, _ = dcn_spawn("stalled", "dcn_window_resident_stalled", tmp,
                             extra, kwargs=wkw, device=worker_device)
        cut = dcn_kill_after_first_cut(procs, ckpt, "window_restore")
        mark("stalled_workers")
        replayed = cut_rows(ckpt, cut)
        check(replayed > 0, f"dcn window_restore: the cut {cut} comes "
                            f"before the first emitted window")
        stats, outs = dcn_run("restored", "dcn_window_resident_job", tmp,
                              extra + ["--restore"], kwargs=wkw,
                              device=worker_device)
        mark("restored_workers")
        cols, spans = dcn_rows(outs)
        rows, n_win = check_dcn_window_rows(cols, events, per_ms)
        dcn_line("window_restore", stats, spans,
                 sum(st["ingested_local"] for st in stats.values()), rows,
                 DCN_WINDOW_KERNELS, total_launches, kind, smi,
                 {"restored_from": cut, "rows_replayed": replayed,
                  "ring_depth": DCN_RING_DEPTH, "windows": n_win,
                  "note": "events: those the restored run ingested"})

        kevents = DCN_PROCS * keyed_events
        mark("restored_check")
        stats, outs = dcn_run("sessions", "dcn_session_job", tmp,
                              kwargs=kkw, device=worker_device)
        mark("sessions_workers")
        cols, spans = dcn_rows(outs)
        rows, _closed = check_session_rows(cols, kevents)
        mark("sessions_check")
        dcn_line("sessions", stats, spans, kevents, rows,
                 DCN_SESSION_KERNELS, total_launches, kind, smi)

        stats, outs = dcn_run("rolling", "dcn_rolling_job", tmp,
                              kwargs=kkw, device=worker_device)
        mark("rolling_workers")
        cols, spans = dcn_rows(outs)
        rows = check_dcn_rolling_rows(cols, keyed_events)
        mark("rolling_check")
        dcn_line("rolling", stats, spans, kevents, rows,
                 DCN_ROLLING_KERNELS, total_launches, kind, smi)

        stats, outs = dcn_run("cep", "dcn_cep_job", tmp,
                              device=worker_device)
        mark("cep_workers")
        cols, spans = dcn_rows(outs)
        matches = check_dcn_cep_rows(cols)
        mark("cep_check")
        dcn_line("cep", stats, spans, CEP_TOTAL, len(cols["key_id"]),
                 DCN_CEP_KERNELS, total_launches, kind, smi,
                 {"matches": matches})
    emit({"phase": "dcn", "seconds": time.perf_counter() - t0,
          "processes": DCN_PROCS, "shards_a_process": DCN_LOCAL})


def probe_sharded_plain(keys, valid, tk, tv, n):
    """The plain twin of the sharded broadcast join: G24's plain version
    on each of n lane slices, invalid lanes joining nothing."""
    b = keys.numel() // n
    joined, hit = [], []
    for s in range(n):
        _p, h, j = kernels.sorted_probe_plain(keys[s * b:(s + 1) * b], tk, tv)
        h = h & valid[s * b:(s + 1) * b]
        joined.append(torch.where(h, j, torch.zeros_like(j)))
        hit.append(h)
    return torch.cat(joined), torch.cat(hit)


def case_probe_sharded(dev, kind):
    """K21 sharded: the broadcast join's step over 4 forced shards
    (``parallel/broadcast.py build_broadcast_join_step``) against its
    plain twin, exactly: ``main`` the DataSet join's 1,000,000 probes
    into SF1's 10,000 supplier keys; ``edge`` G24's edge probes (+-2^62
    keys, the first and last key, one build key) with every seventh lane
    invalid. Its library time: one torch.searchsorted over the probes."""
    from flink_tpu_torch.parallel.broadcast import build_broadcast_join_step
    from flink_tpu_torch.parallel.mesh import MeshContext

    g = torch.Generator().manual_seed(21)
    if kind == "main":
        tk = torch.arange(1, TPCH_SUPPLIERS + 1, dtype=torch.int64)
        keys = torch.randint(1, TPCH_SUPPLIERS + 1, (JOIN_PROBES,),
                             generator=g)
        keys[torch.rand(JOIN_PROBES, generator=g) < 0.2] += TPCH_SUPPLIERS
        valid = torch.ones(JOIN_PROBES, dtype=torch.bool)
    else:
        tk = torch.sort(torch.randint(-(1 << 62), 1 << 62, (5000,),
                                      generator=g)).values.unique()
        keys = torch.cat([tk[:3], tk[-3:], tk[:1] - 1, tk[-1:] + 1,
                          torch.randint(-(1 << 62), 1 << 62, (4096,),
                                        generator=g), tk[::7]])
        keys = keys[:keys.numel() - keys.numel() % SHARDS]
        valid = torch.arange(keys.numel()) % 7 != 3
    keys, valid, tk = keys.to(dev), valid.to(dev), tk.to(dev)
    tv = torch.arange(tk.numel(), dtype=torch.float32, device=dev)
    step = build_broadcast_join_step(MeshContext.create(
        SHARDS, devices=[dev] * SHARDS))
    got = step(keys, valid, tk, tv)
    want = probe_sharded_plain(keys, valid, tk, tv, SHARDS)
    return {
        "err": max_abs_err(list(got), list(want)),
        "run": lambda: step(keys, valid, tk, tv),
        "plain": lambda: probe_sharded_plain(keys, valid, tk, tv, SHARDS),
        "library": lambda: torch.searchsorted(tk, keys),
        "bytes": keys.numel() * (8 + 1 + 4 + 1) + tk.numel() * 12,
    }


def case_exchange_pack_dcn(dev, kind):
    """G26 at the DCN window job's shard slice, exactly: ``main`` one of
    the 131,072-lane slices (262,144 lanes a host over 2 local shards) of
    its first round on host 0, n = 4 shards, cap = bucket_capacity(131,072,
    4) = 65,536; ``edge`` one key in every lane (the bucket overflows) and
    the exhausted host's all-invalid slice."""
    from flink_tpu_torch.parallel.exchange import bucket_capacity

    n = DCN_PROCS * DCN_LOCAL
    bpd = BATCH // DCN_LOCAL
    cap = bucket_capacity(bpd, n, 2.0)
    keys, ts, vals = north_star_events(
        DCN_PROCS * np.arange(bpd, dtype=np.int64), DCN_EVENTS_PER_MS)
    ok = np.ones(bpd, bool)
    cases = ([(keys, ok)] if kind == "main" else
             [(np.full(bpd, 7), ok), (keys, np.zeros(bpd, bool))])
    err = 0.0
    for k, v_ok in cases:
        args = (_i32(np.zeros(bpd, np.uint32), dev),
                _i32(k.astype(np.uint32), dev), _i32(ts.astype(np.int32), dev),
                torch.from_numpy(vals).to(dev), torch.from_numpy(v_ok).to(dev))
        a = kernels.exchange_pack(*args, n=n, maxp=MAX_PARALLELISM, cap=cap)
        b = kernels.exchange_pack_plain(*args, n=n, maxp=MAX_PARALLELISM,
                                        cap=cap)
        err = max(err, max_abs_err(list(a), list(b)))
    return {
        "err": err,
        "run": lambda: kernels.exchange_pack(*args, n=n,
                                             maxp=MAX_PARALLELISM, cap=cap),
        "plain": lambda: kernels.exchange_pack_plain(
            *args, n=n, maxp=MAX_PARALLELISM, cap=cap),
        "library": None,
        "bytes": bpd * 17 + n * cap * 17,
    }


DCN_HELD_ROUND = 3             # the lockstep round phase 3 holds (main)


def dcn_rounds(spec):
    """The lockstep rounds of a phase-26 job as its workers see them: each
    host polls its partition of the builder's own source up to its lane
    budget and pads it. Yields per round the hosts' columns (hi, lo, ts,
    float32 value bits, valid as int32 [5, P, B]) and the agreed
    watermark (the pmin of the hosts', MAX_TICKS from a host that the
    round exhausted), up to the round that exhausts every source."""
    from flink_tpu_torch.ops.hashing import key_identity64
    from flink_tpu_torch.runtime.dcn import MAX_TICKS

    B = spec.batch_per_host
    srcs = [spec.source_factory(p, DCN_PROCS) for p in range(DCN_PROCS)]
    wm = [-(2**31) + 1] * DCN_PROCS
    done = [False] * DCN_PROCS
    while not all(done):
        cols = np.zeros((5, DCN_PROCS, B), np.int32)
        wms = []
        for p, src in enumerate(srcs):
            keys, ts, vals, done[p] = src.poll(B)
            m = len(keys)
            if m:
                h = key_identity64(keys)
                cols[0, p, :m] = (h >> np.uint64(32)).astype(np.uint32).view(
                    np.int32)
                cols[1, p, :m] = h.astype(np.uint32).view(np.int32)
                cols[2, p, :m] = ts - spec.origin_ms
                cols[3, p, :m] = vals.astype(np.float32).view(np.int32)
                cols[4, p, :m] = 1
                wm[p] = min(max(wm[p], int(ts.max()) - spec.origin_ms
                                - spec.out_of_orderness_ms - 1), MAX_TICKS)
            wms.append(MAX_TICKS if done[p] else wm[p])
        yield cols, min(wms)


def _lanes(cols, dev):
    """(hi, lo, ts, values, valid) tensors of int32 [5, B] columns."""
    t = torch.from_numpy(np.ascontiguousarray(cols)).to(dev)
    return t[0], t[1], t[2], t[3].view(torch.float32), t[4] != 0


def _shard0_range():
    from flink_tpu_torch.parallel.mesh import MeshContext

    r = MeshContext.create(
        DCN_PROCS * DCN_LOCAL, MAX_PARALLELISM, devices=["cpu"] * DCN_LOCAL,
        process_count=DCN_PROCS, process_index=0).local_key_group_ranges[0]
    return r.start, r.end


def _clone_state(st):
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)
        if isinstance(getattr(st, f.name), torch.Tensor)})


_DCN_HELD = {}


def dcn_held(dev, job):
    """Shard 0 (process 0) of a phase-26 job driven through its path
    round by round, the rounds from ``dcn_rounds`` of the builder's own
    spec: G1's owner mask on the gathered lanes (sessions, cep) or on the
    lanes G26 buckets for shard 0 from every shard (rolling), then the
    stage's one-shard step. Returns {"main": the round DCN_HELD_ROUND,
    "edge": the last round (a partial batch; the MAX watermark)}, each
    the shard's state before the round (G5 already run on a copy of its
    table) and the round's lanes: a dict with ``st``, ``slot``, ``live``
    and the lanes."""
    if job in _DCN_HELD:
        return _DCN_HELD[job]
    from flink_tpu_torch.cep import device as cdev
    from flink_tpu_torch.ops import rolling
    from flink_tpu_torch.parallel.exchange import bucket_capacity, owned_lanes

    spec = {"sessions": dcn_session_job, "rolling": dcn_rolling_job,
            "cep": dcn_cep_job}[job]()
    C = spec.capacity_per_shard
    k0, k1 = _shard0_range()
    n = DCN_PROCS * DCN_LOCAL
    if job == "sessions":
        st = session_windows.init_state(C, dev)
    elif job == "rolling":
        st = rolling.init_state(C, dev)
        bpd = spec.batch_per_host // DCN_LOCAL
        cap = bucket_capacity(bpd, n, 2.0)
    else:
        dspec = DevicePatternSpec.from_pattern(cep_pattern())
        st = cdev.init_state(C, 16, dspec, dev)
    held, last = {}, None
    for r, (cols, wm) in enumerate(dcn_rounds(spec)):
        if job == "rolling":
            # shard 0's bucket of each source shard, in shard order
            got = []
            for p in range(DCN_PROCS):
                for s in range(DCN_LOCAL):
                    pk = kernels.exchange_pack(*_lanes(
                        cols[:, p, s * bpd:(s + 1) * bpd], dev), n=n,
                        maxp=MAX_PARALLELISM, cap=cap)
                    check(int(pk.overflow) == 0, "dcn rolling: a bucket "
                                                 "overflows")
                    got.append([x.reshape(n, cap)[0] for x in
                                (pk.hi, pk.lo, pk.ts, pk.values, pk.valid)])
            h, l, t, v, ok = (torch.cat(c) for c in zip(*got))
        else:
            h, l, t, v, ok = _lanes(cols.reshape(5, -1), dev)
        mine = owned_lanes(h, l, ok, k0, k1, MAX_PARALLELISM)
        want = owned_lanes(h.cpu(), l.cpu(), ok.cpu(), k0, k1,
                           MAX_PARALLELISM) if dev.type == "cuda" else mine
        check(torch.equal(mine.cpu(), want), f"dcn {job}: G1's owner mask "
                                             f"differs from its plain twin")
        rec = {"st": _clone_state(st), "h": h, "l": l, "t": t, "v": v,
               "mine": mine, "wm": wm}
        table = rec["st"].table if job == "cep" else rec["st"].table_keys
        if job == "cep":
            rec["slot"], ok5, _ = hashtable.upsert_counted(
                table, h, l, mine, probe_len=st.probe_len)
            bits = v.to(torch.int32)
            rec["masks"] = ((bits[:, None] >> torch.arange(
                dspec.n_stages, dtype=torch.int32, device=dev)) & 1).bool()
            rec["dspec"] = dspec
            cdev.advance(st, dspec, h, l, rec["masks"], mine)
        elif job == "sessions":
            v = torch.ones_like(v)
            rec["v"] = v
            late = mine & (t + spec.gap_ms <= rec["st"].watermark)
            rec["slot"], ok5 = hashtable.upsert(table, h, l, mine & ~late)
            ok5 = ok5 & ~late
            session_windows.update_and_fire(
                st, spec.gap_ms, h, l, t, v, mine,
                torch.tensor(wm, dtype=torch.int32, device=dev))
        else:
            rec["slot"], ok5 = hashtable.upsert(table, h, l, mine)
            rolling.update(st, h, l, v, mine)
        rec["live"] = mine & ok5
        if r == DCN_HELD_ROUND:
            held["main"] = rec
        last = rec
    held["edge"] = last
    check("main" in held, f"dcn {job}: fewer than {DCN_HELD_ROUND + 1} "
                          f"rounds")
    _DCN_HELD[job] = held
    return held


def case_segment_sort_dcn(dev, kind, job):
    """G10 at a phase-26 job's shard-0 lanes (``dcn_held``), exactly, its
    permutation also torch.sort(stable=True)'s: sessions' (slot, tick) keys over 524,288 gathered lanes, C = 2^18;
    cep's and rolling's slot keys over 32,768 gathered lanes (C = 2^16)
    and 262,144 exchanged lanes (C = 2^20)."""
    rec = dcn_held(dev, job)[kind]
    C = rec["st"].capacity
    if job == "sessions":
        key = (rec["slot"].to(torch.int64) << 32) | (rec["t"].to(torch.int64)
                                                     + 2**31)
        key = torch.where(rec["live"], key, C << 32)
        bits, sh = 32 + C.bit_length(), 32
    else:
        key = torch.where(rec["live"], rec["slot"].to(torch.int64), C)
        bits, sh = C.bit_length(), 0
    got = kernels.segment_sort(key, bits=bits, seg_shift=sh)
    want = kernels.segment_sort_plain(key, bits=bits, seg_shift=sh)
    lib = torch.sort(key, stable=True)
    check(bool((lib.indices == got[0].long()).all()),
          f"segment_sort at {job}'s lanes: the permutation differs from a "
          f"stable sort")
    return {
        "err": max_abs_err(list(got), list(want)),
        "run": lambda: kernels.segment_sort(key, bits=bits, seg_shift=sh),
        "plain": lambda: kernels.segment_sort_plain(key, bits=bits,
                                                    seg_shift=sh),
        "library": lambda: torch.sort(key, stable=True),
        "bytes": key.numel() * (8 + 4 + 8 + 1),
    }


def case_session_update_dcn(dev, kind):
    """G11 at the DCN sessions job's shard-0 lanes (524,288 gathered,
    C = 2^18), exactly: ``main`` round 3 into the open sessions of the
    rounds before (no session closes or is superseded there: the states
    are what is compared); ``edge`` the last round, a partial batch at
    the MAX watermark, which closes every open session."""
    rec = dcn_held(dev, "sessions")[kind]
    st = rec["st"]
    c = session_update_pair(
        dev, st.capacity, SESSION_GAP_MS,
        (st.start, st.last, st.acc, st.active), st.table_keys, rec["slot"],
        rec["t"], rec["live"], rec["h"], rec["l"], rec["v"],
        max(rec["wm"], int(st.watermark)), fires=kind == "edge")
    c["err"] = max_abs_err(c.pop("got"), c.pop("want"))
    return c


def case_cep_scan_dcn(dev, kind):
    """G19 at the DCN cep job's shard-0 lanes (32,768 gathered, C = 2^16,
    D = 3), exactly: ``main`` round 3 on the carry of the rounds before;
    ``edge`` the last round, the exhausted hosts' partial batches."""
    rec = dcn_held(dev, "cep")[kind]
    st, dspec = rec["st"], rec["dspec"]
    C = st.capacity
    order, key_s, seg = segment.sort_slots(rec["slot"], rec["live"], C)
    args = dict(relaxed=dspec.relaxed, Q=dspec.within_panes, q_t=0)
    c1, c2 = st.carry.clone(), st.carry.clone()
    masks = rec["masks"]
    d1 = kernels.cep_scan(order, key_s, seg, masks, c1, **args)
    d2 = kernels.cep_scan_plain(order, key_s, seg, masks, c2, **args)
    touched = int(torch.unique(key_s[key_s < C]).numel())
    D = st.carry.shape[1]
    return {
        "err": max_abs_err((d1, c1), (d2, c2)),
        "run": lambda: kernels.cep_scan(order, key_s, seg, masks, c1,
                                        **args),
        "plain": lambda: kernels.cep_scan_plain(order, key_s, seg, masks,
                                                c2, **args),
        "library": None,
        "bytes": masks.shape[0] * (dspec.n_stages + 4 + 8 + 1 + 4)
        + touched * D * 4 * 2,
    }


def case_rolling_update_dcn(dev, kind):
    """G13 at the DCN rolling job's shard-0 lanes (262,144: shard 0's
    G26 bucket from each of the 4 shards, C = 2^20), exactly: ``main``
    round 3 on the totals of the rounds before; ``edge`` the last round,
    the exhausted hosts' partial batches."""
    rec = dcn_held(dev, "rolling")[kind]
    st = rec["st"]
    C = st.capacity
    order, key_s, seg = segment.sort_slots(rec["slot"], rec["live"], C)
    a1, t1 = st.acc.clone(), st.touched.clone()
    a2, t2 = st.acc.clone(), st.touched.clone()
    vals = rec["v"]
    o1 = kernels.rolling_update(a1, t1, order, key_s, seg, vals)
    o2 = kernels.rolling_update_plain(a2, t2, order, key_s, seg, vals)
    n_keys = int(torch.unique(key_s[key_s < C]).numel())
    return {
        "err": max_abs_err((o1, a1, t1), (o2, a2, t2)),
        "run": lambda: kernels.rolling_update(a1, t1, order, key_s, seg,
                                              vals),
        "plain": lambda: kernels.rolling_update_plain(a2, t2, order, key_s,
                                                      seg, vals),
        "library": None,
        "bytes": vals.numel() * (8 + 1 + 4 + 4 + 4) + n_keys * (4 + 1) * 2,
    }


def dcn_kernel_phase(dev, timing=True) -> dict:
    """Phase 3's checks for phase 26: K21 sharded, and each kernel of the
    DCN jobs at the shapes their workers give it (shard 0 of process 0):
    G26 at the window job's slice; G10 and G11 at the sessions job's
    gathered lanes; G10 and G19 at the cep job's; G10 and G13 at the
    rolling job's exchanged lanes. Returns {kernel: {mode: record}}."""
    out = {"sorted_probe": {"sharded": hold(
               "broadcast join over 4 shards",
               lambda k: case_probe_sharded(dev, k), timing)},
           "exchange_pack": {"dcn": hold(
               "exchange_pack (the DCN window job's slice)",
               lambda k: case_exchange_pack_dcn(dev, k), timing)},
           "segment_sort": {}}
    for job in ("sessions", "cep", "rolling"):
        out["segment_sort"][f"dcn_{job}"] = hold(
            f"segment_sort (the DCN {job} job's shard lanes)",
            lambda k, j=job: case_segment_sort_dcn(dev, k, j), timing)
    out["session_update"] = {"dcn": hold(
        "session_update (the DCN sessions job's shard lanes)",
        lambda k: case_session_update_dcn(dev, k), timing)}
    out["cep_scan"] = {"dcn": hold(
        "cep_scan (the DCN cep job's shard lanes)",
        lambda k: case_cep_scan_dcn(dev, k), timing)}
    out["rolling_update"] = {"dcn": hold(
        "rolling_update (the DCN rolling job's shard lanes)",
        lambda k: case_rolling_update_dcn(dev, k), timing)}
    _DCN_HELD.clear()
    return out


KERNEL_SOURCES = {
    "route_lanes": ("flink_tpu_torch/csrc/route_lanes.cu",
                    "flink_tpu/runtime/step.py:129"),
    "clear_rows": ("flink_tpu_torch/csrc/clear_rows.cu",
                   "flink_tpu/ops/window_kernels.py:1278"),
    "scatter_update": ("flink_tpu_torch/csrc/scatter_update.cu",
                       "flink_tpu/ops/window_kernels.py:582"),
    "fire_reduced": ("flink_tpu_torch/csrc/fire_reduced.cu",
                     "flink_tpu/ops/window_kernels.py:1203"),
    "hash_upsert": ("flink_tpu_torch/csrc/hash_upsert.cu",
                    "flink_tpu/ops/hashtable.py:175"),
    "fire_compact": ("flink_tpu_torch/csrc/fire_compact.cu",
                     "flink_tpu/ops/window_kernels.py:1079"),
    "ring_append": ("flink_tpu_torch/csrc/ring_append.cu",
                    "flink_tpu/ops/window_kernels.py:222"),
    "hash_lookup": ("flink_tpu_torch/csrc/hash_lookup.cu",
                    "flink_tpu/ops/hashtable.py:94"),
    "compact_table": ("flink_tpu_torch/csrc/compact_table.cu",
                      "flink_tpu/ops/window_kernels.py:480"),
    "segment_sort": ("flink_tpu_torch/csrc/segment_sort.cu",
                     "flink_tpu/ops/segment.py:89"),
    "session_update": ("flink_tpu_torch/csrc/session_update.cu",
                       "flink_tpu/ops/session_windows.py:85"),
    "count_update": ("flink_tpu_torch/csrc/count_update.cu",
                     "flink_tpu/ops/count_windows.py:57"),
    "rolling_update": ("flink_tpu_torch/csrc/rolling_update.cu",
                       "flink_tpu/ops/rolling.py:54"),
    "sketch_update": ("flink_tpu_torch/csrc/sketch_update.cu",
                      "flink_tpu/ops/sketches.py:112"),
    "sketch_fire": ("flink_tpu_torch/csrc/sketch_fire.cu",
                    "flink_tpu/ops/window_kernels.py:1203"),
    "fresh_rows": ("flink_tpu_torch/csrc/clear_rows.cu",
                   "flink_tpu/ops/window_kernels.py:1350"),
    "fire_pack": ("flink_tpu_torch/csrc/fire_compact.cu",
                  "flink_tpu/ops/window_kernels.py:1079"),
    "rep_gather": ("flink_tpu_torch/csrc/rep_update.cu",
                   "flink_tpu/ops/segment.py:131"),
    "rep_set": ("flink_tpu_torch/csrc/rep_update.cu",
                "flink_tpu/ops/window_kernels.py:916"),
    "kg_occupancy": ("flink_tpu_torch/csrc/kg_occupancy.cu",
                     "flink_tpu/ops/window_kernels.py:432"),
    "slot_stats_begin": ("flink_tpu_torch/csrc/slot_stats.cu",
                         "flink_tpu/runtime/step.py:800"),
    "slot_stats": ("flink_tpu_torch/csrc/slot_stats.cu",
                   "flink_tpu/runtime/step.py:800"),
    "cep_scan": ("flink_tpu_torch/csrc/cep_scan.cu",
                 "flink_tpu/cep/device.py:199"),
    "cep_expire": ("flink_tpu_torch/csrc/cep_scan.cu",
                   "flink_tpu/cep/device.py:228"),
    "chain_pack": ("flink_tpu_torch/csrc/chain_pack.cu",
                   "flink_tpu/runtime/step.py:1789"),
    "fire_columns": ("flink_tpu_torch/csrc/slot_stats.cu",
                     "flink_tpu/runtime/step.py:842"),
    "stage_record": ("flink_tpu_torch/csrc/slot_stats.cu",
                     "flink_tpu/runtime/step.py:1962"),
    "scatter_ids": ("flink_tpu_torch/csrc/scatter_ids.cu",
                    "flink_tpu/ops/segment.py:183"),
    "sorted_probe": ("flink_tpu_torch/csrc/sorted_probe.cu",
                     "flink_tpu/parallel/broadcast.py:52"),
    "row_argmin": ("flink_tpu_torch/csrc/row_argbest.cu",
                   "flink_tpu/ml/pipeline.py:230"),
    "row_argmax": ("flink_tpu_torch/csrc/row_argbest.cu",
                   "flink_tpu/gelly/graph.py:293"),
    "exchange_pack": ("flink_tpu_torch/csrc/exchange_pack.cu",
                      "flink_tpu/parallel/exchange.py:49"),
    "shard_sum": ("flink_tpu_torch/csrc/shard_sum.cu",
                  "flink_tpu/runtime/step.py:2612"),
    "remove_slots": ("flink_tpu_torch/csrc/remove_slots.cu",
                     "flink_tpu/ops/hashtable.py:191"),
}
# the host functions of the chained jobs whose cumulative time --profile
# reads: the key encode, the drains (the stage tail within them), the
# reads and emits of their fires, the watermark flushes
CHAIN_HOST_FUNCTIONS = ("encode", "dispatch", "_chained_stage_tail",
                        "consume", "emit_rows", "drain_chained")
# the host functions of the CEP jobs whose cumulative time --profile reads
CEP_HOST_FUNCTIONS = ("to_elements", "push", "process_batch", "_masks",
                      "batch_gaps", "advance", "_replay", "prune_dead_keys",
                      "emit")
# G1's fill replaces K4's kg_fill branch and K11's kg_batch_fill
KG_FILL_REPLACES = "flink_tpu/ops/window_kernels.py:464"
# G1's residency mode replaces K10's kg_res divert
KG_RES_REPLACES = "flink_tpu/ops/window_kernels.py:785"
# the host functions of the checkpoint and tiered jobs --profile reads
CKPT_HOST_FUNCTIONS = ("write_checkpoint", "stage_window_state",
                       "extract_entries", "fold_spill_entries", "write",
                       "restore")
TIER_HOST_FUNCTIONS = ("tier_maintenance", "apply_tier_plan",
                       "stage_window_state", "extract_entries",
                       "fold_entries", "fetch_group_entries",
                       "precombine_entries", "restore_window_state",
                       "consume")
# which kernels each path must launch
NORTH_STAR_KERNELS = ("route_lanes", "clear_rows", "scatter_update",
                      "fire_reduced")
SPARSE_KERNELS = ("route_lanes", "clear_rows", "scatter_update",
                  "hash_upsert", "fire_compact", "ring_append", "hash_lookup")
CHURN_KERNELS = ("route_lanes", "clear_rows", "scatter_update",
                 "hash_upsert", "fire_compact", "ring_append",
                 "compact_table")
SESSION_KERNELS = ("hash_upsert", "segment_sort", "session_update")
WORDCOUNT_KERNELS = ("hash_upsert", "segment_sort", "rolling_update")
WINDOWCOUNT_KERNELS = ("hash_upsert", "segment_sort", "count_update")
SKETCH_KERNELS = ("route_lanes", "clear_rows", "hash_upsert",
                  "sketch_update", "sketch_fire")
MAXPRICE_KERNELS = ("route_lanes", "clear_rows", "scatter_update",
                    "hash_upsert", "fire_compact", "ring_append")
MEAN_KERNELS = ("route_lanes", "clear_rows", "scatter_update",
                "fire_compact", "ring_append")
TELEMETRY_KERNELS = NORTH_STAR_KERNELS + ("kg_occupancy", "slot_stats_begin",
                                         "slot_stats", "route_lanes_fill")
LATE_KERNELS = ("route_lanes", "clear_rows", "fresh_rows", "hash_upsert",
                "segment_sort", "rep_gather", "rep_set", "fire_pack")
REDUCE_TOTAL = 30_000_000


def read_launches() -> dict:
    """Every wrapper's launch count, and G1's launches with the fill
    (``route_lanes_fill``) and with the residency mask
    (``route_lanes_res``)."""
    out = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    out["route_lanes_fill"] = kernels.route_lanes.fill_launches
    out["route_lanes_res"] = kernels.route_lanes.res_launches
    return out


PHASE_S = {}      # each phase's wall seconds, by its number and name
PARTS_S = {}      # the walls of parts of a phase
_LAP = [0.0]


def lap(name: str) -> None:
    """Add the wall since the previous lap to phase ``name``."""
    now = time.perf_counter()
    PHASE_S[name] = PHASE_S.get(name, 0.0) + now - _LAP[0]
    _LAP[0] = now


def part(name: str, fn):
    """Run ``fn``, adding its wall to PARTS_S[name]; return what it
    returned."""
    t0 = time.perf_counter()
    out = fn()
    PARTS_S[name] = PARTS_S.get(name, 0.0) + time.perf_counter() - t0
    return out


class Marks:
    """Walls of the steps of one phase: each call adds the wall since the
    previous one to PARTS_S["<prefix>/<name>"]."""

    def __init__(self, prefix: str):
        self.prefix, self.t = prefix, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        key = f"{self.prefix}/{name}"
        PARTS_S[key] = PARTS_S.get(key, 0.0) + now - self.t
        self.t = now


def run_path(run, total_launches):
    """Run one path with every launch count set to 0 just before; add its
    counts to ``total_launches``; return (its counts, what run returned)."""
    kernels.reset_launch_counts()
    out = run()
    launches = read_launches()
    for name, n in launches.items():
        total_launches[name] = total_launches.get(name, 0) + n
    return launches, out


def check_launched(launches, names, path):
    for name in names:
        check(launches[name] > 0, f"kernel {name} never launched on the "
                                  f"{path} path")


def main(argv) -> int:
    global CEPW_SEED
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--seed" in argv:
        CEPW_SEED = int(argv[argv.index("--seed") + 1])
    if "--log" in argv:
        LOG.append(argv[argv.index("--log") + 1])
    dev = torch.device("cuda")
    _LAP[0] = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    lap("1_device")

    t0 = time.perf_counter()
    kernels.build()
    t1 = time.perf_counter()
    native.get_lib()
    emit({"phase": "build", "seconds": t1 - t0,
          "spill_store_seconds": time.perf_counter() - t1})
    lap("2_build")
    if "--stress" in argv:
        stress_checks(dev, int(argv[argv.index("--stress") + 1]))
        return 0
    recs = part("3_kernels/G1-G9", lambda: kernel_phase(
        dev, N_KEYS, RING_PANES, BATCH, FIRES_PER_STEP, MAX_PARALLELISM,
        WINDOW_MS))
    for name, rec in part("3_kernels/table_edges",
                          lambda: table_edge_checks(dev)).items():
        recs[name]["edges"] = rec
    split = part("3_kernels/table_split", lambda: table_op_split(dev))
    emit({"phase": "table_split", "device": smi, "calls": split})
    recs["hash_upsert"].update(
        cold_ms=split["hash_upsert cold"]["ms"],
        absent_brimful_ms=split["hash_upsert absent, brimful table"]["ms"])
    recs["hash_lookup"]["absent_ms"] = split["hash_lookup absent"]["ms"]
    recs["remove_slots"] = part("3_kernels/G28", lambda: hold(
        "remove_slots", lambda k: case_remove_slots(dev, k), True))
    recs.update(part("3_kernels/keyed", lambda: keyed_kernel_phase(
        dev, KEYED_CAPACITY, BATCH)))
    for name, rec in part("3_kernels/fire_session_edges",
                          lambda: fire_session_edge_checks(dev)).items():
        recs[name].update(rec)
    fs_split = part("3_kernels/fire_session_split",
                    lambda: fire_session_op_split(dev))
    emit({"phase": "fire_session_split", "device": smi, "calls": fs_split})
    recs["fire_reduced"]["quiet_ms"] = fs_split["fire_reduced quiet"]["ms"]
    sk_recs = part("3_kernels/sketch", lambda: sketch_kernel_phase(dev))
    for name in ("sketch_update", "sketch_fire"):
        recs[name] = dict(sk_recs[name]["distinct"],
                          countmin=sk_recs[name]["countmin"])
    recs["clear_rows"]["split"] = sk_recs["clear_rows_split"]
    for name, phase3 in (("reduce", reduce_kernel_phase),
                         ("telemetry", telemetry_kernel_phase)):
        for kname, rec in part(f"3_kernels/{name}",
                               lambda f=phase3: f(dev)).items():
            recs.setdefault(kname, {}).update(rec)
    recs.update(part("3_kernels/cep", lambda: cep_kernel_phase(dev)))
    recs.update(part("3_kernels/chain", lambda: chain_kernel_phase(dev)))
    for name, rec in part("3_kernels/res",
                          lambda: res_kernel_phase(dev)).items():
        recs.setdefault(name, {}).update(rec)
    recs.update(part("3_kernels/library",
                     lambda: library_kernel_phase(dev)))
    recs.update(part("3_kernels/shard", lambda: shard_kernel_phase(dev)))
    for name, phase3 in (("sharded_keyed", sharded_keyed_kernel_phase),
                         ("dcn", dcn_kernel_phase),
                         ("ring_exchange_edges", ring_exchange_edge_checks),
                         ("count_cep_edges", count_cep_edge_checks)):
        for kname, rec in part(f"3_kernels/{name}",
                               lambda f=phase3: f(dev)).items():
            recs.setdefault(kname, {}).update(rec)
    rx_split = part("3_kernels/ring_exchange_split",
                    lambda: ring_exchange_op_split(dev))
    emit({"phase": "ring_exchange_split", "device": smi, "calls": rx_split})
    cc_split = part("3_kernels/count_cep_split",
                    lambda: count_cep_op_split(dev))
    emit({"phase": "count_cep_split", "device": smi, "calls": cc_split})
    recs["cep_expire"]["all_stale_ms"] = cc_split[
        "cep_expire all buckets stale"]["ms"]
    recs["cep_expire"]["all_stale_library_ms"] = cc_split[
        "index_fill_ all buckets stale"]["ms"]
    recs["count_update"]["edge_ms"] = cc_split["count_update edge"]["ms"]
    emit({"phase": "kernels", "checks": recs})
    lap("3_kernels")

    total_launches = {}
    launches, (sink, job, secs) = run_path(
        lambda: north_star_job(dev, N_KEYS, EVENTS_PER_MS, TOTAL_EVENTS,
                               BATCH, RING_DEPTH), total_launches)
    want_count = numpy_reference(TOTAL_EVENTS, N_KEYS, EVENTS_PER_MS,
                                 WINDOW_MS)
    m = job.metrics
    emit({"phase": "e2e", "events": TOTAL_EVENTS, "seconds": secs,
          "events_per_s": TOTAL_EVENTS / secs, "drains": m.resident_drains,
          "fire_steps": m.fire_steps, "batches": m.steps,
          "count": sink.count, "count_ref": want_count,
          "value_sum": sink.value_sum, "launches": launches,
          "fire_latency_ms": fire_latency(m),
          "overflow_ring": "0 (set: no ring, so the fires reduce on the "
                           "card with G4, as in PRs 1-2)",
          "mode": "auto: the split path, the producer thread ahead",
          "device": kind, "nvidia_smi": smi})
    check(sink.value_sum == float(TOTAL_EVENTS),
          f"value_sum {sink.value_sum} != {TOTAL_EVENTS}")
    check(sink.count == want_count,
          f"count {sink.count} != numpy reference {want_count}")
    check(m.dropped_late == 0 and m.dropped_capacity == 0,
          f"dropped records: late {m.dropped_late}, capacity "
          f"{m.dropped_capacity}")
    for name in NORTH_STAR_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the north-star path")
    lap("4_e2e")
    mode_eps = part("21_ingest/modes", lambda: north_star_modes(
        dev, kind, smi, total_launches, want_count))
    plain_eps = mode_eps["on"]
    lap("21_ingest")

    launches, (sink, env_t, job, secs) = run_path(
        lambda: north_star_job(dev, N_KEYS, EVENTS_PER_MS, TOTAL_EVENTS,
                               BATCH, RING_DEPTH, config=TELEMETRY_CONFIG,
                               with_env=True), total_launches)
    check(sink.value_sum == float(TOTAL_EVENTS) and sink.count == want_count,
          f"telemetry run: {sink.count} rows summing to {sink.value_sum}")
    checked = check_telemetry(env_t, job, TOTAL_EVENTS, BATCH, EVENTS_PER_MS,
                              WINDOW_MS, N_KEYS, MAX_PARALLELISM)
    # in turns, both on the scan drain: without (the "on" mode's run),
    # with (the run above), with, without
    turns = {"without": [plain_eps], "with": [TOTAL_EVENTS / secs]}
    for name, cfg in (("with", TELEMETRY_CONFIG), ("without", RESIDENT_ON)):
        turns[name].append(TOTAL_EVENTS / north_star_job(
            dev, N_KEYS, EVENTS_PER_MS, TOTAL_EVENTS, BATCH, RING_DEPTH,
            config=cfg)[2])
    emit({"phase": "telemetry", "events": TOTAL_EVENTS, "seconds": secs,
          "events_per_s": TOTAL_EVENTS / secs,
          "events_per_s_without": plain_eps,
          "events_per_s_in_turns": turns, "config": TELEMETRY_CONFIG,
          "fire_latency_ms": fire_latency(job.metrics), **checked,
          "launches": launches, "device": kind, "nvidia_smi": smi})
    check_launched(launches, TELEMETRY_KERNELS, "telemetry")
    del sink, env_t, job
    lap("4_e2e")

    launches, (sink, job, secs) = run_path(
        lambda: sparse_job(dev, TOTAL_EVENTS, BATCH, RING_DEPTH),
        total_launches)
    cols = sink.columns()
    m = job.metrics
    emit({"phase": "sparse", "events": TOTAL_EVENTS, "seconds": secs,
          "events_per_s": TOTAL_EVENTS / secs, "layout": job.state.layout,
          "rows": len(cols.get("value", ())), "drains": m.resident_drains,
          "fire_steps": m.fire_steps, "batches": m.steps,
          "steps_fast": m.steps_fast, "spilled_records": m.spilled_records,
          "overflow_ring": job.state.ovf_hi.numel(),
          "fire_latency_ms": fire_latency(m),
          "launches": launches, "device": kind, "nvidia_smi": smi})
    check(job.state.layout == "hash",
          f"auto layout resolved to {job.state.layout}, not hash")
    check(m.dropped_late == 0 and m.dropped_capacity == 0,
          f"dropped records: late {m.dropped_late}, capacity "
          f"{m.dropped_capacity}")
    check(m.steps_fast > 0, "the sparse job never ran the fast step")
    check_sparse_rows(cols, TOTAL_EVENTS)
    for name in SPARSE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the sparse-key path")
    del sink, cols
    lap("5_sparse")

    launches, (sink, job, secs) = run_path(
        lambda: churn_job(dev, CHURN_TOTAL, BATCH, RING_DEPTH),
        total_launches)
    cols = sink.columns()
    m = job.metrics
    n_rows, distinct, live_max = check_churn_rows(cols, CHURN_TOTAL)
    emit({"phase": "churn", "events": CHURN_TOTAL, "seconds": secs,
          "events_per_s": CHURN_TOTAL / secs, "rows": n_rows,
          "distinct_ids": distinct, "live_ids_max": live_max,
          "capacity": CHURN_CAPACITY, "layout": job.state.layout,
          "overflow_ring": job.state.ovf_hi.numel(),
          "drains": m.resident_drains, "fire_steps": m.fire_steps,
          "steps": m.steps, "steps_fast": m.steps_fast,
          "ring_drains": m.ring_drains, "compactions": m.compactions,
          "spilled_records": m.spilled_records,
          "spill_peak_keys": m.spill_peak_keys,
          "dropped_capacity": m.dropped_capacity,
          "dropped_late": m.dropped_late,
          "fire_latency_ms": fire_latency(m),
          "launches": launches, "device": kind, "nvidia_smi": smi})
    check(job.state.layout == "hash" and
          job.state.ovf_hi.numel() == RING_LANES,
          "churn job: not the hash layout with the auto-sized ring")
    check(m.dropped_late == 0 and m.dropped_capacity == 0,
          f"churn job: dropped records: late {m.dropped_late}, capacity "
          f"{m.dropped_capacity}")
    check(live_max < 0.7 * CHURN_CAPACITY
          and distinct >= 1.5 * CHURN_CAPACITY,
          f"churn job: {live_max} live ids at most, {distinct} in all, "
          f"against {CHURN_CAPACITY} slots")
    check(m.compactions >= 2 and m.spilled_records > 0,
          f"churn job: {m.compactions} compactions, {m.spilled_records} "
          f"spilled records")
    for name in CHURN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the churn path")
    del sink, cols
    lap("6_churn")

    launches, (sink, job, secs) = run_path(
        lambda: sessions_job(dev, SESSION_TOTAL), total_launches)
    cols = sink.columns()
    m = job.metrics
    n_rows, closed_early = check_session_rows(cols, SESSION_TOTAL)
    depths = probe_depths(job.state.table_keys, KEYED_CAPACITY)
    emit({"phase": "session_table", **depths})
    emit({"phase": "sessions", "events": SESSION_TOTAL, "seconds": secs,
          "events_per_s": SESSION_TOTAL / secs, "rows": n_rows,
          "closed_by_watermark_before_end": closed_early,
          "steps": m.steps, "dropped_late": m.dropped_late,
          "dropped_capacity": m.dropped_capacity, "launches": launches,
          "device": kind, "nvidia_smi": smi})
    check(m.dropped_late == 0 and m.dropped_capacity == 0,
          f"sessions job: dropped records: late {m.dropped_late}, capacity "
          f"{m.dropped_capacity}")
    check_launched(launches, SESSION_KERNELS, "sessions")
    del sink, cols
    lap("7_sessions")

    ranks = all_word_ranks(WORD_TOTAL)
    launches, (sink, job, secs) = run_path(
        lambda: wordcount_job(dev, WORD_TOTAL), total_launches)
    m = job.metrics
    hot = check_wordcount_rows(sink.columns(), ranks)
    emit({"phase": "wordcount", "events": WORD_TOTAL, "seconds": secs,
          "events_per_s": WORD_TOTAL / secs, "rows": WORD_TOTAL,
          "hot_word_count": hot, "steps": m.steps,
          "dropped_capacity": m.dropped_capacity, "launches": launches,
          "device": kind, "nvidia_smi": smi})
    check(m.dropped_capacity == 0,
          f"wordcount job: {m.dropped_capacity} records dropped")
    check_launched(launches, WORDCOUNT_KERNELS, "wordcount")
    del sink
    lap("8_wordcount")

    launches, (sink, job, secs) = run_path(
        lambda: windowcount_job(dev, WORD_TOTAL), total_launches)
    m = job.metrics
    n_rows = check_windowcount_rows(sink.columns(), ranks)
    emit({"phase": "windowcount", "events": WORD_TOTAL, "seconds": secs,
          "events_per_s": WORD_TOTAL / secs, "rows": n_rows,
          "steps": m.steps, "dropped_capacity": m.dropped_capacity,
          "launches": launches, "device": kind, "nvidia_smi": smi})
    check(m.dropped_capacity == 0,
          f"windowcount job: {m.dropped_capacity} records dropped")
    check_launched(launches, WINDOWCOUNT_KERNELS, "windowcount")
    del sink, ranks
    lap("9_windowcount")

    launches, (sink, job, secs) = run_path(
        lambda: distinct_job(dev, BID_TOTAL), total_launches)
    m = job.metrics
    n_rows, med, n_err, rel = check_distinct_rows(sink.columns(), BID_TOTAL)
    depths = probe_depths(job.state.table_keys, SKETCH_CAPACITY,
                          SKETCH_PROBE_LEN)
    emit({"phase": "distinct_table", **depths})
    emit({"phase": "distinct", "events": BID_TOTAL, "seconds": secs,
          "events_per_s": BID_TOTAL / secs, "rows": n_rows,
          "median_rel_err_vs_exact": med, "windows_checked": n_err,
          "max_rel_err_vs_numpy_hll": rel, "layout": job.state.layout,
          "register_state_gb": job.state.acc.numel() * 4 / 1e9,
          "drains": m.resident_drains, "fire_steps": m.fire_steps,
          "batches": m.steps, "dropped_late": m.dropped_late,
          "dropped_capacity": m.dropped_capacity,
          "fire_latency_ms": fire_latency(m),
          "launches": launches,
          "device": kind, "nvidia_smi": smi})
    check(job.state.layout == "hash",
          f"distinct job: auto layout resolved to {job.state.layout}")
    check(m.dropped_late == 0 and m.dropped_capacity == 0,
          f"distinct job: dropped records: late {m.dropped_late}, capacity "
          f"{m.dropped_capacity}")
    check_launched(launches, SKETCH_KERNELS, "distinct")
    del sink, job
    lap("10_distinct")

    launches, (sink, job, secs) = run_path(
        lambda: countmin_job(dev, BID_TOTAL), total_launches)
    m = job.metrics
    n_rows, hot_est, hot_exact = check_countmin_rows(sink.columns(),
                                                     BID_TOTAL)
    emit({"phase": "countmin", "events": BID_TOTAL, "seconds": secs,
          "events_per_s": BID_TOTAL / secs, "rows": n_rows,
          "hot_channel_item1_estimate": hot_est,
          "hot_channel_item1_exact": hot_exact, "layout": job.state.layout,
          "register_state_gb": job.state.acc.numel() * 4 / 1e9,
          "drains": m.resident_drains, "fire_steps": m.fire_steps,
          "batches": m.steps, "dropped_late": m.dropped_late,
          "dropped_capacity": m.dropped_capacity,
          "fire_latency_ms": fire_latency(m),
          "launches": launches,
          "device": kind, "nvidia_smi": smi})
    check(job.state.layout == "hash",
          f"countmin job: auto layout resolved to {job.state.layout}")
    check(m.dropped_late == 0 and m.dropped_capacity == 0,
          f"countmin job: dropped records: late {m.dropped_late}, capacity "
          f"{m.dropped_capacity}")
    check_launched(launches, SKETCH_KERNELS, "countmin")
    del sink, job
    lap("11_countmin")

    launches, (sink, job, secs) = run_path(
        lambda: maxprice_job(dev, REDUCE_TOTAL), total_launches)
    m = job.metrics
    n_rows = check_maxprice_rows(sink.columns(), REDUCE_TOTAL)
    emit({"phase": "maxprice", "events": REDUCE_TOTAL, "seconds": secs,
          "events_per_s": REDUCE_TOTAL / secs, "rows": n_rows,
          "layout": job.state.layout, "drains": m.resident_drains,
          "fire_steps": m.fire_steps, "batches": m.steps,
          "steps_fast": m.steps_fast, "spilled_records": m.spilled_records,
          "dropped_late": m.dropped_late,
          "dropped_capacity": m.dropped_capacity,
          "fire_latency_ms": fire_latency(m),
          "launches": launches,
          "device": kind, "nvidia_smi": smi})
    check(job.state.layout == "hash",
          f"maxprice job: auto layout resolved to {job.state.layout}")
    check(m.dropped_late == 0 and m.dropped_capacity == 0,
          f"maxprice job: dropped records: late {m.dropped_late}, "
          f"capacity {m.dropped_capacity}")
    check_launched(launches, MAXPRICE_KERNELS, "maxprice")
    del sink, job
    lap("12_maxprice")

    launches, (sink, job, secs) = run_path(
        lambda: mean_job(dev, REDUCE_TOTAL), total_launches)
    m = job.metrics
    n_rows, rel = check_mean_rows(sink.columns(), REDUCE_TOTAL)
    emit({"phase": "mean", "events": REDUCE_TOTAL, "seconds": secs,
          "events_per_s": REDUCE_TOTAL / secs, "rows": n_rows,
          "max_rel_err_vs_numpy_float64": rel, "layout": job.state.layout,
          "plane_mb": job.state.acc.numel() * 4 / 1e6,
          "drains": m.resident_drains, "fire_steps": m.fire_steps,
          "batches": m.steps, "dropped_late": m.dropped_late,
          "dropped_capacity": m.dropped_capacity,
          "fire_latency_ms": fire_latency(m),
          "launches": launches,
          "device": kind, "nvidia_smi": smi})
    check(job.state.layout == "direct" and job.state.acc.shape[1] == 3,
          "mean job: not the direct layout's [C*R, 3] plane")
    check(m.dropped_late == 0 and m.dropped_capacity == 0,
          f"mean job: dropped records: late {m.dropped_late}, capacity "
          f"{m.dropped_capacity}")
    check_launched(launches, MEAN_KERNELS, "mean")
    del sink, job
    lap("13_mean")

    launches, (sink, job, secs) = run_path(
        lambda: late_job(dev, REDUCE_TOTAL), total_launches)
    m = job.metrics
    n_rows, n_refired, n_refire_rows = check_late_rows(
        sink.columns(), REDUCE_TOTAL, m.dropped_late)
    emit({"phase": "late_reduce", "events": REDUCE_TOTAL, "seconds": secs,
          "events_per_s": REDUCE_TOTAL / secs, "rows": n_rows,
          "windows_refired": n_refired, "refire_rows": n_refire_rows,
          "dropped_late": m.dropped_late, "layout": job.state.layout,
          "drains": m.resident_drains, "fire_steps": m.fire_steps,
          "batches": m.steps, "dropped_capacity": m.dropped_capacity,
          "fire_latency_ms": fire_latency(m),
          "launches": launches, "device": kind, "nvidia_smi": smi})
    check(job.state.layout == "hash",
          f"late-reduce job: auto layout resolved to {job.state.layout}")
    check(m.dropped_capacity == 0 and m.dropped_late > 0
          and n_refire_rows > 0,
          f"late-reduce job: capacity drops {m.dropped_capacity}, late "
          f"drops {m.dropped_late}, re-fire rows {n_refire_rows}")
    check_launched(launches, LATE_KERNELS, "late-reduce")
    del sink, job
    lap("14_late_reduce")

    events, names, keys = cep_events(CEP_TOTAL)
    want = cep_reference(names, keys)
    launches, (sink, job, secs) = run_path(lambda: cep_job(dev, events),
                                           total_launches)
    m = job.metrics
    emit({"phase": "cep", "events": CEP_TOTAL, "seconds": secs,
          "events_per_s": CEP_TOTAL / secs, "matches": sink.count,
          "matches_numpy": want, "engine": m.cep_engine,
          "device_steps": m.cep_device_steps,
          "matches_detected": m.cep_matches_detected,
          "matches_extracted": m.cep_matches_extracted,
          "dropped_capacity": m.dropped_capacity, "launches": launches,
          "device": kind, "nvidia_smi": smi})
    check(m.cep_engine == "device" and m.cep_device_steps > 0,
          "cep job: the device path was not taken")
    check(sink.count == want == m.cep_matches_detected
          == m.cep_matches_extracted,
          f"cep job: {sink.count} matches, numpy {want}, detected "
          f"{m.cep_matches_detected}, extracted {m.cep_matches_extracted}")
    check(m.dropped_capacity == 0,
          f"cep job: {m.dropped_capacity} records dropped")
    check_launched(launches, CEP_KERNELS, "cep")
    del sink, job, events, names, keys
    lap("15_cep")

    launches, (sink, job, secs) = run_path(
        lambda: cepw_job(dev, CEPW_TOTAL), total_launches)
    m = job.metrics
    cols = cepw_columns(CEPW_TOTAL)
    pane_ms = DevicePatternSpec.from_pattern(cepw_pattern()).pane_ms
    n_rows, want, keys_matched, sample_rows = check_cepw_rows(
        sink.results, cols, pane_ms, CEPW_SEED)
    emit({"phase": "cep_within", "events": CEPW_TOTAL, "seconds": secs,
          "events_per_s": CEPW_TOTAL / secs, "rows": n_rows,
          "rows_numpy": want, "sampled_keys": CEPW_SAMPLE,
          "sampled_keys_with_matches": keys_matched,
          "sampled_rows": sample_rows, "seed": CEPW_SEED,
          "pane_ms": pane_ms, "device_steps": m.cep_device_steps,
          "matches_detected": m.cep_matches_detected,
          "matches_extracted": m.cep_matches_extracted,
          "dropped_capacity": m.dropped_capacity,
          "carry_mb": job.state.carry.numel() * 4 / 1e6,
          "table_mb": job.state.table.numel() * 8 / 1e6,
          "launches": launches, "device": kind, "nvidia_smi": smi})
    check(m.dropped_capacity == 0,
          f"cep-within job: {m.dropped_capacity} records dropped")
    check(m.cep_matches_detected == m.cep_matches_extracted == n_rows,
          f"cep-within job: detected {m.cep_matches_detected}, extracted "
          f"{m.cep_matches_extracted}, rows {n_rows}")
    check(sample_rows > 0, "cep-within job: no sampled key matched")
    check_launched(launches, CEPW_KERNELS, "cep-within")
    del sink, job, cols
    lap("16_cep_within")

    want5, stage0_rows = chained_reference(TOTAL_EVENTS)
    for name, run, kernels_of in (
            ("chained", lambda: chained_job(dev, TOTAL_EVENTS),
             CHAIN_KERNELS),
            ("chained_stats", lambda: chained_job(
                dev, TOTAL_EVENTS, config=CHAIN_STATS_CONFIG),
             CHAIN_STATS_KERNELS),
            ("chained_sparse", lambda: chained_job(dev, TOTAL_EVENTS,
                                                   sparse=True),
             CHAIN_SPARSE_KERNELS)):
        launches, (sink, env_c, job, secs) = run_path(run, total_launches)
        m = job.metrics
        sparse = name == "chained_sparse"
        n_rows = check_chained_rows(sink.columns(), want5, sparse=sparse)
        line = {"phase": name, "events": TOTAL_EVENTS, "seconds": secs,
                "events_per_s": TOTAL_EVENTS / secs, "rows": n_rows,
                "stage0_rows_numpy": stage0_rows,
                "layout": job.state.layout, **chain_metrics(m),
                "launches": launches, "device": kind, "nvidia_smi": smi}
        if name == "chained_stats":
            line.update(check_chain_stats(env_c, job, stage0_rows))
        emit(line)
        check(m.dropped_late == 0 and m.dropped_capacity == 0,
              f"{name} job: dropped records: late {m.dropped_late}, "
              f"capacity {m.dropped_capacity}")
        check(job.state.layout == ("hash" if sparse else "direct"),
              f"{name} job: layout {job.state.layout}")
        check_launched(launches, kernels_of, name)
        if sparse:
            # G5 in both stages: stage 0 once a slot (the batches and one
            # empty slot a flush drain), stage 1 once a drain
            want_g5 = m.steps + m.chain_flush_drains + m.resident_drains
            check(launches["hash_upsert"] == want_g5,
                  f"chained-sparse job: {launches['hash_upsert']} G5 "
                  f"launches, the two stages' {want_g5}")
        del sink, env_c, job
        lap("18_chained_sparse" if sparse else "17_chained")

    checkpoint_runs(dev, kind, smi, total_launches, TOTAL_EVENTS)
    lap("19_checkpoint")
    tiered_runs(dev, kind, smi, total_launches, TIER_TOTAL)
    lap("20_tiered")
    part("21_ingest/ingest_runs", lambda: ingest_runs(
        dev, kind, smi, total_launches))
    part("21_ingest/while_drain_mirror", lambda: while_drain_mirror(
        dev, kind, smi, total_launches))
    part("21_ingest/ring_race", lambda: ring_race(dev, kind, smi))
    lap("21_ingest")
    emit({"phase": "megastep_kernels", "K": MEGA_K,
          "checks": part("22_megastep/kernels",
                         lambda: mega_kernel_phase(dev))})
    part("22_megastep/runs", lambda: megastep_runs(
        dev, kind, smi, total_launches, want_count))
    part("22_megastep/controller", lambda: controller_runs(
        dev, kind, smi, total_launches, want_count))
    part("22_megastep/fire_grid", lambda: fire_grid(
        dev, kind, smi, total_launches))
    lap("22_megastep")
    library_runs(dev, kind, smi, total_launches)
    lap("23_libraries")
    sharded_runs(dev, kind, smi, total_launches, want_count)
    lap("24_sharded")
    sharded_keyed_runs(dev, kind, smi, total_launches)
    lap("25_sharded_keyed")
    dcn_runs(dev, kind, smi, total_launches)
    lap("26_dcn")

    if "--profile" in argv:
        emit(profile_phase(
            dev, "north_star", gen_batch,
            lambda: north_star_job(dev, N_KEYS, EVENTS_PER_MS, TOTAL_EVENTS,
                                   BATCH, RING_DEPTH)))
        emit(profile_phase(
            dev, "sparse", sparse_gen,
            lambda: sparse_job(dev, TOTAL_EVENTS, BATCH, RING_DEPTH)))
        emit(profile_phase(
            dev, "churn", churn_gen,
            lambda: churn_job(dev, CHURN_TOTAL, BATCH, RING_DEPTH),
            CHURN_TOTAL))
        emit(profile_phase(dev, "sessions", session_gen,
                           lambda: sessions_job(dev, SESSION_TOTAL),
                           SESSION_TOTAL))
        emit(profile_phase(dev, "wordcount", word_gen,
                           lambda: wordcount_job(dev, WORD_TOTAL),
                           WORD_TOTAL))
        emit(profile_phase(dev, "windowcount", word_gen,
                           lambda: windowcount_job(dev, WORD_TOTAL),
                           WORD_TOTAL))
        emit(profile_phase(dev, "distinct", bid_gen("bidder"),
                           lambda: distinct_job(dev, BID_TOTAL), BID_TOTAL))
        emit(profile_phase(dev, "countmin", bid_gen("auction"),
                           lambda: countmin_job(dev, BID_TOTAL), BID_TOTAL))
        for name, gen, job_fn in (("maxprice", maxprice_gen, maxprice_job),
                                  ("mean", mean_gen, mean_job),
                                  ("late_reduce", late_gen, late_job)):
            emit(profile_phase(dev, name, gen,
                               lambda f=job_fn: f(dev, REDUCE_TOTAL),
                               REDUCE_TOTAL))
        events = cep_events(CEP_TOTAL)[0]
        emit(profile_phase(dev, "cep", None, lambda: cep_job(dev, events),
                           CEP_TOTAL, CEP_HOST_FUNCTIONS))
        del events
        emit(profile_phase(dev, "cep_within", cepw_gen,
                           lambda: cepw_job(dev, CEPW_TOTAL), CEPW_TOTAL,
                           CEP_HOST_FUNCTIONS))
        for name, sparse in (("chained", False), ("chained_sparse", True)):
            emit(profile_phase(
                dev, name, sparse_gen if sparse else gen_batch,
                lambda s=sparse: _no_env(chained_job(dev, TOTAL_EVENTS,
                                                     sparse=s)),
                cumulative=CHAIN_HOST_FUNCTIONS))
        with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as tmp:
            emit(profile_phase(
                dev, "checkpoint", gen_batch,
                lambda: ckpt_job(dev, TOTAL_EVENTS, ckpt_dir=tmp),
                cumulative=CKPT_HOST_FUNCTIONS))
        emit(profile_phase(
            dev, "tiered", tier_gen,
            lambda: _no_env(tier_job(dev, TIER_TOTAL, TIER_BUDGET)),
            TIER_TOTAL, TIER_HOST_FUNCTIONS))
        lap("profile")
    emit({"phase": "phase_seconds", "seconds": PHASE_S, "parts": PARTS_S,
          "total": sum(PHASE_S.values())})
    line = [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
        "replaces": KERNEL_SOURCES[name][1],
        "launches": total_launches[name],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": r["library_ms"],
        **({"quiet_ms": r["quiet_ms"],
            "yardstick_ms": r["read_sum_ms"],
            "yardstick": "a part only: one Tensor.sum over the due row's "
                         "[C, 2] plane"} if name == "fire_reduced" else {}),
        **({k: r[k] for k in ("sector_bound_ms", "sector_read_bound_ms",
                              "all_stale_ms", "all_stale_library_ms")}
           if name == "cep_expire" else {}),
    } for name, r in recs.items()]
    fill = recs["route_lanes"]["kg_fill"]
    line[0]["kg_fill"] = {
        "replaces": KG_FILL_REPLACES,
        "launches": total_launches["route_lanes_fill"],
        **{k: fill[k] for k in ("max_abs_err", "ms", "nofill_ms", "plain_ms",
                                "bound_ms", "library_ms")}}
    res = recs["route_lanes"]["kg_res"]
    line[0]["kg_res"] = {
        "replaces": KG_RES_REPLACES,
        "launches": total_launches["route_lanes_res"],
        **{k: res[k] for k in ("max_abs_err", "ms", "nores_ms", "all_ms",
                               "none_ms", "plain_ms", "bound_ms",
                               "library_ms")}}
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
