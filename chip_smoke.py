"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py [--accounts N] [--slots N] [--rebuild-accounts N] [--rebuild-slots N]
                          [--state-accounts N] [--state-slots N]
                          [--sync-accounts N] [--sync-slots N]

1. Builds every native source of the port from this checkout (the two CUDA
   kernel libraries with nvcc, the trie sweep, the secp256k1 batch and the
   native executor with g++, all at once), and prints ptxas's registers,
   stack frame and spills
   per kernel function; a
   stack frame or a spill in keccak256_absorb, a level kernel or
   subtrie_levels fails the run, and so does a non-coherent (.CONSTANT)
   128-bit load, a digest load, in subtrie_levels' SASS. The bound's
   integer instructions per permutation are counted on the SASS of kernel
   1's first design, the debug entry keccak256_absorb_unstaged.
2. Kernel checks: each of the four kernels against its plain PyTorch
   version on the card, bit for bit (tolerance zero): keccak256_absorb on
   65,536 random messages of 0-600 bytes plus the 135/136-byte edges, also
   against keccak256_absorb_unstaged (the two timed in turns, beside the
   plain version, bound and floor); packed_level and branch_level on
   the edge levels of tests/_torch_helpers.py (every row alignment, holes
   across rate-block edges, rows of up to 15 rate blocks, every branch
   popcount, launches of 1-257 rows) and on the largest PACKED and BITMAP
   level of a one-shot triebuild sweep of the account trie; subtrie_levels
   on chunks (k = 1, 2, 8) of those edge levels chained so that each reads
   the digests of the one before, at k = 8 with a last level of more rows
   than one pass of the co-resident grid, and on chunks around its path
   split (tests/_torch_helpers.py threshold_chain: steps of 1, 15, 16, 17
   rows, at the card's five-lane limit and one past it, narrow steps after
   a wide one). One keccak-f[1600] is then timed in isolation by one
   thread and by a five-lane group (a debug entry of fused_level.cu), the
   two final states held equal.
   Before the kernel checks, the device supervisor's startup (the
   reference's --hasher auto): a DeviceSupervisor runs its real probe, a
   child process that loads kernel 1 and hashes keccak256(b"") on the card;
   the run fails unless it is ok and the breaker closed. Its latency is
   logged.
   Beside them and the main paths, on a thread of its own started before
   the supervisor's startup and joined before step 5, warm-up cold and warm
   (ops/warmup.py): build_warmup(
   supervisor=, cache_dir=<a fresh directory>) over default_menu() in a
   fresh child process (nothing loaded yet): every shape WARM, misses equal
   to the shapes, nvcc run once per kernel source into the versioned cache,
   the cache enabled after its probe child; then a second child on the same
   directory: hits equal to the shapes and no nvcc run. Each shape's wall
   and kernel launches are logged. Then the cache probe child alone, and the
   drill of a truncated library: a third child quarantines the directory
   and rebuilds it.
   Right after the build, the MerkleStage cell's CPU twin starts in a child
   process of its own (chip_smoke.py --merkle-twin, merkle_twin), beside
   everything below until the cell needs it: plain_state(--accounts,
   --slots) in a port MemDb, the two hashing stages and
   full_state_root_turbo(backend="numpy") on TrieCommitter(
   hasher=keccak256_batch_np, device="cpu") (header 1's root), each block's
   writes, hashing stages and MerkleStage._incremental (the block's root and
   tables), and block 3's state rebuilt single-shot again (its root and
   tables must be the incremental route's).
3. Slice phase, thirty-three main paths, the launch counters zeroed just before
   each and read just after (and every watchdog thread joined first):
   "default", the full-state rebuild (at --rebuild-accounts /
   --rebuild-slots, 250,000 / 100,000, cut from the 1,000,000 / 400,000 the
   MerkleStage cell keeps) through
   TurboCommitter.commit_hashed_pipelined (storage tries, then the account
   trie as 256 two-nibble prefix subtries at start_depth=2, both collecting
   branch nodes) on the default engine, MegaFusedEngine; "k=8", the same
   rebuild through TurboCommitter(subtrie_levels=8), SubtrieFusedEngine;
   "auto" and "auto k=8", the same two rebuilds through
   TurboCommitter(backend="auto", supervisor=...) (SupervisedBackend: every
   engine call under the watchdog, journaled); "state_root auto", the
   state_root() below through TrieCommitter(supervisor=...) (SupervisedHasher
   over KeccakDevice: kernel 1 only). The supervised paths must end with 0
   failovers, 0 watchdog timeouts, 0 errors, 0 k-level fallbacks, a closed
   breaker, every commit hashed by the device (k=8: on the fused rung); their
   walls are logged beside their unsupervised twins' (state_root auto's twin
   runs outside the main paths), with the guarded calls (watchdog threads
   started) and the journal's entries and bytes at its peak per commit;
   "state_root", a whole-state state_root() through TrieCommitter(fused=True,
   hasher=KeccakDevice(...)), held against the per-level numpy committer,
   whose key hashing launches keccak256_absorb and whose template levels
   launch packed_level (kernel 1 may be launched by KeccakDevice only).
   Every rebuild's roots and branch nodes are held against one
   backend="numpy" rebuild, and each rebuild commit's pipeline stage times
   (sweep, pack, dispatch, fetch), windows and queue peak are logged. Then
   the sparse live-tip finish on bench.py's sparse generator (1,024
   storage tries x 64 slots and their accounts): the clean state is hashed
   once on each path outside the main paths (the whole-trie check), then
   "sparse", SPARSE_BLOCKS (5) blocks each of a fresh seeded dirty set (4
   slot writes and 1 delete per trie, every 16th trie wiped, every account
   leaf rewritten) finished by ParallelSparseCommitter's classic path
   (kernel 1, launched by KeccakDevice only), and "sparse k=8", the same
   blocks on a second copy of the state through subtrie_levels=8 (kernel
   4, SubtrieFusedEngine), and "sparse arena", the same blocks on a third
   copy through ParallelSparseCommitter(arena=DigestArena()): the hot-state
   plane's delta finish, kernel 4 on one engine whose digest buffer stays on
   the card across blocks (the baseline is its full epoch, each block a
   delta epoch that splices rows earlier epochs wrote; it must end with
   SPARSE_BLOCKS delta epochs, resident hits, and after every epoch no
   fault, no leaked row and no pinned staging; its finish wall, launches,
   staged rows, bytes staged, resident rows, buffer growths and pinned
   bytes are logged beside "sparse k=8"'s, block by block); every root and
   the account trie's stored branch updates (export_branch_updates) are
   held against a fourth copy finished on the CPU with the numpy hasher.
   Then "hot tip": one account trie of HOT_ACCOUNTS (262,144) seeded keys,
   two sibling forks imported interleaved, HOT_BLOCKS (2) blocks a fork of
   2,048 writes (half of them keys of the fork's previous block) and 128
   deletes; each block starts from a blind SparseTrie at its fork's root
   with reveal stamping, reveals its keys through a shared TrieNodeCache
   (reveal_through) and otherwise by a "proof fetch" from the fork's fully
   revealed CPU twin (node_at + reveal_at), commits through an arena on the
   card, is held against the twin's root, and is absorbed into the cache
   (invalidate_key + harvest). Its cold lineage (no cache, no arena, no
   stamping: subtrie_levels=8 on the card) runs the same stream before the
   main paths; each block's root must equal on both lineages, and both
   lineages' proof fetches, cache hits / misses / entries, stamped rows,
   delta fraction, bytes staged and walls are logged per block. Each
   finish is timed (median of the blocks). Then the control plane:
   "state_root degraded", the state_root() above through
   TrieCommitter(supervisor=, warmup=) while a warm-up manager started in
   the background is held at the menu's first shape (every bucket hashed on
   the host, cpu_routed > 0, no launch), and, once the manager is released
   and warm (outside the main paths), "state_root warming", the same run
   again (cpu_routed unchanged, every bucket through kernel 1), both held
   against numpy's root and branch nodes; "service", bench.py's service
   workload (8 clients x 300 requests x 4 keys of 64 bytes, seed 7, lanes
   round-robin) through HashService(backend=KeccakDevice(1024,
   block_tier=4).hash_batch), after the same requests per call outside the
   main paths (every digest equal to numpy's, no replay, fewer kernel-1
   launches than requests; both walls, the coalesce factor, the dispatches,
   the round trips and each lane's wait logged); "sparse service" and
   "sparse service k=8", the sparse cell's blocks on two more copies of its
   state with the service's live-lane client as the hasher (encode chunks
   streamed through submit, kernel 1 on the dispatcher thread; the fused
   window through commit_window, kernel 4 there), held against the twin like
   the other sparse paths; "rebuild leased", the full rebuild through
   TurboCommitter(hash_service=) on the default engine while a thread keeps
   submitting live-lane requests (leases equal to the commits, no replay,
   roots and branch nodes equal to the numpy twin's; the lease bypasses and
   the live lane's waits logged). Then the rebuilds' numpy twin (outside the
   paths), "sync", "recovery", the engine and the payload paths below, and
   only after them the MerkleStage cell (MerkleCell), whose twin child
   finishes last:
   plain_state(--accounts, --slots) = 1,000,000 addresses, 400,000 slots
   over 100,000 owners, loaded into a port MemDb with headers 0 and 1 (the
   twin's root); "merkle stage", Pipeline(factory, [MerkleUnwindStage(c),
   AccountHashingStage(c), StorageHashingStage(c), MerkleStage(c)]).run(1)
   with c = TrieCommitter(device="cuda"): the hashing stages' clean scans
   (kernel 1 through KeccakDevice, one batch a 200,000-key scan chunk) and
   the chunked rebuild at chunk_leaves 500,000 (the storage chunk, two
   account chunks, the stitch; kernels 2 and 3 through the stage's
   TurboCommitter on "device", kernel 1 for the stitch), each stage's and
   each MerkleStage iteration's wall and kind, each commit's stage times,
   the hashing stages' keys/s and hashed nodes/s logged; it must end with
   every row of HashedAccounts, HashedStorages, AccountsTrie and
   StoragesTrie equal to the twin's (compared by row counts and SHA-256 of
   the rows in key order), the four checkpoints 1, the progress blob
   cleared and 0 fallbacks; then "merkle incremental", blocks 2 and 3
   (STAGE_BLOCK writes with their changesets and headers, each block's
   writes timed apart) through Pipeline.run(2), run(3) (the incremental
   route, kernel 1 only) and Pipeline.unwind(1), the four tables after each
   step equal to the twin's at that block (block 1's after the unwind).
   Then the live tip on the same database (LiveTip): blocks 2 and 3 as
   BlockExecutionOutputs of the cell's own writes, each block's keys
   streamed through SparseRootTask.on_state_update in LIVE_BURSTS (256)
   seeded bursts, proved on a ProofWorkerPool (sparse_worker_count workers,
   a fresh read view of the parent's published tables each: block 1 for
   block 2, the incremental route's block 2 for block 3), revealed and
   finished: "live tip", block 2 cold with a TrieNodeCache and a
   DigestArena (kernels 1 and 4), preserved and absorbed; "live tip
   cached", block 3 anchored cold on a fresh preserved trie, unblinding
   from path 1's cache (cache_unblinds > 0), a fresh arena; "live tip
   reused", block 3 on path 1's preserved trie (reused), cache and arena,
   absorbed; "live tip service", block 3 cold through a HashService set up
   as the reference's node sets it up (the committer's KeccakDevice as its
   backend, its hasher the live lane's client), the classic finish, kernel
   1 on the dispatcher (the live and proof lanes both move, no replay, and
   "live tip cached" asks fewer proof targets); "proofs", a
   ProofWorkerPool of 4 over block 1 answering 1,024 seeded targets (768
   existing accounts, 256 of them storage owners with all their slots and
   an absent slot each; 256 absent addresses), every proof verified against
   header 1's root and the first 64 byte-identical to a host
   ProofCalculator's (numpy hasher). Each block's root must be its header's
   (the twin's), its exported branch updates written back onto the
   parent's tables must leave AccountsTrie and StoragesTrie equal to the
   incremental route's after the block, its storage roots HashedAccounts';
   a SparseRootError fails the run and logs its cause; path 1's arena ends
   with no fault, no leaked row and no pinned staging. Each block's walls
   (hash, proof, reveal, finish, worker busy), proof targets, cache
   unblinds, proof shards, finish retries, proof batches and launches are
   logged.
   "sync" (SyncCell), the staged sync of a chain sealed on the host:
   right after the build, beside the merkle twin, a second child process
   (chip_smoke.py --sync-chain, sync_chain) builds tests/_torch_helpers.py
   SyncChain on the port: plain_state(--sync-accounts, --sync-slots, 47) =
   250,000 accounts and 100,000 slots (cut from the MerkleStage cell's
   1,000,000 / 400,000: the child roots the whole state on the host at
   every block), 1,024 wallets, an ERC-20-shaped token holding every wallet,
   a storage writer and a precompile caller; then 8 blocks of SYNC_BLOCK at
   a 30,000,000 gas limit (100 ETH transfers of types 0, 1 and 2, 40 to new
   addresses; 100 token transfers, 25 to new holders; 30 writer calls of 4
   slot writes and 1 zeroed; 12 calls of precompiles 0x01, 0x02, 0x05, 0x06,
   0x07, 0x09; 2 CREATEs of a 6,000-byte contract; 1 type-4 transaction; 16
   withdrawals: 245 transactions, about 12.4 Mgas), each sealed by
   executing it and rooting the state on the numpy twin. On the card:
   init_genesis (device="cuda"), import_chain with
   EthBeaconConsensus(device="cuda"), Pipeline(factory,
   default_stages(device="cuda")).run(8), unwind(4), one block's execution
   under cProfile (block 5 on the unwound state, read-only), run(8) again
   under torch.profiler (busy time, idle share). MerkleStage and the Merkle
   unwind validate headers 8 and 4 (the child's roots); after the re-sync
   every non-empty table equals the first sync's row for row, every
   checkpoint is 8, every recovered sender is the signing wallet's and
   MerkleStage made 0 fallbacks. Each step's and each stage's wall,
   senders/s, the Execution stage's Mgas/s and transactions/s and the
   rebuild's hashed nodes/s are logged.
   Then "recovery" (RecoveryCell), startup recovery over datadirs made
   from the sync's database at block 8 (under reth_tpu_torch/build/, removed
   after), every committer on the card: a) the tables as a MemDb image with
   a WAL (attach_wal), StaticFileProducer.run(to_block=3) and one
   checkpoint; the engine tree's unwind crash window (the marker for 4,
   Pipeline(factory, default_stages(device="cuda")).unwind(4) through the
   WAL, no canonical surgery); a byte of the receipts jar flipped and an
   orphan *.tmp left; reopened (MemDb, attach_wal replaying) and
   recover_on_startup(committer=TrieCommitter(fused=True, device="cuda"),
   static_dir=): "degraded" with "completed interrupted unwind 8 -> 4",
   head 4, root verified, the marker cleared, the receipts jar quarantined
   and the orphan removed, the transactions jar verified and serving blocks
   1-3's transactions, the state and trie tables (ENGINE_TABLES) equal to the
   sync's after its unwind to 4, the header tables ending at 4, 0 fallbacks;
   b) a bad-CRC record rewriting one HashedAccounts row
   (chaos.inject_bad_crc_record): with RETH_TPU_FAULT_WAL_ACCEPT_TORN=1 for
   that reopen recovery must fail on a state-root mismatch; injected again,
   the correct reader discards it (torn bytes > 0, every table leg a's;
   verify_root=False); c) leg a's tables copied into a PagedDb (the node's
   default engine) with the headers of blocks 5-8 put back and every stage
   at 4: recover_on_startup (verify_root=False: its root check is the
   second cut of the time limit, these tables are held to leg a's, whose
   root was checked) completes the unwind and leaves the tables leg a's,
   walked once, after the store is closed and reopened.
   Kernels 1 (the unwind) and 2 (the root checks' levels). Each leg's wall,
   report, launches and host memory are logged.
   Then the engine tree (EngineCell) on that chain, each variant from a
   MemDb restored from the sync path's table map right after its
   init_genesis: EngineTree(factory, TrieCommitter(device="cuda"),
   EthBeaconConsensus(committer, device="cuda"), EvmConfig(),
   persistence_threshold=2, device="cuda"), on_new_payload then
   on_forkchoice_updated for each of its blocks, then one more fcU with a
   threshold of 0: "engine", every block of the chain, the sparse strategy with hot state
   (kernel 1: consensus roots, key hashing, proofs, reveals; kernel 4: the
   arena's delta finish); "engine parallel", the same with the optimistic
   scheduler on the native core (csrc/evmexec.cpp, g++) and the two-deep
   import pipeline (payload N+1 sent from a second thread once N is in its
   root phase, block_pipeline.import_chain); "engine pipelined",
   PipelinedStateRoot and IncrementalStateRoot (kernel 1 only); the last two
   cut to blocks 1-4 (ENGINE_CUT) for the smoke's room. Each
   status must be VALID at its header's hash and root (the child's seal),
   each sparse root "sparse" (0 fallbacks), "engine parallel" must take
   native ranks in every block and adopt a speculation with none aborted,
   no prehash batch may fail, the arena must end with no fault, leaked row
   or pinned staging, and persisted to its last block the plain, hashed and
   trie tables and Bytecodes must equal the sync's row for row: the first
   sync's at block 8, the unwound sync's at block 4 on the cut variants (whose
   Bytecodes need only be among the unwound ones: the unwind keeps later
   blocks' codes). Each
   block's newPayload wall by the tree's phases (from its block timeline),
   the sparse task's walls, overlap, proof targets and finish retries, the
   optimistic scheduler's ranks, launches (on "engine parallel", whose
   blocks overlap, those of each block's window: from the previous
   newPayload's return to its own), the fcU and persistence walls and the
   import's Mgas/s are logged. Its drills run after the profiled
   runs of step 4 (each counts an arena fault, which the main paths may
   not): a) RETH_TPU_FAULT_SPARSE_ABORT=1 on block 1 falls back to the
   incremental committer, VALID at the header's root; b) a launch fault in
   the arena's delta finish on block 2 raises out of on_new_payload (a
   LaunchError cause, one arena fault, no fallback).
   Then block production and stateless validation (PayloadCell) on the
   "engine" path's tree, blocks 1-8 persisted: the sync child also signs
   PAYLOAD_BATCHES (3) more SYNC_BLOCK batches from the same wallets at their
   next nonces, unsealed, the three transactions the pool must refuse
   (REFUSED: a nonce too low, an underpriced replacement, chain id 5) and a
   drill transaction. "payload": before each build a batch is admitted
   through TxBatcher into TransactionPool(PoolConfig(chain_id=1)) over the
   tree's overlay (245 admitted; before block 9 the three refused with the
   pool's messages); block 9 by LocalMiner(tree, pool).mine_block (the
   dev-mode serial build), block 10 by PayloadBuilderService.new_payload_job
   + get_payload_with_fees, on_new_payload and on_forkchoice_updated, block
   11 by a started BlockProducer's take() after prepare(), which must equal
   one serial build_payload over a clone of the same pool. Each block must
   be VALID on import (the sparse strategy, a route apart from the
   builder's incremental root), select all 245 of its batch, carry
   transactions / receipts / withdrawals roots equal to the host's numpy
   ordered_trie_root, leave the pool empty after its canonical update, with
   0 catch-all and 0 sparse fallbacks. The tree keeps blocks 9-11 in memory
   (persistence threshold 3). "stateless": each block's witness by
   generate_witness against its parent's overlay (provider_factory=, 4 proof
   workers, the tree's committer: kernel 1 on the proof lane), then one
   StatelessChain(config, device="cuda") validates 9, 10 and 11 in order from
   the witnesses alone (kernel 1; 10 and 11 on the preserved trie): each
   root and gas the header's, each witness equal to itself through its JSON.
   Each block's admission, build (selection and execution, state root,
   ordered roots), import, witness (execution, multiproof, node hashing,
   closure and its rounds, nodes, codes, keys, headers, bytes) and
   stateless (reveal, execution, root) walls are logged. After the engine's
   drills: block 11 built again on block 10 and block 10's witness, each
   under torch.profiler (idle share); then drills a) a witness without its
   parent's account-trie root node raises "witness incomplete", b) a header
   with another state root raises "stateless root mismatch", c) a launch
   fault of kernel 1 (check_launch of a CUDA error) raises out of
   mine_block and out of PayloadJob, the head and the pool unchanged; then
   the tree persists blocks 9-12 (12 is the "rpc" path's).
   Then the JSON-RPC surface (RpcCell, path "rpc") on that tree at block 11,
   blocks 9-11 still in memory (its persistence threshold 4 from here on):
   two RpcServers on 127.0.0.1, port 0, wired as the JAX package's
   node/node.py:504-547 wires them and sharing one lock (public: eth, debug,
   net, web3, txpool, otterscan, flashbots, miner; auth: engine and eth,
   with a JWT secret from load_or_create_secret under
   reth_tpu_torch/build/rpc-<pid>, removed after), over a TransactionPool
   with its TxBatcher and a PayloadBuilderService; every call over HTTP.
   a) one JSON-RPC batch of 1,024 eth_getProof at "latest" from RPC_SEED:
   1,000 genesis accounts with 0-4 of their own slots and one absent slot,
   16 absent addresses, 8 requests of 80 slots on the storage writer (64 it
   wrote, 16 absent: the proof-worker pool); each response's JSON must equal
   the direct ProofCalculator call at block 11 and verify against block
   11's root (trie/proof.py). b) debug_executionWitness of blocks 9-11, each
   equal to the "stateless" path's witness's to_json(). c) block 12: the
   sync child's fourth unsealed batch (PAYLOAD_BATCHES + RPC_BATCHES are
   signed) through eth_sendRawTransaction from RPC_CLIENTS threads (every
   hash back), engine_forkchoiceUpdatedV2 with attributes and
   engine_getPayloadV2 (the chain takes V2), the payload through
   flashbots_validateBuilderSubmissionV3 (Valid; again with one byte of its
   state root flipped and its hash re-sealed on the host: Invalid, "state
   root mismatch"), engine_newPayloadV2 (VALID at the header's root, 245 of
   245) and forkchoiceUpdatedV2 to 12; eth_getBlockByNumber("latest") and
   the 245 eth_getTransactionReceipt (one batch) must agree with the tree,
   and an engine call without the token must answer HTTP 401. Kernels 1 and
   4 (the import's hot-state arena) and no other; 0 kernel faults on both
   servers, no sparse or catch-all fallback; the walls of a, b and c logged.
   Then networking, the online stages and era archives (NetCell, path
   "net") on the "sync" path's database at block 8 (its first sync's
   tables): a NetworkManager(device="cuda") with a fixed node key on
   127.0.0.1, a Discv4 beside it, the era1 archives of blocks 0-4 (two
   files and an index.txt of sha256 sums) on an http.server thread and
   admin_* behind an RpcServer; the client a MemDb over the sync's genesis
   tables. a) The client's Discv4 bootstraps off the server's enode and
   bonds, and the client's NetworkManager dials the discovered record's
   enode over encrypted RLPx, snappy on (AES on the port's csrc/aes.cpp);
   b) Pipeline(client, [EraStage(EraDownloader(HttpEraSource(url), cache),
   EthBeaconConsensus(device="cuda")), *default_stages(device="cuda")])
   .run(4): MerkleStage from checkpoint 0 on kernels 2-3; c)
   sync_from_peer(client, peer): the online stages, Headers and Bodies
   baselined at 4, blocks 5-8 over eth/68, the offline tail on the card;
   header 8's root, Finish at 8 and every data table equal to the sync's
   (the stage checkpoints left out); d) snap/1 at header 8's root, every
   response at most 512 KiB: account ranges from 0x00.., 0x80.. and the
   last account's key (each verified by verify_account_range and equal to
   the server's HashedAccounts rows), the storage writer's storage range
   (its HashedStorages rows), every genesis code and four account-trie
   paths' nodes (each hashing to what was asked), run under cProfile; e)
   admin_nodeInfo, admin_peers, admin_addPeer and admin_removePeer of a
   third manager over HTTP. Kernels 1-3 and no other; 0 kernel faults on
   the managers, 0 peers penalized, 0 body windows re-queued; each leg's
   wall, the stages of b, the frames and bytes of c and d on the wire
   (before and after snappy) logged.
   The member mesh (MeshCell, path "mesh", right after "rebuild leased"):
   rosters of HashMesh.build(1) and of cuda:0 named four and three times,
   each entry a member with its own stream and replica of the digest
   buffer. a) The rebuild through TurboCommitter(mesh=) on each roster with
   FusedMeshEngine and with SubtrieMeshEngine at k=8: roots and branch
   nodes equal the "default" path's, every replica byte-equal after each
   commit; b) MeshKeccak over the kernel checks' 65,543 messages on four
   members and sharded_keccak over one-block rows on four and three, equal
   to kernel 1 on one member; c) a meshed HashService leases 2 of 4 members
   to the account trie's rebuild while a live client hashes on the other
   2 (live requests complete during the lease, no bypass); d) the wedge
   drill: member 2 wedged, shed, the batch replayed bit-identical on three
   members, no numpy replay, mesh_shrinks_total 1, the member back after
   its breaker's cooldown. Kernels 1-4 and exchange_slots (the digest
   exchange between replicas); its median and largest launch are held
   against their plain version (index_copy_), and so is its first design,
   the debug entry exchange_slots_warp_row (a warp a row); the two designs
   are timed in turns beside the plain version, the bound and one
   index_copy_ on the replicas stacked, the kernel also at one row (the
   kernels line's exchange_slots row, after step 5's rows: warp_row_ms /
   largest_warp_row_ms, launch_floor_ms, largest_bound_share or
   largest_l2_resident where the time beats the HBM bound, and ptxas's
   registers, stack and spills).
   Each path must launch its kernels and no other (the leased rebuild may
   also launch kernel 1, for its live client between leases). The
   arguments of every kernel launch of each path are kept; each engine's
   host-to-device copies, launches and staged levels are logged.
4. For each main path, two more runs after the launch counts were read:
   one under torch.profiler (the card's busy time, its host-to-device copy
   time and idle share), one under cProfile (the host's time by function;
   the rebuilds and state_root have no profiled runs since "recovery" came,
   "merkle stage" has no cProfile run since the live tip came, and neither
   it nor "merkle incremental" has profiled runs since the sync path came:
   no room in the time limit, nor has the hot tip since the payload paths
   came, nor the live tip since "recovery" came; "sync" is profiled inside
   its own path, "recovery" not at all; the engine: block 1 of a fresh
   "engine" tree under torch.profiler, then block 2 under cProfile).
5. Kernel timings at the main paths' own shapes: for each kernel, on its
   main path (keccak256_absorb: state_root; packed_level and branch_level:
   merkle stage, the full-size rebuild; subtrie_levels: k=8; keccak256_absorb
   also at "merkle incremental"'s launches, the "incremental_absorb" row,
   at "sync"'s, the "sync_absorb" row, at "engine"'s, the
   "engine_absorb" row, and at "net"'s, the "net_absorb" row, with subtrie_levels at "engine"'s arena launches,
   the "engine_subtrie" row, replayed on the arena's buffer as found
   ("merkle stage"'s are state_root's shape, 16,384 one-block rows); and
   packed_level once more at state_root's
   template levels, the "template_levels" row, whose plain version is
   splice_level on the reference's padded layout; keccak256_absorb once more
   at the sparse finish's launches, the "sparse_absorb" row, and
   subtrie_levels at the fused finish's, the "sparse_subtrie" row, and at
   the arena's, the "arena_subtrie" row, and keccak256_absorb and
   subtrie_levels at the live tip's launches, the "live_tip_absorb" and
   "live_tip_subtrie" rows; the arena's and the live tip's chunks are
   replayed on a copy of the digest buffer as their launch found it, rows of
   earlier epochs resident, and the live_tip_subtrie row has no step
   breakdown), its
   launch with the most rows and its launch at the median row count (for
   subtrie_levels, the chunk with the most rows over its levels and the
   median one), replayed on a random digest buffer, bit for bit against the
   plain version on the same arguments, then timed with CUDA events beside
   the plain version (one run: the check ran it once already), the bound and the launch's one-warp floor (its
   longest row's permutations, one warp issuing an integer instruction
   every 2 cycles at the maximum SM clock; summed over a chunk's levels,
   which run one after another, as is its bound). The JSON line carries the
   median launch, plus the largest launch's time and plain time. Beside
   bound_ms it carries floor_bound_ms, the one-warp floor: like bound_ms,
   computed from this run's inputs, not measured (largest_bound_ms and
   largest_floor_bound_ms for the largest launch). ``launches`` is the sum
   over the main paths; ``launches_by_path`` splits it (the template_levels,
   sparse_absorb and sparse_subtrie rows count their own path's launches).
   keccak256_absorb's rows also carry unstaged_ms / largest_unstaged_ms, the
   debug entry's times at the same launches, and its first row check_* for
   the 65,543-message check. subtrie_levels' two timed chunks (on each of its
   rows) are also broken down by step (rows, block tier, 1 or 5
   lanes a row, each step timed alone as a one-step launch, and the chunk's
   time less its steps): logged, and in its JSON row as median_steps /
   largest_steps and median_steps_rest_ms / largest_steps_rest_ms, beside
   the isolated permutation times perm_thread_us / perm_lanes5_us. Each
   step is timed again on the one-thread path (one_thread_ms), and so is the
   whole chunk (median_one_thread_ms / largest_one_thread_ms), through a
   debug entry of fused_level.cu that runs the same launch with the
   five-lane path off, bit for bit against the plain version first. A
   step's ms and one_thread_ms are measured; its floor_bound_ms is the
   step's one-warp floor, computed from this run's inputs like the chunk's,
   not measured.
6. The drills. All but hot drill c) run in a child process of their own
   (chip_smoke.py --drills OUT, drills_child), started before the
   MerkleStage cell so that they run beside it and the live tip, and
   joined before step 5; hot drill c) runs in the smoke's own process after
   step 5, on its hot tip. Drills of the supervised route, at a fixed cut size (DRILL_ACCOUNTS /
   DRILL_SLOTS, the storage tries' commit), each checking the rung it
   expects and holding its roots against the numpy twin's, every watchdog
   thread joined after it: a) a wedge mid-commit on "auto" and "auto k=8"
   (one failover, the numpy twin); b) a wedge at exactly the terminal
   finish of a serial commit (the staging engine meets the card only
   there); c) a delay above a 0.1 s watchdog budget (a real timeout);
   d) RETH_TPU_FAULT_SUBTRIE_WEDGE (the per-level rung, launched on the
   card) and _ABORT (the numpy rung) at k=8; e) the breaker forced open
   (routed to numpy, no failover, no launch), then after its cooldown the
   real half-open probe closes it and the next commit launches; f)
   RETH_TPU_FAULT_PIPELINE_ABORT (the rebuild raises, no sweeper thread
   survives, the next commit is right); g) probe_fail=-1 (startup returns
   False, the breaker opens); h) TrieCommitter(fused=True, supervisor=...)
   with one wedge. Each drill's rung, wall and launches are logged.
   Then the hot-state plane's drills (hot_drills), each checking the rungs
   it expects: a) a launch fault inside a delta epoch (one fault, one
   eviction, the commit's root from the classic finish on the card, then a
   full epoch and a delta one); b) RETH_TPU_FAULT_HOTSTATE_EVICT_STORM=1
   (every epoch full); c) RETH_TPU_FAULT_HOTSTATE_POISON=3 on one more
   block of the hot tip (every poisoned serve caught, none revealed); d) max_rows shrunk so that
   begin_epoch evicts (no leaked row); e) a second thread holding the arena
   (the classic finish, contended 1). Then the control plane's drills
   (control_drills): a) RETH_TPU_FAULT_COMPILE_WEDGE=1 (retried, then warm);
   b) a compile wedge forever with attempts=1 (the breaker trips, serving
   degrades to the host, and after the cooldown the real half-open probe
   promotes the shape); c) RETH_TPU_FAULT_SERVICE_WEDGE_EVERY=2 (under a
   supervisor: replays, every future completing once with equal digests;
   unsupervised: every second future raises the wedge, no replay); d)
   RETH_TPU_FAULT_SERVICE_QUEUE_CAP with block=False (LaneOverloaded); e)
   RETH_TPU_FAULT_SERVICE_STALL under a lease (aged requests bypass).

Any mismatch or exception exits non-zero. The last line is
{"ok": true, "device": {...}}; before it, the card's name and power limit
(nvidia-smi), and before that the kernels' JSON.
Without a CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# integer results per clock per SM for 32-bit logic and shift instructions on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic throughput)
INT_OPS_PER_CLK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# spin before a kernel timing: longer than the host takes to enqueue 50
# launches of one wrapper
HOLD_MS = 20.0
# a warp issues one 32-bit integer instruction every 2 cycles: 16 integer
# lanes per SM sub-partition (scheduler) on compute capability 9.0
WARP_CYCLES_PER_INT_OP = 2
INT_OPCODES = ("LOP3", "LOP", "SHF", "SHL", "SHR", "IADD3", "IMAD", "PRMT", "LEA",
               "ISETP", "SEL", "IMNMX", "FLO", "POPC", "MOV")


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def host_memory() -> str:
    """This process's resident host memory (``VmRSS``) and its peak, in GiB."""
    import resource

    rss = 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024  # KiB on Linux
    return f"host memory {rss / 2**30:.2f} GiB (peak {peak / 2**30:.2f} GiB)"


def build_state(n_accounts: int, n_slots: int, seed: int = 42):
    """bench.py's MerkleStage-chunk-shaped generator: per-account storage
    tries (depth 0) + the account trie as 256 two-nibble-prefix subtries
    (start_depth=2). Returns (storage_jobs, account_prefix_jobs)."""
    from reth_tpu_torch.primitives.rlp import encode_int, rlp_encode
    from reth_tpu_torch.primitives.types import Account, encode_account

    rng = np.random.default_rng(seed)
    akeys = rng.integers(0, 256, size=(n_accounts, 32), dtype=np.uint8)
    akeys = np.unique(akeys.view("S32").ravel()).view(np.uint8).reshape(-1, 32)
    n_accounts = len(akeys)
    balances = rng.integers(1, 1 << 60, size=n_accounts)
    avals = [
        encode_account(Account(nonce=int(i % 300), balance=int(balances[i])))
        for i in range(n_accounts)
    ]
    account_jobs = []
    for pfx in range(256):
        sel = np.nonzero(akeys[:, 0] == pfx)[0]
        if len(sel):
            account_jobs.append((akeys[sel], [avals[i] for i in sel]))
    n_storage_accts = max(1, n_accounts // 10)
    skeys = rng.integers(0, 256, size=(n_slots, 32), dtype=np.uint8)
    svals = [rlp_encode(encode_int(int(v))) for v in rng.integers(1, 1 << 60, size=n_slots)]
    storage_jobs = []
    for owner in range(n_storage_accts):
        sel = np.arange(owner, n_slots, n_storage_accts)
        if len(sel):
            storage_jobs.append((skeys[sel], [svals[i] for i in sel]))
    return storage_jobs, account_jobs


def plain_state(n_accounts: int, n_slots: int, seed: int):
    """Plain state for state_root() and the MerkleStage cell: 20-byte
    addresses, accounts, and n_slots storage slots spread over n_accounts //
    10 accounts (tests/_torch_helpers.py stage_state)."""
    from reth_tpu_torch.primitives.types import Account

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _torch_helpers import stage_state

    return stage_state(Account, n_accounts, n_slots, seed)


# the sparse finish's size: storage tries x slots, dirty slot writes per trie
# and block, and blocks per main path (the dirty set of a heavy mainnet block)
SPARSE_TRIES, SPARSE_SLOTS, SPARSE_DIRTY, SPARSE_BLOCKS = 1024, 64, 4, 5


def sparse_base(n_tries: int, slots: int, seed: int = 3):
    """bench.py's sparse generator (``build_sparse_state``, the clean state
    before its dirty set): a SparseStateTrie of ``n_tries`` fully revealed
    storage tries x ``slots`` random slots (8-byte values) and their account
    leaves, not yet hashed. Returns (state, owners, slot keys by owner)."""
    from reth_tpu_torch.trie.sparse import SparseStateTrie

    rng = np.random.default_rng(seed)
    st = SparseStateTrie()
    owners, slot_keys = [], {}
    for _ in range(n_tries):
        ha = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        owners.append(ha)
        t = st.storage_trie(ha)
        keys = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(slots)]
        slot_keys[ha] = keys
        for k in keys:
            t.update(k, bytes(rng.integers(1, 256, 8, dtype=np.uint8)))
        st.update_account(ha, b"account-leaf-" + ha)
    return st, owners, slot_keys


def sparse_block(st, owners, slot_keys, dirty: int, block: int, seed: int = 3) -> None:
    """One block's dirty set in bench.py's shape, fresh from (seed, block):
    per storage trie ``dirty`` slot writes and one delete (random slots of
    the trie), every 16th trie wiped (a different 16th each block), and
    every account leaf rewritten."""
    from reth_tpu_torch.trie.sparse import SparseTrie

    rng = np.random.default_rng([seed, block])
    for i, ha in enumerate(owners):
        t = st.storage_trie(ha)
        keys = slot_keys[ha]
        for j in rng.integers(0, len(keys), size=dirty):
            t.update(keys[int(j)], bytes(rng.integers(1, 256, 8, dtype=np.uint8)))
        t.delete(keys[int(rng.integers(0, len(keys)))])
        if (i + block) % 16 == 15:  # a SELFDESTRUCT wipe
            st.storage_tries[ha] = SparseTrie()
        st.update_account(ha, b"post-leaf-%d-" % block + ha)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def find_cuobjdump() -> str:
    """cuobjdump of the CUDA toolkit whose nvcc builds the kernels."""
    from reth_tpu_torch.ops import _build

    cand = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(cand):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({cand})")
    return cand


def sass_opcodes(lib_path: str, kernel: str) -> list[str]:
    """``kernel``'s SASS instructions (opcode with modifiers), by cuobjdump."""
    sass = subprocess.run([find_cuobjdump(), "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    ops, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            ops.append(m.group(1))
    if not ops:
        raise RuntimeError(f"no SASS found for {kernel} in {lib_path}")
    return ops


def sass_int_ops(lib_path: str, kernel: str) -> int:
    """Integer-pipe instructions in ``kernel``'s SASS: the body of kernel 1's
    first design (keccak256_absorb_unstaged_kernel, kept as a debug entry)
    is one fully unrolled keccak-f[1600] inside the block loop, so this is
    the per-permutation integer work (plus the loop's few instructions);
    the staged kernel's copies and sort are not a permutation's work."""
    return sum(op.split(".")[0] in INT_OPCODES for op in sass_opcodes(lib_path, kernel))


def check_coherent_digest_loads(lib_path: str, kernel: str) -> None:
    """Raise if a 128-bit load from global memory in ``kernel`` takes the
    non-coherent path (.CONSTANT). Those loads are the digest loads (every
    other array is read in words of at most 8 bytes, staged digests from
    shared memory); a later step of subtrie_levels reads digests an earlier
    step wrote, which a non-coherent load may miss."""
    ops = sass_opcodes(lib_path, kernel)
    wide = [op for op in ops if op.split(".")[0] in ("LDG", "LD") and ".128" in op]
    nc = [op for op in ops if op.split(".")[0] in ("LDG", "LD") and "CONSTANT" in op]
    log(f"SASS {kernel}: {len(wide)} 128-bit global loads ({sorted(set(wide))}), "
        f"{len(nc)} non-coherent loads in all ({sorted(set(nc))})")
    if not wide:
        raise AssertionError(f"{kernel}: no 128-bit digest load found in its SASS")
    if any("CONSTANT" in op for op in wide):
        raise AssertionError(f"{kernel}: a digest load is non-coherent (.CONSTANT)")


def ptxas_report(text: str) -> dict[str, dict]:
    """Registers, stack frame and spill bytes per function from ``ptxas -v``
    output, keyed by the (mangled) function name."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m[1])
    return out


# the kernel functions of each source that must have no stack frame and no
# spills (the debug entries are only logged)
ENFORCED = {"fused_level.cu": ("packed_level_kernel", "branch_level_kernel",
                               "subtrie_levels_kernel", "exchange_slots_kernel"),
            "keccak.cu": ("keccak256_absorb_kernel",)}
KERNEL_FUNCTIONS = ENFORCED["fused_level.cu"] + ENFORCED["keccak.cu"] + (
    "keccak256_absorb_unstaged_kernel", "exchange_slots_warp_row_kernel")


def check_ptxas(src_name: str, text: str) -> dict[str, dict]:
    """Log each kernel function's ptxas line; raise if a kernel of
    ``ENFORCED[src_name]`` is missing, has a stack frame or spills. Returns
    the lines by kernel function, a template's instances as ``name<arg>``
    (exchange_slots_kernel<1> and <4>), each instance enforced."""
    short = {}
    for fn, r in ptxas_report(text).items():
        name = next((k for k in KERNEL_FUNCTIONS if k in fn), fn)
        inst = re.search(r"ILi(\d+)EE", fn)
        if name in KERNEL_FUNCTIONS and inst:
            name = f"{name}<{inst[1]}>"
        short[name] = r
        log(f"ptxas {src_name} {name}: {r.get('registers', '?')} registers, "
            f"{r.get('stack', '?')} bytes stack frame, {r.get('spill_stores', '?')} bytes spill "
            f"stores, {r.get('spill_loads', '?')} bytes spill loads")
    for k in ENFORCED[src_name]:
        found = {n: r for n, r in short.items() if n == k or n.startswith(k + "<")}
        if not found or any("stack" not in r for r in found.values()):
            raise AssertionError(f"ptxas reported nothing for {k}")
        for n, r in found.items():
            if r["stack"] or r["spill_stores"] or r["spill_loads"]:
                raise AssertionError(f"{n} has a {r['stack']}-byte stack frame or spills "
                                     f"({r['spill_stores']}/{r['spill_loads']} bytes)")
    return short


def cuda_ms(fn, iters: int, warmup: int = 2, hold_ms: float = 0.0) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back runs, by CUDA events.
    ``hold_ms`` first parks the stream in a spin kernel that long, so that
    every launch is queued before the first one runs and the events time
    the card alone, not the host's enqueue rate (a kernel shorter than its
    wrapper's host cost would otherwise be timed at that cost)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold_ms:
        torch.cuda._sleep(int(hold_ms * 1e-3 * max_sm_clock_hz()))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ab_ms(fa, fb, iters: int) -> tuple[float, float]:
    """Times of two launches of the same work, taken in turns a, b, b, a
    (each as ``cuda_ms`` with the stream held); the mean of each pair."""
    a1 = cuda_ms(fa, iters, hold_ms=HOLD_MS)
    b1 = cuda_ms(fb, iters, hold_ms=HOLD_MS)
    b2 = cuda_ms(fb, iters, hold_ms=HOLD_MS)
    a2 = cuda_ms(fa, iters, hold_ms=HOLD_MS)
    return (a1 + a2) / 2, (b1 + b2) / 2


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


class Bound:
    """Least time for a launch: the larger of its bytes over HBM rate and
    its keccak permutations' integer instructions over the SMs' rate."""

    def __init__(self, ops_per_perm: int, sms: int, clock_hz: float):
        self.ops_per_perm = ops_per_perm
        self.clock_hz = clock_hz
        self.int_rate = sms * INT_OPS_PER_CLK_PER_SM * clock_hz

    def __call__(self, perms: int, nbytes: int) -> tuple[float, str]:
        t_ops = perms * self.ops_per_perm / self.int_rate
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")

    def level(self, work) -> tuple[float, str, float, str]:
        """(bound ms, what bounds it, one-warp floor ms, description) of one
        launch from its (permutations, bytes, longest row's permutations)."""
        perms, nbytes, longest = work
        b_ms, b_by = self(perms, nbytes)
        return (b_ms, b_by, self.floor_ms(longest),
                f"{perms} permutations, longest row {longest}, {nbytes} B")

    def floor_ms(self, longest_row_perms: int) -> float:
        """One-warp floor of a launch: its longest row's permutations issued
        by one warp, an integer instruction every WARP_CYCLES_PER_INT_OP
        cycles at the maximum SM clock. One thread per row cannot go below
        it."""
        return longest_row_perms * self.ops_per_perm * WARP_CYCLES_PER_INT_OP / self.clock_hz * 1e3


def make_bound(libs) -> Bound:
    import torch

    props = torch.cuda.get_device_properties(0)
    bound = Bound(sass_int_ops(libs["keccak.cu"], "keccak256_absorb_unstaged_kernel"),
                  props.multi_processor_count, max_sm_clock_hz())
    log(f"bound model: {bound.ops_per_perm} integer SASS instructions per permutation "
        f"(cuobjdump), {INT_OPS_PER_CLK_PER_SM} int ops/clk/SM x {props.multi_processor_count} "
        f"SMs x max SM clock {bound.clock_hz / 1e6:.0f} MHz = {bound.int_rate:.4e} ops/s; "
        f"HBM {HBM_BYTES_PER_S:.3e} B/s")
    return bound


def _put(a, dtype):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to("cuda")


def _same_buffer(kernel, ref, args, buf_rows: int, rng, base=None) -> int:
    """Run a level kernel and its plain version from the same digest buffer,
    ``base`` or a random one; returns the max abs difference of the two
    buffers after."""
    import torch

    if base is None:
        base = torch.from_numpy(rng.integers(0, 256, size=(buf_rows, 32),
                                             dtype=np.uint8)).to("cuda")
    b_k, b_r = base.clone(), base.clone()
    kernel(*args, b_k)
    ref(*args, b_r)
    torch.cuda.synchronize()
    return max_abs_err(b_k, b_r)


def edge_level_checks() -> None:
    """packed_level and branch_level bit for bit against their plain
    versions on every edge level of tests/_torch_helpers.py."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _torch_helpers import EDGE_CASES, edge_digest_buffer, edge_level, level_kernel_args

    from reth_tpu_torch.ops import fused_commit as fc

    n_cases = 0
    for case in EDGE_CASES:
        kind, largs = edge_level(case)
        kargs = level_kernel_args(kind, largs, "cuda")
        kernel, ref = ((fc.packed_level, fc.packed_level_ref) if kind == "packed"
                       else (fc.branch_level, fc.branch_level_ref))
        b_k = torch.from_numpy(edge_digest_buffer()).to("cuda")
        b_r = b_k.clone()
        kernel(*kargs, b_k)
        ref(*kargs, b_r)
        torch.cuda.synchronize()
        err = max_abs_err(b_k, b_r)
        if err:
            raise AssertionError(f"{kind}_level differs from its plain version on edge level "
                                 f"{case} (max abs err {err})")
        n_cases += 1
    log(f"packed_level and branch_level: bit-exact vs plain on {n_cases} edge launches")

    from _torch_helpers import edge_chain, staged_chunks, threshold_chain

    resident, lanes5 = fc.subtrie_resident_blocks(), fc.subtrie_lanes5_rows()
    log(f"subtrie_levels: {resident} co-resident blocks of 128 threads "
        f"({resident // torch.cuda.get_device_properties(0).multi_processor_count} per SM); "
        f"steps of at most {lanes5} rows take the five-lane path")
    for chain in ("edge", "threshold"):
        for k in (1, 2, 8):
            extra = resident * 128 + 1000 if k == 8 and chain == "edge" else 0
            levels, rows = edge_chain(extra) if chain == "edge" else threshold_chain(lanes5)
            chunks = staged_chunks(levels, k, "cuda")
            base = torch.from_numpy(np.random.default_rng(k).integers(
                0, 256, size=(rows, 32), dtype=np.uint8)).to("cuda")
            b_k, b_r = base.clone(), base.clone()
            for chunk in chunks:
                fc.subtrie_levels(*chunk, b_k)
                fc.subtrie_levels_ref(*chunk, b_r)
            torch.cuda.synchronize()
            err = max_abs_err(b_k, b_r)
            if err:
                raise AssertionError(f"subtrie_levels differs from its plain version on the "
                                     f"{chain} chunks at k={k} (max abs err {err})")
            n_lanes5 = sum(int((c[3] <= lanes5).sum()) for c in chunks)
            log(f"subtrie_levels: bit-exact vs plain on {len(chunks)} chunks of {len(levels)} "
                f"chained {chain} levels at k={k} ({n_lanes5} five-lane steps)"
                + (f", the last of {extra} rows" if extra else ""))


def permutation_probe() -> dict:
    """One keccak-f[1600] in isolation, by one thread (the one-thread tiles')
    and by one five-lane group (the five-lane tiles'): the two final states
    must agree; each is timed as a chain of dependent permutations in one
    launch of one group, by CUDA events."""
    import torch

    from reth_tpu_torch.ops import fused_commit as fc

    lib, perms = fc._fused_lib(), 4000
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for lanes5 in (0, 1):
        state = torch.zeros(25, dtype=torch.int64, device="cuda")
        for _ in range(2):  # warm-up and check run
            if lib.keccak_perm_probe(state.data_ptr(), 5, lanes5, stream):
                raise RuntimeError("keccak_perm_probe: launch failed")
        torch.cuda.synchronize()
        out[lanes5] = state.clone()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            lib.keccak_perm_probe(state.data_ptr(), perms, lanes5, stream)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / perms)
        out[f"us{lanes5}"] = min(times)
    if not torch.equal(out[0], out[1]):
        raise AssertionError("the five-lane permutation differs from the one-thread one")
    log(f"one keccak-f[1600] in isolation ({perms} dependent permutations per launch, best of "
        f"5): one thread {out['us0']:.4f} us, five lanes {out['us1']:.4f} us "
        f"({out['us0'] / out['us1']:.2f}x); final states equal")
    return {"perm_thread_us": out["us0"], "perm_lanes5_us": out["us1"]}


def kernel_checks(args, account_jobs, bound: Bound) -> dict:
    """Before the main path: each kernel bit for bit against its plain
    version on inputs of its own (kernel 1 on 65,543 mixed messages, also
    against its first design, the debug entry keccak256_absorb_unstaged,
    both timed beside the plain version, bound and floor; kernels 2 and 3
    on the edge levels and on the largest PACKED and BITMAP level of a
    one-shot triebuild sweep of the account trie, larger than any dispatch
    of the pipelined main path; kernel 4 on chained edge and path-split
    chunks). Raises on any difference. Returns the isolated permutation
    times and kernel 1's check times."""
    import torch

    from reth_tpu_torch.ops import fused_commit as fc
    from reth_tpu_torch.ops.keccak import (absorb_rows_per_block, keccak256_words_masked,
                                           keccak256_words_masked_ref,
                                           keccak256_words_masked_unstaged)
    from reth_tpu_torch.primitives.keccak import keccak256, num_blocks_for, pad_batch
    from reth_tpu_torch.trie.turbo import sweep_levels

    rng = np.random.default_rng(args.seed)
    lens = list(rng.integers(0, 601, size=65536)) + [0, 135, 136, 271, 272, 543, 544]
    msgs = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lens]
    counts_np = np.array([num_blocks_for(m) for m in msgs], dtype=np.int64)
    words = _put(pad_batch(msgs, counts_np).view("<u4"), np.uint32)
    counts = _put(counts_np, np.int32)
    got = keccak256_words_masked(words, counts)
    want = keccak256_words_masked_ref(words, counts)
    unstaged = keccak256_words_masked_unstaged(words, counts)
    torch.cuda.synchronize()
    err1 = max_abs_err(got.view(torch.uint8), want.view(torch.uint8))
    err_u = max_abs_err(got.view(torch.uint8), unstaged.view(torch.uint8))
    host = got.cpu().numpy()
    for i in list(range(256)) + list(range(len(msgs) - 7, len(msgs))):
        if host[i].tobytes() != keccak256(msgs[i]):
            raise AssertionError(f"keccak256_absorb: message {i} ({len(msgs[i])} B) != keccak256")
    if err1:
        raise AssertionError(f"keccak256_absorb differs from its plain version (max abs err {err1})")
    if err_u:
        raise AssertionError(f"keccak256_absorb differs from keccak256_absorb_unstaged "
                             f"(max abs err {err_u})")
    t_mixed, t_unstaged = ab_ms(lambda: keccak256_words_masked(words, counts),
                                lambda: keccak256_words_masked_unstaged(words, counts), 20)
    plain_mixed = cuda_ms(lambda: keccak256_words_masked_ref(words, counts), 3)
    perms, nbytes, longest = keccak_work(words, counts)
    b_ms, b_by = bound(perms, nbytes)
    rpb = absorb_rows_per_block(len(msgs), words.shape[1] // 34)
    log(f"keccak256_absorb: {len(msgs)} mixed messages (1-5 blocks, {perms} permutations, "
        f"{nbytes} B) bit-exact vs plain and vs keccak256_absorb_unstaged; kernel {t_mixed:.4f} ms "
        f"per launch ({rpb} rows a block), unstaged {t_unstaged:.4f} ms, plain {plain_mixed:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}), one-warp floor {bound.floor_ms(longest):.4f} ms")
    check1 = {"check_rows": len(msgs), "check_ms": t_mixed, "check_unstaged_ms": t_unstaged,
              "check_plain_ms": plain_mixed, "check_bound_ms": b_ms,
              "check_floor_bound_ms": bound.floor_ms(longest)}
    edge_level_checks()
    probe = permutation_probe()

    levels = sweep_levels(account_jobs, collect_branches=False, start_depth=2)
    lp = max(levels, key=lambda lv: len(lv.row_slot))
    lb = max(levels, key=lambda lv: len(lv.masks))
    max_slot = max([int(lv.row_slot.max()) for lv in levels if len(lv.row_slot)]
                   + [int(lv.bmp_slot.max()) for lv in levels if len(lv.bmp_slot)])
    holes = lp.holes if lp.holes is not None else np.zeros((3, 0), np.int32)
    order, start = fc._csr(holes[0], len(lp.row_slot))
    pargs = (_put(lp.flat, np.uint8), _put(lp.row_off, np.int64), _put(lp.row_len, np.int32),
             _put(lp.row_slot, np.int64), _put(start, np.int64), _put(holes[1][order], np.int32),
             _put(holes[2][order], np.int64))
    err2 = _same_buffer(fc.packed_level, fc.packed_level_ref, pargs, max_slot + 1, rng)
    if err2:
        raise AssertionError(f"packed_level differs from its plain version (max abs err {err2})")
    order, start = fc._csr(lb.children[0], len(lb.masks))
    bargs = (_put(lb.masks, np.int32), _put(lb.bmp_slot, np.int64), _put(start, np.int64),
             _put(lb.children[1][order], np.int32), _put(lb.children[2][order], np.int64))
    err3 = _same_buffer(fc.branch_level, fc.branch_level_ref, bargs, max_slot + 1, rng)
    if err3:
        raise AssertionError(f"branch_level differs from its plain version (max abs err {err3})")
    log(f"packed_level: bit-exact vs plain on a one-shot sweep level of {len(lp.row_slot)} rows; "
        f"branch_level: bit-exact vs plain on one of {len(lb.masks)} rows (checks only)")
    return probe, check1


KERNELS = ("keccak256_absorb", "packed_level", "branch_level", "subtrie_levels", "exchange_slots")
# the main paths, each driven with the launch counts zeroed just before it:
# the rebuild on either engine, then the same two under the device
# supervisor (backend="auto", the reference's --hasher auto), state_root() on
# the general committer, fused and then supervised (SupervisedHasher over
# KeccakDevice), then the sparse live-tip finish, classic and fused
PATHS = ("default", "k=8", "auto", "auto k=8", "state_root", "state_root auto", "sparse",
         "sparse k=8", "sparse arena", "hot tip", "state_root degraded", "state_root warming",
         "service", "sparse service", "sparse service k=8", "rebuild leased", "merkle stage",
         "merkle incremental", "live tip", "live tip cached", "live tip reused",
         "live tip service", "proofs", "sync", "recovery", "engine", "engine parallel",
         "engine pipelined", "payload", "stateless", "rpc", "net", "mesh")
# the kernels each main path must launch, and the only ones it may
PATH_KERNELS = {"default": ("packed_level", "branch_level"), "k=8": ("subtrie_levels",),
                "auto": ("packed_level", "branch_level"), "auto k=8": ("subtrie_levels",),
                "state_root": ("keccak256_absorb", "packed_level"),
                "state_root auto": ("keccak256_absorb",),
                "sparse": ("keccak256_absorb",), "sparse k=8": ("subtrie_levels",),
                "sparse arena": ("subtrie_levels",), "hot tip": ("subtrie_levels",),
                "state_root degraded": (), "state_root warming": ("keccak256_absorb",),
                "service": ("keccak256_absorb",), "sparse service": ("keccak256_absorb",),
                "sparse service k=8": ("subtrie_levels",),
                "rebuild leased": ("packed_level", "branch_level"),
                "merkle stage": ("keccak256_absorb", "packed_level", "branch_level"),
                "merkle incremental": ("keccak256_absorb",),
                "live tip": ("keccak256_absorb", "subtrie_levels"),
                "live tip cached": ("keccak256_absorb", "subtrie_levels"),
                "live tip reused": ("keccak256_absorb", "subtrie_levels"),
                "live tip service": ("keccak256_absorb",), "proofs": ("keccak256_absorb",),
                "sync": ("keccak256_absorb", "packed_level", "branch_level"),
                "recovery": ("keccak256_absorb", "packed_level"),
                "engine": ("keccak256_absorb", "subtrie_levels"),
                "engine parallel": ("keccak256_absorb", "subtrie_levels"),
                "engine pipelined": ("keccak256_absorb",),
                "payload": ("keccak256_absorb", "subtrie_levels"),
                "stateless": ("keccak256_absorb",),
                "rpc": ("keccak256_absorb", "subtrie_levels"),
                "net": ("keccak256_absorb", "packed_level", "branch_level"),
                "mesh": ("keccak256_absorb", "packed_level", "branch_level", "subtrie_levels",
                         "exchange_slots")}
# kernels a main path may launch besides its own: the leased rebuild's live
# client dispatches through kernel 1 whenever the lease is not held
PATH_MAY = {"rebuild leased": ("keccak256_absorb",)}
# the rebuild paths and their unsupervised twins
AUTO_TWIN = {"auto": "default", "auto k=8": "k=8"}
# the drills' state: bench.py's generator at a fixed cut size (no flag)
DRILL_ACCOUNTS, DRILL_SLOTS = 30_000, 12_000
# the rows that time a kernel at another main path's launches: row -> kernel
ROW_KERNEL = {"template_levels": "packed_level", "sparse_absorb": "keccak256_absorb",
              "sparse_subtrie": "subtrie_levels", "arena_subtrie": "subtrie_levels",
              "service_absorb": "keccak256_absorb", "incremental_absorb": "keccak256_absorb",
              "live_tip_absorb": "keccak256_absorb", "live_tip_subtrie": "subtrie_levels",
              "sync_absorb": "keccak256_absorb", "engine_absorb": "keccak256_absorb",
              "engine_subtrie": "subtrie_levels", "net_absorb": "keccak256_absorb"}
# the rows held and timed at their two launches only: no step breakdown, and
# the plain version (about a second a chunk) timed once
STEPLESS_ROWS = ("live_tip_subtrie", "engine_subtrie")
# the main paths whose kernel 4 launches keep a copy of the digest buffer as
# it was before the launch (the arena's: rows of earlier epochs), so that the
# timed replay starts from it
KEEP_BUFFER_PATHS = ("sparse arena", "live tip", "engine")
# the one place the port may launch kernel 1 from off the mesh, and the
# mesh's two (a member's range of a MeshKeccak bucket, sharded_keccak's rows)
KECCAK_DEVICE = "reth_tpu_torch/ops/keccak.py:KeccakDevice._hash_bucket"
KECCAK_MESH = ("reth_tpu_torch/parallel/mesh.py:MeshKeccak._hash_bucket.<locals>.launch",
               "reth_tpu_torch/ops/keccak.py:keccak256_words")


class _Recorded:
    """Stands in for a kernel wrapper at a module attribute. A wrapper
    counts its launches through that attribute (``packed_level.launches
    += 1``), so ``launches`` here reads and writes the wrapper's own count."""

    def __init__(self, fn, recorder, name: str):
        self.fn, self.recorder, self.name = fn, recorder, name

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.launches = value

    def __call__(self, *args):
        # one launch at a time: the live tip's proof workers launch from
        # several threads, and a wrapper's count is not locked
        with self.recorder.lock:
            return self._record(*args)

    def _record(self, *args):
        rec = self.recorder
        if rec.path is None:  # between main paths: launch, record nothing
            return self.fn(*args)
        before = self.fn.launches
        keep = self.name == "subtrie_levels" and rec.path in KEEP_BUFFER_PATHS
        base = args[-1].clone() if keep else None
        out = self.fn(*args)
        if self.fn.launches != before:
            if self.name == "exchange_slots":
                # the slots and bounds, and the replicas' rows and count
                bufs, slots, bounds = args
                rec.calls[rec.path][self.name].append(
                    (slots, tuple(bounds), bufs[0].shape[0], len(bufs)))
            elif self.name == "keccak256_absorb":
                rec.calls[rec.path][self.name].append(args)
                caller = sys._getframe(2).f_code
                rec.callers.add(f"{os.path.relpath(caller.co_filename, HERE)}:"
                                f"{caller.co_qualname}")
            else:
                last = base if keep else args[-1].shape[0]
                rec.calls[rec.path][self.name].append(args[:-1] + (last,))
        return out


class MainPathRecorder:
    """Keeps the arguments of every launch the four kernel wrappers make
    while it is entered, by main path (``path``, set by the caller), and
    the callers of kernel 1's wrapper. It wraps the module attributes the
    port calls through; each wrapper still launches and counts as it does
    unwrapped. The level kernels' digest buffer is kept as its row count,
    except on ``KEEP_BUFFER_PATHS``, where kernel 4's is kept as it was
    before the launch."""

    def __init__(self):
        from reth_tpu_torch.ops import fused_commit as fc
        from reth_tpu_torch.ops import keccak as ok

        self.sites = [(ok, "keccak256_words_masked", "keccak256_absorb"),
                      (fc, "packed_level", "packed_level"),
                      (fc, "branch_level", "branch_level"),
                      (fc, "subtrie_levels", "subtrie_levels"),
                      (fc, "exchange_slots", "exchange_slots")]
        self.path = PATHS[0]
        self.calls: dict[str, dict[str, list]] = {p: {k: [] for k in KERNELS} for p in PATHS}
        self.callers: set[str] = set()
        self.lock = threading.Lock()
        self._saved: list = []

    def __enter__(self):
        for mod, attr, name in self.sites:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, _Recorded(fn, self, name))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved = []

    def rows(self, name: str, args) -> int:
        """Rows of one launch (packed_level's first argument is its bytes;
        subtrie_levels' rows are its levels' rows together)."""
        if name == "subtrie_levels":
            return int(args[2][:, 1].sum())
        return args[1 if name == "packed_level" else 0].shape[0]

    def picks(self, name: str, path: str):
        """The launch with the most rows and the one at the median row count."""
        calls = sorted(self.calls[path][name], key=lambda a: self.rows(name, a))
        return {"largest": calls[-1], "median": calls[len(calls) // 2]}


def keccak_work(words, counts):
    """(permutations, bytes moved, longest row's permutations) of kernel 1: the blocks each row absorbs
    are read once, plus counts in and digests out."""
    perms = int(counts.sum())
    n = words.shape[0]
    return perms, perms * 136 + n * (4 + 32), int(counts.max())


def packed_work(flat, row_off, row_len, slots, hole_start, hole_off, hole_src):
    n, H = row_off.shape[0], hole_off.shape[0]
    blocks = row_len.long() // 136 + 1
    return (int(blocks.sum()), flat.numel() + n * (8 + 4 + 8 + 8 + 32) + 8 + H * (4 + 8 + 32),
            int(blocks.max()))


def branch_work(masks, slots, ch_start, ch_nib, ch_src):
    n, C = masks.shape[0], ch_nib.shape[0]
    pop = np.unpackbits(masks.cpu().numpy().astype("<u2").view(np.uint8)).reshape(n, 16).sum(1)
    payload = 16 + 32 * pop.astype(np.int64) + 1
    total = payload + np.where(payload > 0xFF, 3, 2)
    blocks = total // 136 + 1
    return int(blocks.sum()), n * (4 + 8 + 8 + 32) + 8 + C * (4 + 8 + 32), int(blocks.max())


def subtrie_cost(bound: Bound, u8, idx, steps, rows) -> tuple[float, str, float, str]:
    """A chunk's bound and one-warp floor: its levels run one after another
    (a grid barrier between them), so both are sums over its levels of each
    level's own; it is bound by what bounds most of that sum."""
    from reth_tpu_torch.ops import fused_commit as fc

    b_ms = floor = perms = nbytes = 0.0
    by_ops = 0.0
    table = steps.cpu().tolist()
    for p in table:
        work = (packed_work if p[0] == 0 else branch_work)(*fc._step_args(u8, idx, p))
        s_ms, s_by, s_floor, _ = bound.level(work)
        b_ms, floor = b_ms + s_ms, floor + s_floor
        by_ops += s_ms if s_by == "operations" else 0.0
        perms, nbytes = perms + work[0], nbytes + work[1]
    return (b_ms, "operations" if by_ops >= b_ms / 2 else "bytes", floor,
            f"{len(table)} levels, {int(perms)} permutations, {int(nbytes)} B")


def subtrie_one_thread(u8, idx, steps, rows, buf) -> None:
    """subtrie_levels with every step on the one-thread path (a debug entry
    of fused_level.cu, not counted as a launch): the other side of each
    step's path choice, timed beside it."""
    from reth_tpu_torch.device import stream_handle
    from reth_tpu_torch.ops import _build
    from reth_tpu_torch.ops import fused_commit as fc

    rows = np.ascontiguousarray(rows, dtype=np.int64)
    err = fc._fused_lib().subtrie_levels_one_thread(
        u8.data_ptr(), idx.data_ptr(), steps.data_ptr(), steps.shape[0], rows.ctypes.data,
        buf.data_ptr(), stream_handle(buf))
    _build.check_launch(err, "subtrie_levels_one_thread")


def subtrie_steps(bound: Bound, args, buf, chunk_ms: float, label: str, rng) -> dict:
    """A timed subtrie_levels chunk broken down by step: each step's rows,
    block tier and path (1 or 5 lanes a row), timed alone as a one-step
    launch on the same staged buffers and digest buffer, with the stream
    held as for the chunk, and again with the step on the one-thread path;
    the chunk's time less the sum of its steps (its grid barriers, and the
    grid its narrow steps hold); and the whole chunk on the one-thread
    path, bit for bit against the plain version first."""
    from reth_tpu_torch.ops import fused_commit as fc

    u8, idx, steps, rows = args
    err = _same_buffer(subtrie_one_thread, fc.subtrie_levels_ref, args, buf.shape[0], rng)
    if err:
        raise AssertionError(f"subtrie_levels on the one-thread path differs from its plain "
                             f"version at the {label} chunk (max abs err {err})")
    one_thread_ms = cuda_ms(lambda: subtrie_one_thread(*args, buf), 50, hold_ms=HOLD_MS)
    lanes5 = fc.subtrie_lanes5_rows()
    out = []
    for s, p in enumerate(steps.cpu().tolist()):
        longest = (packed_work if p[0] == 0 else branch_work)(*fc._step_args(u8, idx, p))[2]
        one = (u8, idx, steps[s:s + 1], rows[s:s + 1])
        ms = cuda_ms(lambda: fc.subtrie_levels(*one, buf), 50, hold_ms=HOLD_MS)
        thread_ms = cuda_ms(lambda: subtrie_one_thread(*one, buf), 50, hold_ms=HOLD_MS)
        out.append({"rows": int(rows[s]), "tier": 1 << (longest - 1).bit_length(),
                    "lanes": 5 if rows[s] <= lanes5 else 1, "ms": ms,
                    "one_thread_ms": thread_ms, "floor_bound_ms": bound.floor_ms(longest)})
    rest = chunk_ms - sum(st["ms"] for st in out)
    log(f"subtrie_levels {label} chunk by step (rows / block tier / lanes a row: ms alone, "
        f"ms on one thread a row, one-warp floor): " + "; ".join(
            f"{st['rows']} / {st['tier']} / {st['lanes']}: {st['ms']:.4f}, "
            f"{st['one_thread_ms']:.4f}, {st['floor_bound_ms']:.4f}" for st in out)
        + f"; chunk less its steps {rest:.4f} ms; the chunk on one thread a row "
        f"{one_thread_ms:.4f} ms (bit-exact vs plain) against {chunk_ms:.4f}")
    return {f"{label}_steps": out, f"{label}_steps_rest_ms": rest,
            f"{label}_one_thread_ms": one_thread_ms}


def template_plain(flat, row_off, row_len, slots, hole_start, hole_off, hole_src, buf):
    """The template levels' plain version (the reference's layout,
    fused_commit.splice_level) on kernel 2's arguments of such a level."""
    from reth_tpu_torch.ops import fused_commit as fc

    fc.splice_level(*fc.padded_level(flat, row_off, row_len, slots, hole_start, hole_off,
                                     hole_src), buf)


def kernel_timings(recorder: MainPathRecorder, launches: dict, bound: Bound, rng) -> list[dict]:
    """After the main paths: each kernel at the arguments of two of its own
    launches on its main path (the one with the most rows, and the one at
    the median row count), bit for bit against its plain version on those
    arguments, then timed by CUDA events beside the plain version, the bound
    and the one-warp floor. packed_level is timed twice: at the rebuild's
    launches and, as the template levels' row, at state_root's (its plain
    version there is splice_level on the reference's padded layout, padded
    before it is timed). keccak256_absorb is timed in turns with its first
    design, the debug entry keccak256_absorb_unstaged, at the same launches.
    The kernels' JSON rows carry the median launch and the largest launch's
    times, bound and floor bound; both are logged."""
    import torch

    from reth_tpu_torch.ops import fused_commit as fc
    from reth_tpu_torch.ops.keccak import (absorb_rows_per_block, keccak256_words_masked,
                                           keccak256_words_masked_ref,
                                           keccak256_words_masked_unstaged)

    def level(work):
        return lambda *a: bound.level(work(*a))

    level_src = "reth_tpu_torch/ops/csrc/fused_level.cu"
    # row name: (wrapper, plain version, cost, source, replaces, main path)
    specs = {
        "keccak256_absorb": (keccak256_words_masked, keccak256_words_masked_ref,
                             level(keccak_work), "reth_tpu_torch/ops/csrc/keccak.cu",
                             "reth_tpu/ops/keccak_pallas.py:96", "state_root"),
        "packed_level": (fc.packed_level, fc.packed_level_ref, level(packed_work), level_src,
                         "reth_tpu/ops/fused_commit.py:93", "merkle stage"),
        "branch_level": (fc.branch_level, fc.branch_level_ref, level(branch_work), level_src,
                         "reth_tpu/ops/fused_commit.py:119", "merkle stage"),
        "subtrie_levels": (fc.subtrie_levels, fc.subtrie_levels_ref,
                           lambda *a: subtrie_cost(bound, *a), level_src,
                           "reth_tpu/ops/fused_commit.py:1046", "k=8"),
        "template_levels": (fc.packed_level, template_plain, level(packed_work), level_src,
                            "reth_tpu/ops/fused_commit.py:76", "state_root"),
        "sparse_absorb": (keccak256_words_masked, keccak256_words_masked_ref,
                          level(keccak_work), "reth_tpu_torch/ops/csrc/keccak.cu",
                          "reth_tpu/ops/keccak_pallas.py:96", "sparse"),
        "sparse_subtrie": (fc.subtrie_levels, fc.subtrie_levels_ref,
                           lambda *a: subtrie_cost(bound, *a), level_src,
                           "reth_tpu/ops/fused_commit.py:1046", "sparse k=8"),
        "arena_subtrie": (fc.subtrie_levels, fc.subtrie_levels_ref,
                          lambda *a: subtrie_cost(bound, *a), level_src,
                          "reth_tpu/ops/fused_commit.py:1046", "sparse arena"),
        "service_absorb": (keccak256_words_masked, keccak256_words_masked_ref,
                           level(keccak_work), "reth_tpu_torch/ops/csrc/keccak.cu",
                           "reth_tpu/ops/keccak_pallas.py:96", "service"),
        "incremental_absorb": (keccak256_words_masked, keccak256_words_masked_ref,
                               level(keccak_work), "reth_tpu_torch/ops/csrc/keccak.cu",
                               "reth_tpu/ops/keccak_pallas.py:96", "merkle incremental"),
        "live_tip_absorb": (keccak256_words_masked, keccak256_words_masked_ref,
                            level(keccak_work), "reth_tpu_torch/ops/csrc/keccak.cu",
                            "reth_tpu/ops/keccak_pallas.py:96", "live tip"),
        "live_tip_subtrie": (fc.subtrie_levels, fc.subtrie_levels_ref,
                             lambda *a: subtrie_cost(bound, *a), level_src,
                             "reth_tpu/ops/fused_commit.py:1046", "live tip"),
        "sync_absorb": (keccak256_words_masked, keccak256_words_masked_ref,
                        level(keccak_work), "reth_tpu_torch/ops/csrc/keccak.cu",
                        "reth_tpu/ops/keccak_pallas.py:96", "sync"),
        "engine_absorb": (keccak256_words_masked, keccak256_words_masked_ref,
                          level(keccak_work), "reth_tpu_torch/ops/csrc/keccak.cu",
                          "reth_tpu/ops/keccak_pallas.py:96", "engine"),
        "engine_subtrie": (fc.subtrie_levels, fc.subtrie_levels_ref,
                           lambda *a: subtrie_cost(bound, *a), level_src,
                           "reth_tpu/ops/fused_commit.py:1046", "engine"),
        "net_absorb": (keccak256_words_masked, keccak256_words_masked_ref,
                       level(keccak_work), "reth_tpu_torch/ops/csrc/keccak.cu",
                       "reth_tpu/ops/keccak_pallas.py:96", "net"),
    }
    rows = []
    for name, (kernel, ref, cost, source, replaces, path) in specs.items():
        wrapper = ROW_KERNEL.get(name, name)
        calls = recorder.calls[path][wrapper]
        sizes = sorted(recorder.rows(wrapper, a) for a in calls)
        log(f"{name} ({wrapper} on main path {path}): {len(calls)} launches, rows per launch "
            f"min {sizes[0]}, median {sizes[len(sizes) // 2]}, "
            f"mean {sum(sizes) / len(sizes):.1f}, max {sizes[-1]}")
        row = dict(name=name, route="cuda", source=source, replaces=replaces, library_ms=None)
        if name in ROW_KERNEL:
            row.update(kernel=wrapper, launches_by_path={path: launches[path][wrapper]})
            if name == "template_levels":
                row["plain"] = "fused_commit.splice_level"
        else:
            row["launches_by_path"] = {p: launches[p][name] for p in PATHS}
        row["launches"] = sum(row["launches_by_path"].values())
        for label, rec in recorder.picks(wrapper, path).items():
            extra = ""
            if wrapper == "keccak256_absorb":
                fargs = rec
                got = kernel(*rec)
                err = max(max_abs_err(got.view(torch.uint8), ref(*rec).view(torch.uint8)),
                          max_abs_err(got.view(torch.uint8),
                                      keccak256_words_masked_unstaged(*rec).view(torch.uint8)))
                call, plain = (lambda: kernel(*fargs)), (lambda: ref(*fargs))
            else:
                # an arena launch's buffer as the launch found it (rows of
                # earlier epochs resident), else its row count
                fargs, base = rec[:-1], rec[-1]
                if isinstance(base, torch.Tensor):
                    buf_rows = base.shape[0]
                    extra = f", replayed on the buffer as the launch found it ({buf_rows} rows)"
                else:
                    buf_rows, base = base, None
                err = _same_buffer(kernel, ref, fargs, buf_rows, rng, base)
                b_k = (base.clone() if base is not None else
                       torch.zeros((buf_rows, 32), dtype=torch.uint8, device="cuda"))
                # the template levels' plain version is timed on rows padded beforehand
                plain_fn, plain_args = ((fc.splice_level, fc.padded_level(*fargs))
                                        if name == "template_levels" else (ref, fargs))
                call, plain = (lambda: kernel(*fargs, b_k)), (lambda: plain_fn(*plain_args, b_k))
            if err:
                raise AssertionError(f"{name} differs from its plain version at the main path's "
                                     f"{label} launch (max abs err {err})")
            if wrapper == "keccak256_absorb":
                ms, unstaged_ms = ab_ms(call, lambda: keccak256_words_masked_unstaged(*fargs), 50)
                rpb = absorb_rows_per_block(fargs[0].shape[0], fargs[0].shape[1] // 34)
                extra = (f", unstaged {unstaged_ms:.4f} ms, {rpb} rows a block "
                         f"(bit-exact vs unstaged too)")
                row["unstaged_ms" if label == "median" else "largest_unstaged_ms"] = unstaged_ms
                row["rows_per_block" if label == "median" else "largest_rows_per_block"] = rpb
            else:
                ms = cuda_ms(call, 50, hold_ms=HOLD_MS)
            # once: the check above ran it on these arguments already
            plain_ms = cuda_ms(plain, 1, warmup=0)
            b_ms, b_by, floor, desc = cost(*fargs)
            log(f"{name} at the main path's {label} launch ({recorder.rows(wrapper, rec)} rows, "
                f"{desc}): bit-exact vs plain; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"one-warp floor {floor:.4f} ms{extra}")
            if wrapper == "subtrie_levels" and name not in STEPLESS_ROWS:
                row.update(subtrie_steps(bound, fargs, b_k, ms, label, rng))
            if label == "median":
                row.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, floor_bound_ms=floor,
                           rows_timed=recorder.rows(wrapper, rec))
            else:
                row.update(largest_ms=ms, largest_plain_ms=plain_ms, largest_bound_ms=b_ms,
                           largest_floor_bound_ms=floor,
                           largest_rows_timed=recorder.rows(wrapper, rec))
        rows.append(row)
    return rows


def track_engines(committer, factory: str = "_make_backend") -> list:
    """The engines ``committer`` makes from now on through its ``factory``
    method (one per commit)."""
    made = []
    make = getattr(committer, factory)

    def tracked(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    setattr(committer, factory, tracked)
    return made


def engine_summary(engines: list) -> str:
    """Host-to-device copies, launches and staged levels of a rebuild's
    engines (one per commit: storage tries, account trie)."""
    uploads = sum(e.uploads for e in engines)
    dispatches = sum(e.dispatches for e in engines)
    staged = [getattr(e, "levels_staged", None) for e in engines]
    out = (f"{type(engines[0]).__name__} x {len(engines)} commits: {uploads} host-to-device "
           f"copies, {dispatches} launches, {sum(e.staged_u8_bytes for e in engines)} B staged "
           f"bytes + {sum(e.staged_i32_bytes for e in engines)} B staged indices")
    if None not in staged:
        out += f", {sum(staged)} levels staged (k={engines[0].k})"
    return out


# the sparse finish's card paths
SPARSE_PATHS = ("sparse", "sparse k=8", "sparse arena")
# the same finish with the hash service's live-lane client as its hasher:
# classic (encode chunks streamed through submit, kernel 1 on the service's
# dispatcher) and fused (the window through commit_window, kernel 4 there)
SERVICE_SPARSE_PATHS = ("sparse service", "sparse service k=8")
CELL_PATHS = SPARSE_PATHS + SERVICE_SPARSE_PATHS


class GcPauses:
    """The interpreter's garbage-collection pauses while entered: ``stats()``
    gives their summed seconds (``gc_s``) and count (``gc_runs``)."""

    def __enter__(self):
        import gc

        self.pauses: list[float] = []
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._on_gc)

    def _on_gc(self, phase, _info) -> None:
        if phase == "start":
            self.pauses.append(-time.perf_counter())
        elif self.pauses:
            self.pauses[-1] += time.perf_counter()

    def stats(self) -> dict:
        return {"gc_s": round(sum(self.pauses), 4), "gc_runs": len(self.pauses)}


class SparseCell:
    """The sparse live-tip finish at one size: the same generated state
    six times, committed by the card's classic finish ("sparse":
    ParallelSparseCommitter hashing each depth through KeccakDevice, kernel
    1), by the card's fused finish ("sparse k=8": subtrie_levels=8, kernel
    4), by the hot-state arena's delta finish on the card ("sparse arena":
    arena=DigestArena(), kernel 4 on one engine whose digest buffer outlives
    the block), by the same two finishes with ``service``'s live-lane client
    as the hasher ("sparse service": chunks streamed through submit, kernel 1
    on the service's dispatcher thread; "sparse service k=8": the window
    through commit_window, kernel 4 there) and by the CPU twin (the classic
    finish on device="cpu" with the numpy hasher). Each block applies the
    same seeded dirty set to all six; every root and the account trie's
    stored branch updates are held against the twin's."""

    def __init__(self, service):
        from reth_tpu_torch.ops.fused_commit import DigestArena
        from reth_tpu_torch.primitives.keccak import keccak256_batch_np
        from reth_tpu_torch.trie.sparse import ParallelSparseCommitter

        t0 = time.perf_counter()
        self.states = {name: sparse_base(SPARSE_TRIES, SPARSE_SLOTS)
                       for name in CELL_PATHS + ("twin",)}
        self.owners = self.states["twin"][1]
        log(f"sparse state generated {len(self.states)} times in {time.perf_counter() - t0:.1f} s "
            f"({SPARSE_TRIES} storage tries x {SPARSE_SLOTS} slots, {SPARSE_TRIES} accounts)")
        self.arena = DigestArena()
        self.committers = {"sparse": ParallelSparseCommitter(device="cuda"),
                           "sparse k=8": ParallelSparseCommitter(subtrie_levels=8, device="cuda"),
                           "sparse arena": ParallelSparseCommitter(arena=self.arena,
                                                                   device="cuda"),
                           "sparse service": ParallelSparseCommitter(device="cuda"),
                           "sparse service k=8": ParallelSparseCommitter(subtrie_levels=8,
                                                                         device="cuda"),
                           "twin": ParallelSparseCommitter(device="cpu")}
        live = service.client("live")
        self.hashers = {"twin": keccak256_batch_np, "sparse service": live,
                        "sparse service k=8": live}
        # the fused finish's engines, one per commit
        self.engines = track_engines(self.committers["sparse k=8"], "_engine")
        self.next_block = {name: 0 for name in self.states}
        self.roots = {name: [] for name in self.states}
        self.exports = {name: [] for name in self.states}
        self.stored = {}
        self.copies = {}

    def finish(self, name: str):
        """One finish of ``name``'s state; returns (root, wall s, stats).
        The stats gain ``gc_s`` and ``gc_runs`` (``GcPauses``)."""
        import torch

        st, _, _ = self.states[name]
        c = self.committers[name]
        hasher = self.hashers.get(name)
        with GcPauses() as gcp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            root = st.root(hasher, committer=c)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return root, wall, dict(c.last, **gcp.stats())

    def baseline(self) -> None:
        """The clean state hashed once by each committer (outside the main
        paths), the card's roots held against the twin's: a whole-trie check
        of kernel 1 (classic) and kernel 4 (fused) on all of its nodes."""
        from reth_tpu_torch.trie.sparse import export_branch_updates

        for name in ("twin",) + CELL_PATHS:
            root, wall, stats = self.finish(name)
            self.roots[name].append(root)
            self.stored[name] = export_branch_updates(self.states[name][0].account_trie,
                                                      self.owners)
            if name == "sparse arena":
                stats.update(self.check_arena("baseline"))
            log(f"sparse baseline, {name}: {wall:.3f} s, root {root.hex()}, stats {stats}")
        self.check("baseline")

    def apply(self, name: str) -> None:
        """Apply the next block's dirty set to ``name``'s state."""
        st, owners, keys = self.states[name]
        sparse_block(st, owners, keys, SPARSE_DIRTY, self.next_block[name])
        self.next_block[name] += 1

    def close(self, name: str):
        """Finish ``name``'s state and export the account trie's stored
        branch updates; returns the finish's (wall s, stats)."""
        from reth_tpu_torch.trie.sparse import export_branch_updates

        root, wall, stats = self.finish(name)
        self.roots[name].append(root)
        updates = export_branch_updates(self.states[name][0].account_trie, self.owners,
                                        self.stored[name].get)
        self.exports[name].append(updates)
        for path, node in updates.items():
            if node is None:
                self.stored[name].pop(path, None)
            else:
                self.stored[name][path] = node
        return wall, stats

    def block(self, name: str):
        self.apply(name)
        return self.close(name)

    def check(self, what: str) -> None:
        """Every root and branch export so far equal to the twin's."""
        for name in CELL_PATHS:
            n = len(self.roots[name])
            if self.roots[name] != self.roots["twin"][:n]:
                raise AssertionError(f"{name}: a sparse root differs from the CPU twin's ({what})")
            if self.exports[name] != self.exports["twin"][:len(self.exports[name])]:
                raise AssertionError(f"{name}: export_branch_updates of the account trie "
                                     f"differs from the CPU twin's ({what})")
        log(f"sparse, {what}: {len(self.roots['sparse'])} roots of each card path and "
            f"{len(self.exports['sparse'])} account-trie branch exports "
            f"({sum(len(e) for e in self.exports['sparse'])} updates) equal the CPU twin's")

    def arena_state(self) -> dict:
        """The arena's engine after an epoch: resident rows, buffer rows,
        copy-growths (and their bytes and card time), pinned staging held."""
        eng = self.arena.engine
        return {"resident_rows": self.arena.snapshot()["resident_rows"],
                "buffer_rows": int(eng._buf.shape[0]) if eng._buf is not None else 0,
                "growths": eng.growths, "grown_bytes": eng.grown_bytes,
                "grow_ms": round(eng.grow_ms(), 4), "pinned_bytes": eng.pinned_bytes()}

    def check_arena(self, what: str) -> dict:
        """After each arena epoch: no fault, no leaked row, no pinned staging
        left; returns ``arena_state``."""
        snap, state = self.arena.snapshot(), self.arena_state()
        if snap["faults"] or snap["leaked_rows"] or state["pinned_bytes"]:
            raise AssertionError(f"sparse arena, {what}: a fault, a leaked row or pinned "
                                 f"staging left on a clean path: {snap}, {state}")
        return state

    def drive(self, name: str, walls: dict):
        """A main path: ``SPARSE_BLOCKS`` blocks of ``name``, each finish
        timed, with its launches (all four wrappers); logs each block and
        the median wall. The classic path's host-to-device copies, counted by
        its KeccakDevice (built by the baseline), go to ``self.copies``; the
        arena path's state after each epoch (``arena_state``) goes into the
        block's stats, and it must end with SPARSE_BLOCKS delta epochs after
        the baseline's full one, resident hits, no fault and no leaked row."""
        from reth_tpu_torch.ops import fused_commit as fc
        from reth_tpu_torch.ops import keccak as ok

        def launched() -> int:
            return sum(w.launches for w in (ok.keccak256_words_masked, fc.packed_level,
                                            fc.branch_level, fc.subtrie_levels))

        hasher = self.committers[name]._hasher
        before = hasher.__self__.uploads if hasher is not None else 0
        out = []
        for b in range(SPARSE_BLOCKS):
            n0 = launched()
            w, stats = self.block(name)
            stats["launches"] = launched() - n0
            if name == "sparse arena":
                stats.update(self.check_arena(f"block {b}"))
            out.append((w, stats))
        if hasher is not None:
            self.copies[name] = hasher.__self__.uploads - before
        walls[name] = [w for w, _ in out]
        for i, (w, stats) in enumerate(out):
            log(f"sparse finish, {name}, block {i}: {w:.4f} s, stats {stats}")
        if name == "sparse arena":
            snap = self.arena.snapshot()
            if (snap["delta_epochs"], snap["full_epochs"], snap["faults"],
                    snap["leaked_rows"]) != (SPARSE_BLOCKS, 1, 0, 0) or not snap["resident_hits"]:
                raise AssertionError(f"sparse arena: expected {SPARSE_BLOCKS} delta epochs after "
                                     f"one full epoch, resident hits, no fault and no leaked "
                                     f"row: {snap}")
            log(f"sparse arena: {json.dumps(snap)}")
        return out


# the MerkleStage cell: the commitment stages over a MemDb of
# plain_state(--accounts, --slots), then MERKLE_BLOCKS blocks on the same
# database, each of tests/_torch_helpers.py's STAGE_BLOCK writes (2,048
# accounts rewritten, 128 of them new; 16 deleted with their storage; 4,096
# slot writes over 512 owners, 256 set to zero); the four tables the card
# path must reproduce
MERKLE_BLOCKS = (2, 3)
MERKLE_TABLES = ("HashedAccounts", "HashedStorages", "AccountsTrie", "StoragesTrie")


def table_digests(db, names=MERKLE_TABLES) -> dict:
    """Each table of ``names`` (the MerkleStage cell's four by default) in
    ``db``: its row count and the SHA-256 of its rows in key order (each key
    and value length-prefixed; a DUPSORT key's values in order), so that two
    databases compare row for row."""
    import hashlib

    out = {}
    for name in names:
        rows = db._tables.get(name, {})
        h = hashlib.sha256()
        n = 0
        for k in sorted(rows):
            v = rows[k]
            vals = v if isinstance(v, list) else [v]
            n += len(vals)
            h.update(len(k).to_bytes(4, "little") + k + len(vals).to_bytes(4, "little"))
            for x in vals:
                h.update(len(x).to_bytes(4, "little") + x)
        out[name] = [n, h.hexdigest()]
    return out


def merkle_state(n_accounts: int, n_slots: int, seed: int, factory):
    """The cell's plain state (``plain_state``) loaded into ``factory``'s
    database with header 0, and the blocks' writes, generated on the way
    (``stage_block``). Returns the blocks."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _torch_helpers import load_stage_state, stage_block

    from reth_tpu_torch.primitives.types import Account, Header

    t0 = time.perf_counter()
    accounts, storages = plain_state(n_accounts, n_slots, seed)
    t1 = time.perf_counter()
    load_stage_state(factory, accounts, storages, Header(number=0))
    log(f"merkle cell: {len(accounts)} accounts, {sum(len(v) for v in storages.values())} "
        f"slots over {len(storages)} owners generated in {t1 - t0:.1f} s, loaded into a MemDb "
        f"in {time.perf_counter() - t1:.1f} s")
    return {b: stage_block(accounts, storages, b, seed, Account) for b in MERKLE_BLOCKS}


def merkle_twin(n_accounts: int, n_slots: int, seed: int, out_path: str) -> int:
    """The MerkleStage cell's CPU twin, in a child process of its own
    (``--merkle-twin``), started with the smoke so that it runs beside the
    card's earlier paths: the same state in a MemDb, the two hashing stages on
    ``TrieCommitter(hasher=keccak256_batch_np, device="cpu")`` with
    ``turbo_backend = "numpy"``, then ``full_state_root_turbo(backend=
    "numpy")``, the single-shot route (header 1's root); each block's writes,
    its hashing stages and ``MerkleStage._incremental`` (the block's root);
    then block 3's state rebuilt single-shot again on the numpy twin, whose
    root and tables must be the incremental route's. Writes the roots and
    each block's ``table_digests`` to ``out_path`` as JSON."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _torch_helpers import apply_stage_block

    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.primitives.types import Header
    from reth_tpu_torch.stages import (AccountHashingStage, MerkleStage, Pipeline,
                                       StorageHashingStage)
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.trie.committer import TrieCommitter
    from reth_tpu_torch.trie.incremental import full_state_root_turbo

    db = MemDb()
    factory = ProviderFactory(db)
    blocks = merkle_state(n_accounts, n_slots, seed, factory)
    tc = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
    tc.turbo_backend = "numpy"
    hashing = [AccountHashingStage(tc), StorageHashingStage(tc)]
    t0 = time.perf_counter()
    Pipeline(factory, hashing).run(1)
    t1 = time.perf_counter()
    with factory.provider_rw() as p:
        root = full_state_root_turbo(p, backend="numpy")
        p.insert_header(Header(number=1, state_root=root))
    log(f"merkle twin: hashing stages {t1 - t0:.3f} s, single-shot numpy rebuild "
        f"{time.perf_counter() - t1:.3f} s, root {root.hex()}")
    out = {"roots": {1: root.hex()}, "tables": {1: table_digests(db)}}
    for b in MERKLE_BLOCKS:
        t0 = time.perf_counter()
        apply_stage_block(factory, blocks[b], b)
        Pipeline(factory, hashing).run(b)
        with factory.provider_rw() as p:
            root = MerkleStage(tc)._incremental(p, b, b)
            p.insert_header(Header(number=b, state_root=root))
        out["roots"][b] = root.hex()
        out["tables"][b] = table_digests(db)
        log(f"merkle twin: block {b} ({len(blocks[b][0])} account and {len(blocks[b][1])} slot "
            f"writes) in {time.perf_counter() - t0:.3f} s, root {root.hex()}")
    t0 = time.perf_counter()
    with factory.provider_rw() as p:
        full = full_state_root_turbo(p, backend="numpy")
    if full.hex() != out["roots"][MERKLE_BLOCKS[-1]] or \
            table_digests(db) != out["tables"][MERKLE_BLOCKS[-1]]:
        raise AssertionError(f"merkle twin: block {MERKLE_BLOCKS[-1]}'s single-shot numpy "
                             f"rebuild differs from the incremental route's root or tables")
    log(f"merkle twin: block {MERKLE_BLOCKS[-1]}'s single-shot numpy rebuild "
        f"({time.perf_counter() - t0:.3f} s) gives the incremental route's root and four tables")
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


class TimedStage:
    """A stage as the pipeline sees it (``id``, ``execute``, ``unwind``),
    timing each call into ``rows``: the stage, the iteration's kind (for
    MerkleStage, read from its progress blob before and after: "start",
    "storage chunk", "storage done", "account chunk", "account chunk +
    stitch", "incremental" or "single-shot"), its wall, and the turbo
    commit's pipeline stage times and hashed nodes when it made one."""

    def __init__(self, stage, rows: list):
        self.stage, self.id, self.rows = stage, stage.id, rows

    def _kind(self, before, after, inp) -> str:
        if self.id != "MerkleExecute":
            return "clean" if inp.checkpoint == 0 else "incremental"
        if before is None:
            if after is not None:
                return "start"
            return "single-shot" if inp.checkpoint == 0 else "incremental"
        if before[:1] == b"S":
            return "storage chunk" if after[:1] == b"S" else "storage done"
        return "account chunk" if after is not None else "account chunk + stitch"

    def execute(self, provider, inp):
        import torch

        from reth_tpu_torch.metrics import pipeline_metrics, trie_metrics

        pipeline_metrics.last = trie_metrics.last = None
        before = provider.stage_progress("MerkleExecute")
        t0 = time.perf_counter()
        out = self.stage.execute(provider, inp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kind = self._kind(before, provider.stage_progress("MerkleExecute"), inp)
        self.rows.append(dict(stage=self.id, kind=kind, wall_s=round(wall, 4),
                              commit=pipeline_metrics.last,
                              nodes=(trie_metrics.last or {}).get("nodes", 0)))
        return out

    def unwind(self, provider, inp):
        t0 = time.perf_counter()
        self.stage.unwind(provider, inp)
        self.rows.append(dict(stage=self.id, kind="unwind",
                              wall_s=round(time.perf_counter() - t0, 4)))


class MerkleCell:
    """The MerkleStage path on a port ``MemDb``: ``plain_state(n_accounts,
    n_slots, seed)`` loaded into PlainAccountState / PlainStorageState with
    headers 0 and 1, driven by ``Pipeline(factory, [MerkleUnwindStage(c),
    AccountHashingStage(c), StorageHashingStage(c), MerkleStage(c)])`` with
    ``c = TrieCommitter(device="cuda")`` (kernel 1 through KeccakDevice;
    the rebuild's TurboCommitter on "device", kernels 2 and 3). Each
    header's root and each block's tables come from the CPU twin
    (``twin``, ``merkle_twin``'s result)."""

    def __init__(self, n_accounts: int, n_slots: int, seed: int, twin: dict):
        from reth_tpu_torch.primitives.types import Header
        from reth_tpu_torch.stages import (AccountHashingStage, MerkleStage, MerkleUnwindStage,
                                           StorageHashingStage)
        from reth_tpu_torch.storage import MemDb, ProviderFactory
        from reth_tpu_torch.trie.committer import TrieCommitter

        self.db = MemDb()
        self.factory = ProviderFactory(self.db)
        self.blocks = merkle_state(n_accounts, n_slots, seed, self.factory)
        with self.factory.provider() as p:
            self.n_accounts = p.tx.entry_count("PlainAccountState")
            self.n_slots = p.tx.entry_count("PlainStorageState")
        self.twin = {int(b): t for b, t in twin["tables"].items()}
        self.headers = {int(b): Header(number=int(b), state_root=bytes.fromhex(r))
                        for b, r in twin["roots"].items()}
        with self.factory.provider_rw() as p:
            p.insert_header(self.headers[1])
        self.snapshots = {0: self.db._tables}
        self.committer = TrieCommitter(device="cuda")
        self.merkle = MerkleStage(self.committer)
        self.rows: list[dict] = []
        self.stages = [TimedStage(s, self.rows) for s in (
            MerkleUnwindStage(self.committer), AccountHashingStage(self.committer),
            StorageHashingStage(self.committer), self.merkle)]

    def pipeline(self):
        from reth_tpu_torch.stages import Pipeline

        return Pipeline(self.factory, self.stages)

    def check(self, tables, block: int, what: str) -> None:
        """``tables`` (a published table map of the card's database) equal,
        row for row, to the twin's at ``block``."""
        from reth_tpu_torch.storage import MemDb

        db = MemDb()
        db._tables = tables
        got, want = table_digests(db), self.twin[block]
        if got != want:
            raise AssertionError(f"merkle cell, {what}: the card's tables differ from the "
                                 f"twin's at block {block}: {got} against {want}")
        log(f"merkle cell, {what}: every row of " + ", ".join(
            f"{name} ({want[name][0]})" for name in MERKLE_TABLES) + " equals the twin's "
            f"(block {block})")

    def report(self, what: str, rows: list) -> None:
        """Each stage iteration's wall and kind, each commit's stage times;
        the hashing stages' keys/s and the rebuild's hashed nodes/s."""
        for r in rows:
            line = f"merkle cell, {what}: {r['stage']} {r['kind']} {r['wall_s']:.4f} s"
            if r.get("commit"):
                c = r["commit"]
                line += (f"; commit {c['wall_s']} s = sweep {c['sweep_s']} (summed over the sweep "
                         f"threads) / pack {c['pack_s']} / dispatch {c['dispatch_s']} / fetch "
                         f"{c['fetch_s']} s, {c['windows']} windows, {c['jobs']} subtries, "
                         f"hashed by {c['backend']}, {r['nodes']} hashed nodes")
            log(line)
        walls: dict[str, float] = {}
        for r in rows:
            walls[r["stage"]] = walls.get(r["stage"], 0.0) + r["wall_s"]
        extra = ""
        if what == "merkle stage":
            msgs = {"AccountHashing": self.n_accounts, "StorageHashing": 2 * self.n_slots}
            extra = ", ".join(f"{sid} {msgs[sid] / walls[sid]:.1f} keys/s" for sid in msgs)
            nodes = sum(r.get("nodes", 0) for r in rows if r["stage"] == "MerkleExecute")
            extra += (f", MerkleExecute {nodes} hashed nodes by the turbo commits, "
                      f"{nodes / walls['MerkleExecute']:.1f} hashed nodes/s")
        log(f"merkle cell, {what}: stage walls " + ", ".join(
            f"{sid} {w:.3f} s" for sid, w in walls.items()) + (f"; {extra}" if extra else ""))

    def drive_stage(self) -> None:
        """Path "merkle stage": ``Pipeline.run(1)`` from checkpoint 0: the
        two hashing stages' clean scans, then the chunked rebuild."""
        self.pipeline().run(1)

    def check_stage(self) -> None:
        with self.factory.provider() as p:
            checkpoints = {s.id: p.stage_checkpoint(s.id) for s in self.stages}
            blob = p.stage_progress("MerkleExecute")
        if set(checkpoints.values()) != {1} or blob is not None or self.merkle.fallbacks:
            raise AssertionError(f"merkle stage: checkpoints {checkpoints}, progress blob "
                                 f"{blob!r}, fallbacks {self.merkle.fallbacks}")
        kinds = [r["kind"] for r in self.rows if r["stage"] == "MerkleExecute"]
        if "account chunk + stitch" not in kinds or "storage chunk" not in kinds:
            raise AssertionError(f"merkle stage did not take the chunked route: {kinds}")
        self.snapshots[1] = self.db._tables
        self.check(self.snapshots[1], 1, "merkle stage")
        log(f"merkle stage: checkpoints {json.dumps(checkpoints)}, progress blob cleared, "
            f"0 fallbacks, iterations {kinds}")

    def drive_incremental(self) -> dict:
        """Path "merkle incremental": each block's writes with its changesets
        and header (its own wall), then ``Pipeline.run(b)`` (the incremental
        route: the span is under the threshold); then ``Pipeline.unwind(1)``.
        The database after each step is kept (``after``) for ``check``."""
        import torch

        from _torch_helpers import apply_stage_block

        walls = {}
        self.after = {}
        for b in MERKLE_BLOCKS:
            t0 = time.perf_counter()
            apply_stage_block(self.factory, self.blocks[b], b, self.headers[b])
            t1 = time.perf_counter()
            self.pipeline().run(b)
            torch.cuda.synchronize()
            walls[f"block {b}"] = time.perf_counter() - t1
            walls[f"block {b} writes"] = t1 - t0
            self.after[b] = self.db._tables
        t0 = time.perf_counter()
        self.pipeline().unwind(1)
        torch.cuda.synchronize()
        walls["unwind to 1"] = time.perf_counter() - t0
        self.after["unwind"] = self.db._tables
        return walls

    def check_incremental(self) -> None:
        for b in MERKLE_BLOCKS:
            self.check(self.after[b], b, f"merkle incremental, block {b}")
        self.check(self.after["unwind"], 1, "merkle incremental, unwind to 1")

    def restore(self, n: int) -> None:
        """The card database as it was at snapshot ``n`` (0: before "merkle
        stage"; 1: block 1, before "merkle incremental")."""
        self.db._tables = self.snapshots[n]
        del self.rows[:]


# the live tip on the MerkleStage cell's database: each block's keys (its
# addresses and (address, slot) pairs) stream through
# SparseRootTask.on_state_update in LIVE_BURSTS seeded bursts, one a
# transaction; "proofs" asks PROOF_ACCOUNTS existing accounts (PROOF_OWNERS of
# them storage owners, with all their slots and one absent slot each) and
# PROOF_ABSENT absent addresses at block 1, the first PROOF_CHECKED targets
# also proved on the host
LIVE_BURSTS = 256
PROOF_ACCOUNTS, PROOF_OWNERS, PROOF_ABSENT, PROOF_CHECKED = 768, 256, 256, 64
LIVE_PATHS = ("live tip", "live tip cached", "live tip reused", "live tip service")


class LiveTip:
    """The live tip over the MerkleStage cell's database (``cell``, a
    ``MerkleCell`` after "merkle incremental"): blocks 2 and 3 as
    ``BlockExecutionOutput``s of the cell's own ``stage_block`` writes, each
    proved from read views of its parent's published tables (block 1's
    snapshot for block 2, the incremental route's block 2 for block 3; a
    fresh view for each proof worker), revealed and finished by a
    ``SparseRootTask`` on the card. Each block's root must be its header's
    (the twin's); its exported branch updates, written back onto the
    parent's tables (tests/_torch_helpers.py ``write_back_updates``), must
    leave AccountsTrie and StoragesTrie equal, row for row, to the
    incremental route's tables after the block, and its storage roots must
    be those HashedAccounts holds there."""

    def __init__(self, cell):
        sys.path.insert(0, os.path.join(HERE, "tests"))
        from _torch_helpers import stage_block_bursts, stage_block_output

        from reth_tpu_torch.evm import BlockChanges, BlockExecutionOutput
        from reth_tpu_torch.ops.fused_commit import DigestArena
        from reth_tpu_torch.trie.committer import TrieCommitter
        from reth_tpu_torch.trie.hot_cache import TrieNodeCache
        from reth_tpu_torch.trie.sparse import PreservedSparseTrie, sparse_worker_count

        self.cell = cell
        self.outputs = {b: stage_block_output(cell.blocks[b], BlockExecutionOutput, BlockChanges)
                        for b in MERKLE_BLOCKS}
        self.bursts = {b: stage_block_bursts(out, LIVE_BURSTS, seed=b)
                       for b, out in self.outputs.items()}
        self.parents = {2: cell.snapshots[1], 3: cell.after[2]}
        self.workers = sparse_worker_count(None)
        # path 1's lineage: its committer, preserved trie, node cache and arena
        self.committer = TrieCommitter(device="cuda")
        self.preserved = PreservedSparseTrie()
        self.cache = TrieNodeCache()
        self.arena = DigestArena()
        self.results: dict[str, dict] = {}
        out = self.outputs[2]
        log(f"live tip: blocks {list(MERKLE_BLOCKS)}, each {len(out.post_accounts)} account "
            f"writes ({sum(a is None for a in out.post_accounts.values())} deleted, "
            f"{len(out.changes.wiped_storage)} storage wipes), "
            f"{sum(len(s) for s in out.post_storage.values())} slot writes over "
            f"{len(out.post_storage)} owners, in {LIVE_BURSTS} bursts; {self.workers} proof "
            f"workers")

    @staticmethod
    def sync() -> None:
        import torch

        torch.cuda.synchronize()

    @staticmethod
    def view(tables):
        """A read-only factory over a published table map."""
        from reth_tpu_torch.storage import MemDb, ProviderFactory

        db = MemDb()
        db._tables = tables
        return ProviderFactory(db)

    def block(self, name: str, b: int, committer, preserved, cache=None, arena=None,
              keep: bool = False) -> dict:
        """Block ``b`` through a SparseRootTask: the proof pool over fresh
        views of the parent's tables, the bursts, then ``finish``; the wall
        runs from the first burst to the root. A SparseRootError fails the
        run with its cause. With ``keep``, after the root matched: preserve
        the trie under the header's hash and absorb into the cache."""
        import torch

        from reth_tpu_torch.engine import SparseRootError, SparseRootTask

        out = self.outputs[b]
        factory = self.view(self.parents[b])
        parent, header = self.cell.headers[b - 1], self.cell.headers[b]
        task = SparseRootTask(factory.provider(), parent.state_root, preserved, committer,
                              parent_hash=parent.hash, provider_factory=factory.provider,
                              workers=self.workers, hot_cache=cache, arena=arena)
        self.sync()
        t0 = time.perf_counter()
        for burst in self.bursts[b]:
            task.on_state_update(burst)
        try:
            root, digests, storage_roots = task.finish(out)
        except SparseRootError as e:
            cause = e.__cause__
            log(f"live tip, {name}: SparseRootError {e}; its cause: {cause!r}")
            raise AssertionError(f"live tip, {name}: the sparse path failed: {e} "
                                 f"(cause {cause!r})") from e
        self.sync()
        wall = time.perf_counter() - t0
        if root != header.state_root:
            raise AssertionError(f"live tip, {name}: block {b}'s root {root.hex()} is not its "
                                 f"header's {header.state_root.hex()} (the twin's)")
        if keep:
            task.preserve(header.hash)
            task.absorb_into_cache(out, digests)
        res = dict(name=name, b=b, task=task, wall=wall, digests=digests,
                   storage_roots=storage_roots, updates=task.export_updates(out, digests))
        self.results[name] = res
        return res

    def check(self, res: dict) -> None:
        """The block's exported updates written back onto its parent's
        tables: AccountsTrie and StoragesTrie equal to the incremental
        route's after the block; its storage roots HashedAccounts'."""
        from _torch_helpers import write_back_updates

        name, b = res["name"], res["b"]
        factory = self.view(self.parents[b])
        with factory.provider_rw() as p:
            write_back_updates(p, self.outputs[b], res["digests"], res["updates"])
        got, want = factory.db._tables, self.cell.after[b]
        for table in ("AccountsTrie", "StoragesTrie"):
            if got.get(table) != want.get(table):
                raise AssertionError(f"live tip, {name}: {table} written back from the sparse "
                                     f"trie differs from the incremental route's at block {b}")
        checked = 0
        with self.view(want).provider() as p:
            for a, sroot in res["storage_roots"].items():
                acc = p.hashed_account(res["digests"][a])
                if acc is not None:
                    checked += 1
                    if acc.storage_root != sroot:
                        raise AssertionError(f"live tip, {name}: the storage root of {a.hex()} "
                                             f"is not HashedAccounts' at block {b}")
        acct, stor = res["updates"]
        log(f"live tip, {name}: block {b}'s root is its header's; {len(acct)} account and "
            f"{sum(len(u) for u in stor.values())} storage branch updates written back leave "
            f"AccountsTrie ({len(want.get('AccountsTrie', {}))} rows) and StoragesTrie "
            f"({len(want.get('StoragesTrie', {}))} keys) equal to the incremental route's; "
            f"{checked} storage roots equal HashedAccounts'")

    def report(self, res: dict, launches: dict | None = None) -> None:
        task = res["task"]
        m = task.overlap_metrics()
        keys = ("hash", "proof", "reveal", "finish", "worker_busy", "proof_targets",
                "cache_unblinds", "proof_shards")
        log(f"live tip, {res['name']}: block {res['b']} in {res['wall']:.3f} s from the first "
            f"burst to the root; " + ", ".join(f"{k} {m[k]}" for k in keys)
            + f"; finish retries (spine fetches or cache unblinds) {task.retries}, proof batches "
            f"{task.proof_batches}, reused {task.reused}"
            + (f", launches {json.dumps(launches)}" if launches is not None else "")
            + f"; commit {json.dumps(m.get('commit'))}")

    def check_arena(self, arena, what: str) -> dict:
        """No fault, no leaked row and no pinned staging after the arena's
        epochs (as "sparse arena")."""
        snap = arena.snapshot()
        pinned = arena.engine.pinned_bytes() if arena.engine is not None else 0
        if snap["faults"] or snap["leaked_rows"] or pinned:
            raise AssertionError(f"live tip, {what}: the arena ends with a fault, a leaked row "
                                 f"or pinned staging: {snap}, pinned {pinned} B")
        log(f"live tip, {what}: arena {json.dumps(snap)}, pinned 0 B")
        return snap

    # -- the paths ------------------------------------------------------------

    def cold(self) -> dict:
        """Path "live tip": block 2 from a preserved trie holding nothing,
        with the node cache and the arena (kernels 1 and 4); preserved and
        absorbed once its root matched."""
        return self.block("live tip", 2, self.committer, self.preserved, self.cache,
                          self.arena, keep=True)

    def cached(self) -> dict:
        """Path "live tip cached": block 3 anchored cold on a fresh preserved
        trie, unblinding from path 1's cache, on a fresh arena; no absorb."""
        from reth_tpu_torch.ops.fused_commit import DigestArena
        from reth_tpu_torch.trie.sparse import PreservedSparseTrie

        self.cached_arena = DigestArena()
        return self.block("live tip cached", 3, self.committer, PreservedSparseTrie(),
                          self.cache, self.cached_arena)

    def reused(self) -> dict:
        """Path "live tip reused": block 3 on path 1's preserved trie, cache
        and arena (a delta epoch on block 2's rows); absorbs."""
        return self.block("live tip reused", 3, self.committer, self.preserved, self.cache,
                          self.arena, keep=True)

    def service(self) -> dict:
        """Path "live tip service": block 3 cold through the shared hash
        service set up as the reference's node sets it up (the committer's
        KeccakDevice as the backend, its hasher the live lane's client; the
        proofs ride the proof lane), no cache, no arena: the classic finish,
        kernel 1 on the service's dispatcher."""
        from reth_tpu_torch.metrics import MetricsRegistry
        from reth_tpu_torch.ops.hash_service import HashService
        from reth_tpu_torch.trie.committer import TrieCommitter
        from reth_tpu_torch.trie.sparse import PreservedSparseTrie

        c = TrieCommitter(device="cuda")
        svc = HashService(backend=c.hasher, registry=MetricsRegistry(), device="cuda")
        c.hash_service = svc
        c.hasher = svc.client("live")
        try:
            res = self.block("live tip service", 3, c, PreservedSparseTrie())
        finally:
            svc.stop()
        res["lanes"] = {lane: svc.metrics._msgs[lane].value for lane in ("live", "proof")}
        res["replays"] = svc.replays
        return res

    def proof_targets(self) -> dict:
        """"proofs"' 1,024 targets at block 1, seeded and shuffled: existing
        accounts (storage owners with all their slots and one absent slot
        each among them) and absent addresses."""
        tables = self.cell.snapshots[1]
        rng = np.random.default_rng(61)
        owner_rows = tables["PlainStorageState"]
        owners, accounts = list(owner_rows), list(tables["PlainAccountState"])
        picked = [owners[i] for i in rng.choice(len(owners), PROOF_OWNERS, replace=False)]
        others = [a for a in (accounts[i] for i in rng.choice(
            len(accounts), 2 * PROOF_ACCOUNTS, replace=False))
            if a not in owner_rows][:PROOF_ACCOUNTS - PROOF_OWNERS]
        targets = {a: [] for a in others}
        for a in picked:
            dups = owner_rows[a] if isinstance(owner_rows[a], list) else [owner_rows[a]]
            targets[a] = [d[:32] for d in dups] + [bytes(rng.integers(0, 256, 32, np.uint8))]
        for _ in range(PROOF_ABSENT):
            targets[bytes(rng.integers(0, 256, 20, np.uint8))] = []
        order = rng.permutation(len(targets))
        items = list(targets.items())
        return dict(items[i] for i in order)

    def proofs(self) -> dict:
        """Path "proofs": ``ProofWorkerPool`` over 4 workers, each a
        ProofCalculator on a fresh view of block 1 and a card committer,
        one multiproof of ``proof_targets``."""
        from reth_tpu_torch.trie.committer import TrieCommitter
        from reth_tpu_torch.trie.proof import ProofCalculator, ProofWorkerPool

        factory = self.view(self.cell.snapshots[1])
        targets = self.proof_targets()
        pool = ProofWorkerPool(lambda: ProofCalculator(factory.provider(),
                                                       TrieCommitter(device="cuda")),
                               workers=4)
        t0 = time.perf_counter()
        try:
            proofs = pool.multiproof(targets)
        finally:
            pool.shutdown()
        self.sync()
        self.proof_run = dict(targets=targets, proofs=proofs, wall=time.perf_counter() - t0,
                              shards=pool.shards_total)
        return self.proof_run

    def check_proofs(self) -> None:
        """Every account and storage proof verifies against header 1's
        root (absent accounts and slots as absent), and the first
        PROOF_CHECKED targets' proofs are byte-identical to a host
        ProofCalculator's (numpy hasher, device="cpu") on the same view."""
        from reth_tpu_torch.primitives.keccak import keccak256_batch_np
        from reth_tpu_torch.trie.committer import TrieCommitter
        from reth_tpu_torch.trie.proof import (ProofCalculator, verify_account_proof,
                                               verify_storage_proof)

        run = self.proof_run
        targets, proofs = run["targets"], run["proofs"]
        root = self.cell.headers[1].state_root
        t0 = time.perf_counter()
        if sorted(proofs) != sorted(targets):
            raise AssertionError("proofs: the pool answered other accounts than it was asked")
        n_storage = nodes = snodes = absent = 0
        for a, ap in proofs.items():
            if not verify_account_proof(root, a, ap):
                raise AssertionError(f"proofs: the account proof of {a.hex()} does not verify")
            absent += ap.account is None
            nodes += len(ap.proof)
            if [sp.key for sp in ap.storage_proofs] != targets[a]:
                raise AssertionError(f"proofs: {a.hex()}'s storage proofs are not in the "
                                     f"request's order")
            for sp in ap.storage_proofs:
                n_storage += 1
                snodes += len(sp.proof)
                if not verify_storage_proof(ap.storage_root, sp):
                    raise AssertionError(f"proofs: a storage proof of {a.hex()} does not verify")
        if absent != PROOF_ABSENT:
            raise AssertionError(f"proofs: {absent} absent accounts, {PROOF_ABSENT} asked")
        first = dict(list(targets.items())[:PROOF_CHECKED])
        host = ProofCalculator(self.view(self.cell.snapshots[1]).provider(),
                               TrieCommitter(hasher=keccak256_batch_np, device="cpu"))
        want = host.multiproof(first)
        if any(proofs[a] != want[a] for a in first):
            raise AssertionError(f"proofs: the first {PROOF_CHECKED} targets' proofs differ from "
                                 f"the host ProofCalculator's")
        log(f"proofs: {len(proofs)} account proofs ({absent} absent) and {n_storage} storage "
            f"proofs in {run['wall']:.3f} s over {run['shards']} shards, "
            f"{len(proofs) / run['wall']:.1f} account proofs/s, mean nodes a proof: "
            f"{nodes / len(proofs):.2f} (account), {snodes / max(1, n_storage):.2f} (storage); "
            f"every proof verifies against header 1's root ({time.perf_counter() - t0:.1f} s), "
            f"the first {PROOF_CHECKED} targets' byte-identical to the host ProofCalculator's")

    def finish_checks(self) -> None:
        """The checks across paths: "live tip cached" unblinds from the
        cache and asks fewer proof targets than "live tip service" (the same
        block, cold, no cache); "live tip reused" reused path 1's trie;
        "live tip service" moved the live and proof lanes with no replay;
        path 1's arena and path 2's end clean."""
        r = self.results
        cached, service = r["live tip cached"]["task"], r["live tip service"]["task"]
        if not cached.cache_unblinds or cached.proof_targets >= service.proof_targets:
            raise AssertionError(f"live tip cached: cache_unblinds {cached.cache_unblinds}, "
                                 f"proof_targets {cached.proof_targets} against "
                                 f"{service.proof_targets} without the cache")
        if not r["live tip reused"]["task"].reused or r["live tip"]["task"].reused:
            raise AssertionError("live tip: path 3 did not reuse path 1's preserved trie")
        lanes = r["live tip service"]["lanes"]
        if not (lanes["live"] and lanes["proof"]) or r["live tip service"]["replays"]:
            raise AssertionError(f"live tip service: lanes {lanes}, replays "
                                 f"{r['live tip service']['replays']}")
        self.check_arena(self.arena, "path 1's arena after blocks 2 and 3")
        self.check_arena(self.cached_arena, "live tip cached's arena")
        log(f"live tip: cached {cached.cache_unblinds} cache unblinds, {cached.proof_targets} "
            f"proof targets against {service.proof_targets} without the cache; service lanes "
            f"{json.dumps(lanes)}, 0 replays; reused on path 3")


# the staged sync ("sync"): a chain sealed on the host in a child process
# (tests/_torch_helpers.py SyncChain: SYNC_WALLETS wallets, SYNC_BLOCKS blocks
# of SYNC_BLOCK, on plain_state(--sync-accounts, --sync-slots, SYNC_SEED)),
# then on the card init_genesis, import_chain and default_stages to the tip,
# the unwind to SYNC_UNWIND_TO and the re-sync
SYNC_WALLETS, SYNC_BLOCKS, SYNC_SEED, SYNC_UNWIND_TO = 1024, 8, 47, 4
# the payload path's batches: signed by the same child after the chain's
# blocks, left unsealed (blocks 9-11 are built on the card)
PAYLOAD_BATCHES = 3
# the "rpc" path's block 12: one more unsealed batch, after the payload path's
RPC_BATCHES = 1
# the transactions the payload path's pool must refuse, with its messages
REFUSED = ("nonce too low", "replacement underpriced", "wrong chain id 5 (expected 1)")


def sync_chain(n_accounts: int, n_slots: int, out_path: str) -> int:
    """The "sync" path's chain, in a child process of its own
    (``--sync-chain``), started with the smoke so that it runs beside the
    card's earlier paths: the port's ChainBuilder seals each block by
    executing it and rooting the whole state on TrieCommitter(
    hasher=keccak256_batch_np, device="cpu"), the numpy twin, never the card.
    Writes the genesis header, the genesis alloc's plain fields, the chain
    file (``export_rlp``), each block's signing addresses, roots, gas and
    the seal walls to ``out_path`` as JSON. Then signs PAYLOAD_BATCHES +
    RPC_BATCHES more batches of SYNC_BLOCK from the same wallets at their next
    nonces (the payload path's blocks 9-11, the rpc path's block 12), unsealed, and the three transactions its
    pool must refuse (REFUSED: wallet 0 at nonce 0; batch 9's first
    transaction again at its fee; wallet 1 on chain id 5), all as raw RLP."""
    import types

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _torch_helpers import SYNC_BLOCK, SyncChain

    from reth_tpu_torch import testing
    from reth_tpu_torch.convert import alloc_to_fields
    from reth_tpu_torch.primitives import keccak, secp256k1
    from reth_tpu_torch.primitives import types as ptypes
    from reth_tpu_torch.trie.committer import TrieCommitter

    pkg = types.SimpleNamespace(testing=testing, types=ptypes, keccak=keccak,
                                secp256k1=secp256k1)
    t0 = time.perf_counter()
    chain = SyncChain(pkg, n_accounts, n_slots, SYNC_SEED, SYNC_WALLETS, SYNC_BLOCKS,
                      SYNC_BLOCK, TrieCommitter(hasher=keccak.keccak256_batch_np, device="cpu"),
                      seal=False, spare=PAYLOAD_BATCHES + RPC_BATCHES)
    b = chain.builder
    walls = {"genesis": time.perf_counter() - t0}
    log(f"sync chain: genesis of {len(b.accounts_at_genesis)} accounts and "
        f"{sum(len(s) for s in b.storage_at_genesis.values())} slots rooted in "
        f"{walls['genesis']:.3f} s, root {b.genesis.state_root.hex()}")
    for _ in range(SYNC_BLOCKS):
        t0 = time.perf_counter()
        blk = chain.block()
        h = blk.header
        walls[h.number] = time.perf_counter() - t0
        log(f"sync chain: block {h.number} sealed in {walls[h.number]:.3f} s: "
            f"{len(blk.transactions)} transactions, {h.gas_used} gas, "
            f"{len(blk.withdrawals)} withdrawals, root {h.state_root.hex()}")
    t0 = time.perf_counter()
    batches = []
    for _ in range(PAYLOAD_BATCHES + RPC_BATCHES):
        n, txs, wds = chain.batch()
        batches.append({"number": n, "txs": [tx.encode().hex() for tx in txs],
                        "senders": [a.hex() for a in chain.senders[n]],
                        "withdrawals": [[w.index, w.validator_index, w.address.hex(), w.amount]
                                        for w in wds]})
    first = ptypes.Transaction.decode(bytes.fromhex(batches[0]["txs"][0]))
    w0, w1 = chain.wallets[0], chain.wallets[1]
    refused = [testing.Wallet(w0.priv, nonce=0).transfer(b"\x0f" * 20, 1),
               w0.sign_tx(ptypes.Transaction(tx_type=first.tx_type, chain_id=first.chain_id,
                                             nonce=first.nonce, gas_price=first.gas_price,
                                             gas_limit=first.gas_limit, to=first.to,
                                             value=first.value + 1), bump_nonce=False),
               testing.Wallet(w1.priv, nonce=w1.nonce).transfer(b"\x0f" * 20, 1, chain_id=5)]
    # the launch-fault drill's transaction: wallet 2 at its next nonce
    drill = chain.wallets[2].transfer(b"\x0f" * 20, 1)
    walls["batches"] = time.perf_counter() - t0
    log(f"sync chain: {PAYLOAD_BATCHES + RPC_BATCHES} more batches of "
        f"{[len(x['txs']) for x in batches]} transactions signed (unsealed) in "
        f"{walls['batches']:.3f} s")
    fields = alloc_to_fields(b.accounts_at_genesis, b.storage_at_genesis, b.codes_at_genesis)
    out = {
        "batches": batches, "refused": [tx.encode().hex() for tx in refused],
        "drill": drill.encode().hex(),
        "genesis": b.genesis.encode().hex(), "genesis_hash": b.genesis.hash.hex(),
        "alloc": {a.hex(): [f["nonce"], str(f["balance"]), f.get("code", b"").hex(),
                            {k.hex(): str(v) for k, v in f.get("storage", {}).items()}]
                  for a, f in fields.items()},
        "chain": b.export_rlp().hex(),
        "senders": {n: [a.hex() for a in s] for n, s in chain.senders.items()
                    if n <= SYNC_BLOCKS},
        "roots": {blk.header.number: blk.header.state_root.hex() for blk in b.blocks},
        "walls": walls,
    }
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


class Background:
    """``fn`` on a thread of its own, started at once; ``result`` joins it
    and raises what it raised."""

    def __init__(self, name: str, fn):
        self.name, self.out, self.err = name, None, None
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, args=(fn,), name=f"smoke-{name}",
                                       daemon=True)
        self.thread.start()

    def _run(self, fn) -> None:
        try:
            self.out = fn()
        except BaseException as e:  # re-raised by result() on the main thread
            self.err = e

    def result(self):
        t0 = time.perf_counter()
        self.thread.join()
        log(f"{self.name}: done in the background after {time.perf_counter() - self.t0:.1f} s "
            f"(waited {time.perf_counter() - t0:.1f} s for it)")
        if self.err is not None:
            raise AssertionError(f"the {self.name} phase failed: {self.err!r}") from self.err
        return self.out


class ChildProcess:
    """One of the smoke's child processes (``flag OUT`` plus ``extra``
    arguments), started at once; ``result`` waits for it, logs its output
    under ``name`` and returns its JSON. ``stop`` ends it."""

    def __init__(self, name: str, flag: str, extra: list[str]):
        base = os.path.join(HERE, "reth_tpu_torch", "build")
        os.makedirs(base, exist_ok=True)
        self.name = name
        self.out = os.path.join(base, f"{flag.strip('-')}-{os.getpid()}.json")
        self.log = self.out[:-5] + ".log"
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, self.out, *extra],
                stdout=f, stderr=subprocess.STDOUT, cwd=HERE)
        self.t0 = time.perf_counter()

    def result(self) -> dict:
        t0 = time.perf_counter()
        rc = self.proc.wait()
        with open(self.log) as f:
            for line in f.read().splitlines():
                log(f"  ({self.name}) {line}")
        if rc != 0:
            raise AssertionError(f"the {self.name}'s child process exited {rc}")
        with open(self.out) as f:
            res = json.load(f)
        for path in (self.out, self.log):
            os.remove(path)
        log(f"{self.name}: child process done after {time.perf_counter() - self.t0:.1f} s "
            f"(waited {time.perf_counter() - t0:.1f} s for it)")
        return res

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def device_profile(label: str, drive) -> dict:
    """``drive`` under torch.profiler: the card's busy time by kernel and
    copy, its host-to-device copy time and its idle share of the wall,
    logged and returned. The profiler's kernel records are counted against
    the wrappers' launch counts; where it missed some, its device times are
    a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from reth_tpu_torch.ops import fused_commit as fc
    from reth_tpu_torch.ops import keccak as ok

    wrappers = (ok.keccak256_words_masked, fc.packed_level, fc.branch_level, fc.subtrie_levels)
    torch.cuda.synchronize()
    before = sum(w.launches for w in wrappers)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = sum(w.launches for w in wrappers) - before
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    seen = sum(r[2] for r in rows if r[0].split("(")[0] in [k + "_kernel" for k in KERNELS])
    busy_us = sum(r[1] for r in rows)
    if seen < launched:
        log(f"profiled {label}: the profiler recorded {seen} of {launched} kernel launches; the "
            f"device times below are a lower bound")
    if busy_us == 0:
        log(f"profiled {label}: {wall:.3f} s wall; device time not measured "
            f"(the profiler recorded no device activity)")
        return {"wall_s": wall, "busy_ms": None, "idle_share": None}
    h2d = [r for r in rows if "HtoD" in r[0]]
    idle = 1 - busy_us / 1e6 / wall
    log(f"profiled {label}: {wall:.3f} s wall, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {idle:.4f}; host-to-device "
        f"{sum(r[1] for r in h2d) / 1e3:.3f} ms in {sum(r[2] for r in h2d)} copies")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
        log(f"  device {us / 1e3:10.3f} ms  {count:6d} x  {key[:80]}")
    return {"wall_s": wall, "busy_ms": busy_us / 1e3, "idle_share": idle}


def host_profile(label: str, fn, *args, focus=()):
    """``fn(*args)`` under cProfile, the card synchronized before the clock
    stops: its wall, the ten functions by own time and the cumulative time
    of the functions named in ``focus``, logged; returns what ``fn``
    returned."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    out = prof.runcall(fn, *args)
    torch.cuda.synchronize()
    log(f"host profile, {label} ({time.perf_counter() - t0:.3f} s wall under cProfile, all "
        f"threads: cumulative times of concurrent threads overlap), top functions by own time:")
    stats = pstats.Stats(prof)
    for (fname, line, func), (_cc, ncalls, tottime, cumtime, _callers) in sorted(
            stats.stats.items(), key=lambda kv: -kv[1][2])[:10]:
        log(f"  host {tottime:8.3f} s own, {cumtime:8.3f} s cum, {ncalls:8d} calls  "
            f"{os.path.basename(fname)}:{line} {func}")
    for (fname, line, func), (_cc, ncalls, tottime, cumtime, _callers) in stats.stats.items():
        if func in focus:
            log(f"  host {cumtime:8.3f} s cum, {ncalls:8d} calls  {os.path.basename(fname)}:{line} "
                f"{func} (asked for)")
    return out


class SyncCell:
    """The "sync" path on a port ``MemDb``: the chain the child sealed on the
    host (``sync_chain``), synced on the card through the entry points an
    operator's ``reth import`` + ``stage run`` call: ``init_genesis``
    (device="cuda"), ``import_chain`` with ``EthBeaconConsensus(
    device="cuda")`` (every block pre-validated, its transactions and
    withdrawals roots on kernel 1), ``Pipeline(factory, default_stages(
    device="cuda")).run(SYNC_BLOCKS)`` (senders by the native batch,
    execution on the host with post-validation on kernel 1, the hashing
    stages on kernel 1, MerkleStage from checkpoint 0 on kernels 2 and 3
    against the child's header root, tx lookup, both history indexes,
    Finish), ``unwind(SYNC_UNWIND_TO)`` (the Merkle unwind against that
    header's root) and ``run(SYNC_BLOCKS)`` again under torch.profiler.
    Between the unwind and the re-sync, one block's execution under
    cProfile, read-only."""

    def __init__(self, res: dict):
        from reth_tpu_torch.convert import alloc_from_fields, blocks_from_rlp
        from reth_tpu_torch.primitives.types import Header, Transaction, Withdrawal

        t0 = time.perf_counter()
        fields = {bytes.fromhex(a): {"nonce": n, "balance": int(bal), "code": bytes.fromhex(c),
                                     "storage": {bytes.fromhex(k): int(v) for k, v in st.items()}}
                  for a, (n, bal, c, st) in res["alloc"].items()}
        self.accounts, self.storage, self.codes = alloc_from_fields(fields)
        self.genesis = Header.decode(bytes.fromhex(res["genesis"]))
        self.blocks = blocks_from_rlp(bytes.fromhex(res["chain"]))
        self.senders = {int(b): [bytes.fromhex(a) for a in s] for b, s in res["senders"].items()}
        self.roots = {int(b): r for b, r in res["roots"].items()}
        # the payload path's unsealed batches: (number, transactions,
        # withdrawals, signing addresses), the refused and the drill's
        tx = lambda raw: Transaction.decode(bytes.fromhex(raw))  # noqa: E731
        self.batches = [(b["number"], [tx(r) for r in b["txs"]],
                         tuple(Withdrawal(i, v, bytes.fromhex(a), amt)
                               for i, v, a, amt in b["withdrawals"]),
                         [bytes.fromhex(a) for a in b["senders"]]) for b in res["batches"]]
        self.refused = [tx(r) for r in res["refused"]]
        self.drill_tx = tx(res["drill"])
        if self.genesis.hash.hex() != res["genesis_hash"] or [
                blk.header.state_root.hex() for blk in self.blocks] != [
                self.roots[b] for b in range(1, SYNC_BLOCKS + 1)]:
            raise AssertionError("sync: the chain file does not carry the child's seal")
        self.n_txs = sum(len(blk.transactions) for blk in self.blocks)
        self.gas = {blk.header.number: blk.header.gas_used for blk in self.blocks}
        self.rows: list[dict] = []
        self.walls: dict[str, float] = {}
        log(f"sync: the child's chain loaded in {time.perf_counter() - t0:.1f} s: "
            f"{len(self.accounts)} genesis accounts, {sum(len(s) for s in self.storage.values())} "
            f"slots, {len(self.blocks)} blocks of {self.n_txs} transactions and "
            f"{sum(self.gas.values())} gas")

    def drive(self) -> None:
        """Path "sync", each step's wall kept in ``walls``."""
        import torch

        from reth_tpu_torch.consensus import EthBeaconConsensus
        from reth_tpu_torch.stages import Pipeline, default_stages
        from reth_tpu_torch.storage import MemDb, ProviderFactory
        from reth_tpu_torch.storage.genesis import import_chain, init_genesis

        def step(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.walls[name] = time.perf_counter() - t0
            return out

        self.db = MemDb()
        self.factory = ProviderFactory(self.db)
        step("init_genesis", lambda: init_genesis(
            self.factory, self.genesis, self.accounts, storage=self.storage, codes=self.codes,
            device="cuda"))
        self.genesis_tables = self.db._tables  # the engine paths start from it
        step("import", lambda: import_chain(self.factory, self.blocks,
                                            EthBeaconConsensus(device="cuda")))
        self.stages = default_stages(device="cuda")
        self.merkle = self.stages[5]
        self.pipeline = Pipeline(self.factory, [TimedStage(s, self.rows) for s in self.stages])
        step("run", self.pipeline.run, SYNC_BLOCKS)
        self.first = self.db._tables
        self.first_rows = len(self.rows)
        step("unwind", self.pipeline.unwind, SYNC_UNWIND_TO)
        self.unwound = self.db._tables  # the cut engine paths' tables
        self.profile_block(SYNC_UNWIND_TO + 1)
        self.resync = step("re-sync", device_profile, "sync re-sync",
                           lambda: self.pipeline.run(SYNC_BLOCKS))
        # the step's wall less the profiler's own processing after the run
        self.walls["re-sync profiler processing"] = self.walls["re-sync"] - self.resync["wall_s"]
        self.walls["re-sync"] = self.resync["wall_s"]

    def profile_block(self, n: int) -> None:
        """Block ``n``'s execution on the state of block ``n - 1`` (the
        unwound database, read-only) under cProfile, with the child's
        senders; its output is dropped."""
        from reth_tpu_torch.evm import BlockExecutor, EvmConfig
        from reth_tpu_torch.evm.executor import ProviderStateSource

        with self.factory.provider() as p:
            hashes = {h: p.canonical_hash(h) for h in range(max(0, n - 256), n)}
            executor = BlockExecutor(ProviderStateSource(p), EvmConfig())
            out = host_profile(f"sync, block {n}'s execution", executor.execute,
                               self.blocks[n - 1], self.senders[n], hashes)
        if out.gas_used != self.gas[n]:
            raise AssertionError(f"sync: block {n} re-executed to {out.gas_used} gas, its "
                                 f"header says {self.gas[n]}")

    def check(self) -> None:
        """The re-synced tables equal the first sync's, row for row (every
        table the stages write, by row counts and SHA-256 of the rows in key
        order); every checkpoint at the tip; the recovered senders the
        signing wallets'; 0 MerkleStage fallbacks."""
        from reth_tpu_torch.storage import MemDb
        from reth_tpu_torch.storage.tables import be64

        first, now = MemDb(), self.db
        first._tables = self.first
        names = sorted(n for n, t in self.first.items() if t)
        want, got = table_digests(first, names), table_digests(now, names)
        if got != want or sorted(n for n, t in now._tables.items() if t) != names:
            raise AssertionError(f"sync: the re-synced tables differ from the first sync's: "
                                 f"{got} against {want}")
        with self.factory.provider() as p:
            checkpoints = {s.id: p.stage_checkpoint(s.id) for s in self.stages}
            recovered = {}
            for n in range(1, SYNC_BLOCKS + 1):
                idx = p.block_body_indices(n)
                recovered[n] = [p.tx.get("TransactionSenders", be64(t))
                                for t in range(idx.first_tx_num, idx.next_tx_num)]
        if set(checkpoints.values()) != {SYNC_BLOCKS}:
            raise AssertionError(f"sync: checkpoints {checkpoints}")
        if recovered != self.senders:
            raise AssertionError("sync: a recovered sender is not the signing wallet's address")
        if self.merkle.fallbacks:
            raise AssertionError(f"sync: {self.merkle.fallbacks} MerkleStage fallbacks")
        log(f"sync: after the re-sync every row of {len(names)} tables equals the first sync's ("
            + ", ".join(f"{n} {want[n][0]}" for n in names) + f"); checkpoints "
            f"{json.dumps(checkpoints)}; all {self.n_txs} recovered senders the signing wallets'; "
            f"all {SYNC_BLOCKS} blocks passed the card's consensus checks (transactions and "
            f"withdrawals roots at import, receipts root, gas and bloom after execution); "
            f"0 MerkleStage fallbacks; MerkleStage met header {SYNC_BLOCKS}'s root "
            f"{self.roots[SYNC_BLOCKS]} and the unwind header {SYNC_UNWIND_TO}'s "
            f"{self.roots[SYNC_UNWIND_TO]} (the child's seal on the host)")

    def report(self, launches: dict) -> None:
        """Each step's and each stage's wall; senders/s, the Execution stage's
        Mgas/s and transactions/s, the MerkleStage rebuild's hashed nodes/s;
        kernel launches by kernel."""
        for r in self.rows:
            line = f"sync: {r['stage']} {r['kind']} {r['wall_s']:.4f} s"
            if r.get("commit"):
                c = r["commit"]
                line += (f"; commit {c['wall_s']} s = sweep {c['sweep_s']} / pack {c['pack_s']} / "
                         f"dispatch {c['dispatch_s']} / fetch {c['fetch_s']} s, hashed by "
                         f"{c['backend']}, {r['nodes']} hashed nodes")
            log(line)
        for what, rows in (("sync", self.rows[:self.first_rows]),
                           ("re-sync", [r for r in self.rows[self.first_rows:]
                                        if r["kind"] != "unwind"])):
            walls: dict[str, float] = {}
            for r in rows:
                walls[r["stage"]] = walls.get(r["stage"], 0.0) + r["wall_s"]
            blocks = range(1, SYNC_BLOCKS + 1) if what == "sync" else range(
                SYNC_UNWIND_TO + 1, SYNC_BLOCKS + 1)
            txs = sum(len(self.blocks[b - 1].transactions) for b in blocks)
            gas = sum(self.gas[b] for b in blocks)
            ex = walls["Execution"]
            extra = (f"; SenderRecovery {txs / walls['SenderRecovery']:.1f} senders/s, Execution "
                     f"{gas / ex / 1e6:.3f} Mgas/s and {txs / ex:.1f} transactions/s "
                     f"({len(blocks)} blocks, {txs} transactions, {gas} gas)")
            nodes = sum(r.get("nodes", 0) for r in rows if r["stage"] == "MerkleExecute")
            if nodes:
                extra += (f", MerkleExecute {nodes} hashed nodes, "
                          f"{nodes / walls['MerkleExecute']:.1f} hashed nodes/s")
            log(f"sync, {what}: stage walls " + ", ".join(
                f"{sid} {w:.3f} s" for sid, w in walls.items()) + extra)
        log("sync: step walls " + ", ".join(f"{k} {v:.3f} s" for k, v in self.walls.items())
            + f"; launches {json.dumps(launches)}")


# the "recovery" path's static files: blocks 0 to SYNC_UNWIND_TO - 1 moved into
# jars before the interrupted unwind
RECOVERY_JARS_TO = SYNC_UNWIND_TO - 1


def store_digests(db, names) -> dict:
    """``table_digests`` of a MemDb, or of a native store walked by its
    cursors (a DUPSORT key's values come in order, one entry each)."""
    if hasattr(db, "_tables"):
        return table_digests(db, names)
    import hashlib

    out = {}
    with db.tx() as tx:
        for name in names:
            h, n, key, vals = hashlib.sha256(), 0, None, []

            def fold():
                h.update(len(key).to_bytes(4, "little") + key + len(vals).to_bytes(4, "little"))
                for x in vals:
                    h.update(len(x).to_bytes(4, "little") + x)

            for k, v in tx.cursor(name).walk():
                if k != key and key is not None:
                    fold()
                    vals = []
                key = k
                vals.append(v)
                n += 1
            if key is not None:
                fold()
            out[name] = [n, h.hexdigest()]
    return out


class RecoveryCell:
    """The "recovery" path: startup recovery (``storage/recovery.py
    recover_on_startup``) over datadirs made from the "sync" path's database
    at block 8, through the entry points a node calls at start
    (``attach_wal``, then ``recover_on_startup``). Every committer on the
    path is on the card. Legs:

    a) an interrupted unwind healed: the sync's tables as a ``MemDb`` image
       with a WAL attached (``attach_wal``), ``StaticFileProducer.run(
       to_block=RECOVERY_JARS_TO)`` into ``static_files/``, one checkpoint
       (the manifest pins the jars' digests); then the engine tree's crash
       window (``EngineTree._unwind_persisted_to``): the unwind marker for
       SYNC_UNWIND_TO and ``Pipeline(factory, default_stages(
       device="cuda")).unwind(SYNC_UNWIND_TO)`` through the WAL, no canonical
       surgery; one byte of the receipts jar flipped and an orphan ``*.tmp``
       beside it. Reopened (a new ``MemDb`` on the image, ``attach_wal``
       replaying), ``recover_on_startup(committer=TrieCommitter(fused=True,
       device="cuda"), static_dir=)``.
    b) corruption caught by the root check: a bad-CRC record rewriting one
       ``HashedAccounts`` row (``chaos.inject_bad_crc_record``, the
       reference test's record with an account that decodes) read by the
       broken reader (``RETH_TPU_FAULT_WAL_ACCEPT_TORN=1`` for that reopen
       only) must fail recovery on a state-root mismatch; injected again, the
       correct reader discards it as a torn tail (recovered with
       ``verify_root=False``: leg a verified these tables).
    c) the node's default engine: leg a's healed tables copied into a
       ``PagedDb`` datadir, the canonical headers of blocks 5-8 put back,
       every stage checkpoint left at SYNC_UNWIND_TO (what an unwind leaves
       when its marker was already cleared); ``recover_on_startup`` (no
       durability: ``attach_wal`` returns None for the engine; no root
       check, cut for the time limit), then the store closed and
       reopened."""

    def __init__(self, sync: "SyncCell"):
        self.sync = sync
        self.dir = Path(HERE) / "reth_tpu_torch" / "build" / f"recovery-{os.getpid()}"
        self.walls: dict[str, float] = {}

    def drive(self) -> None:
        """Path "recovery": legs a-c, each leg's wall and kernel counts kept."""
        for leg, fn in (("a", self.leg_a), ("b", self.leg_b), ("c", self.leg_c)):
            before = kernel_launches()
            t0 = time.perf_counter()
            fn()
            torch_sync()
            self.walls[leg] = time.perf_counter() - t0
            after = kernel_launches()
            log(f"recovery, leg {leg}: {self.walls[leg]:.3f} s, launches "
                f"{json.dumps({k: after[k] - before[k] for k in after})}; {host_memory()}")

    def close(self) -> None:
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)

    def _recover(self, leg: str, factory, **kw) -> dict:
        from reth_tpu_torch.storage.recovery import recover_on_startup
        from reth_tpu_torch.trie.committer import TrieCommitter

        t0 = time.perf_counter()
        report = recover_on_startup(factory, committer=TrieCommitter(fused=True, device="cuda"),
                                    **kw)
        torch_sync()
        self.walls[f"{leg} recover_on_startup"] = time.perf_counter() - t0
        log(f"recovery, leg {leg}: recover_on_startup {time.perf_counter() - t0:.3f} s, "
            f"{host_memory()}: "
            + json.dumps({k: v for k, v in report.items() if k != "manifest_head"},
                         default=str))
        if report["fallbacks"]:
            raise AssertionError(f"recovery, leg {leg}: fallbacks {report['fallbacks']}")
        return report

    def _reopen(self, d: Path):
        from reth_tpu_torch.storage import MemDb, ProviderFactory
        from reth_tpu_torch.storage.wal import attach_wal

        t0 = time.perf_counter()
        db = MemDb(d / "db.bin")
        dur = attach_wal(db, d / "wal", static_dir=d / "static_files")
        log(f"recovery: reopened {d.name} in {time.perf_counter() - t0:.3f} s (the image and "
            f"the WAL's replay: {json.dumps(dur.replay_report())})")
        return db, ProviderFactory(db), dur

    def leg_a(self) -> None:
        from reth_tpu_torch.stages import Pipeline, default_stages
        from reth_tpu_torch.storage import MemDb, ProviderFactory
        from reth_tpu_torch.storage.nippyjar import NippyJar
        from reth_tpu_torch.storage.recovery import UNWIND_MARKER_KEY
        from reth_tpu_torch.storage.static_files import StaticFileProducer, StaticFileProvider
        from reth_tpu_torch.storage.tables import Tables, from_be64
        from reth_tpu_torch.storage.wal import attach_wal

        d = self.dir / "a"
        static = d / "static_files"
        d.mkdir(parents=True)
        t0 = time.perf_counter()
        db = MemDb(d / "db.bin")
        db._tables, db._dirty = self.sync.db._tables, True  # the sync's map at block 8
        db.flush()
        dur = attach_wal(db, d / "wal", static_dir=static)
        factory = ProviderFactory(db)
        moved = StaticFileProducer(factory, static).run(to_block=RECOVERY_JARS_TO)
        with factory.provider() as p:
            head = p.canonical_hash(SYNC_BLOCKS)
        dur.checkpoint(head=(SYNC_BLOCKS, head))
        self.walls["a datadir"] = time.perf_counter() - t0
        log(f"recovery, leg a: datadir written in {self.walls['a datadir']:.3f} s: image "
            f"{(d / 'db.bin').stat().st_size} B, jars {json.dumps(moved)}, manifest "
            f"{(d / 'wal' / 'MANIFEST.json').read_text()}")
        # the engine tree's crash window: the marker, the pipeline's unwind
        # committed through the WAL, the canonical surgery never run
        t0 = time.perf_counter()
        with factory.provider_rw() as p:
            p.tx.put(Tables.Metadata.name, UNWIND_MARKER_KEY, SYNC_UNWIND_TO.to_bytes(8, "big"))
        Pipeline(factory, default_stages(device="cuda")).unwind(SYNC_UNWIND_TO)
        torch_sync()
        self.walls["a unwind"] = time.perf_counter() - t0
        snap = dur.snapshot()
        dur.close()  # the crash: nothing more reaches the disk
        receipts = next(static.glob("receipts_*.sf"))
        raw = bytearray(receipts.read_bytes())
        raw[-1] ^= 0xFF
        receipts.write_bytes(bytes(raw))
        orphan = static / f"headers_{RECOVERY_JARS_TO + 1}_{SYNC_BLOCKS}.sf.tmp"
        orphan.write_bytes(b"half-written")
        log(f"recovery, leg a: the interrupted unwind {self.walls['a unwind']:.3f} s, WAL "
            f"{json.dumps(snap)}; {receipts.name} bit-rotted, {orphan.name} left")

        db2, factory2, dur2 = self._reopen(d)
        report = self._recover("a", factory2, durability=dur2, static_dir=static)
        healed = f"completed interrupted unwind {SYNC_BLOCKS} -> {SYNC_UNWIND_TO}"
        if report["status"] != "degraded" or healed not in report["healed"] \
                or report["head_number"] != SYNC_UNWIND_TO or report["root_verified"] is not True:
            raise AssertionError(f"recovery, leg a: {report}")
        with factory2.provider() as p:
            if p.tx.get(Tables.Metadata.name, UNWIND_MARKER_KEY) is not None:
                raise AssertionError("recovery, leg a: the unwind marker is still set")
            tip = p.last_block_number()
        tops = {t: max(from_be64(k) for k in db2._tables[t])
                for t in (Tables.Headers.name, Tables.CanonicalHeaders.name)}
        if tip != SYNC_UNWIND_TO or set(tops.values()) != {SYNC_UNWIND_TO}:
            raise AssertionError(f"recovery, leg a: the header tables end at {tops}, tip {tip}")
        corrupt = receipts.with_suffix(".sf.corrupt")
        if receipts.exists() or not corrupt.exists() or orphan.exists() \
                or str(corrupt) not in report["quarantined"]:
            raise AssertionError(f"recovery, leg a: the receipts jar was not quarantined, or "
                                 f"the orphan not removed: {sorted(os.listdir(static))}")
        jar = NippyJar.open(next(static.glob("transactions_*.sf")))
        verified = jar.verify()
        jar.close()
        served = ProviderFactory(db2, StaticFileProvider(static)).provider()
        txs = {n: [t.hash for t in served.transactions_by_block(n)]
               for n in range(1, RECOVERY_JARS_TO + 1)}
        if not verified or txs != {n: [t.hash for t in self.sync.blocks[n - 1].transactions]
                                   for n in txs}:
            raise AssertionError("recovery, leg a: the transactions jar does not verify or "
                                 "does not serve the sync's transactions")
        unwound = MemDb()
        unwound._tables = self.sync.unwound
        want, got = table_digests(unwound, ENGINE_TABLES), table_digests(db2, ENGINE_TABLES)
        if got != want:
            raise AssertionError(f"recovery, leg a: tables differ from the sync's after its "
                                 f"unwind to {SYNC_UNWIND_TO}: {got} against {want}")
        self.healed, self.engine_digests = db2, got
        log(f"recovery, leg a: {healed}, root verified at {SYNC_UNWIND_TO} on the card, the "
            f"marker cleared, the header tables ending at {SYNC_UNWIND_TO}, {receipts.name} "
            f"quarantined and the orphan removed, the transactions jar verified and serving "
            f"blocks 1-{RECOVERY_JARS_TO}, {sum(map(len, txs.values()))} transactions, every "
            f"row of " + ", ".join(f"{n} {got[n][0]}" for n in ENGINE_TABLES)
            + " equal to the sync's after its unwind; 0 fallbacks")

    def leg_b(self) -> None:
        import dataclasses

        from reth_tpu_torch.chaos import inject_bad_crc_record
        from reth_tpu_torch.storage.tables import Tables, decode_account, encode_account

        d = self.dir / "a"
        key, raw = min(self.healed._tables[Tables.HashedAccounts.name].items())
        acc = decode_account(raw)
        evil = encode_account(dataclasses.replace(acc, balance=acc.balance + 1))
        record = {Tables.HashedAccounts.name: {"rows": {key: evil}, "del": []}}
        inject_bad_crc_record(d / "wal", record)
        os.environ["RETH_TPU_FAULT_WAL_ACCEPT_TORN"] = "1"
        try:
            db, factory, dur = self._reopen(d)
        finally:
            del os.environ["RETH_TPU_FAULT_WAL_ACCEPT_TORN"]
        report = self._recover("b accepted", factory, durability=dur)
        if report["status"] != "failed" or report["root_verified"] is not False \
                or report["accepted_torn"] != 1 \
                or not any("state root mismatch" in x for x in report["problems"]):
            raise AssertionError(f"recovery, leg b: the accepted torn record went unseen: "
                                 f"{report}")
        dur.close()
        inject_bad_crc_record(d / "wal", record)
        db, factory, dur = self._reopen(d)
        report = self._recover("b discarded", factory, durability=dur, verify_root=False)
        healed = {n: t for n, t in self.healed._tables.items() if t}
        if report["torn_bytes"] <= 0 or {n: t for n, t in db._tables.items() if t} != healed:
            raise AssertionError(f"recovery, leg b: the torn record was not discarded: {report}")
        dur.close()
        log(f"recovery, leg b: the broken reader's recovery failed on the state-root mismatch "
            f"at {SYNC_UNWIND_TO}; the correct reader discarded {report['torn_bytes']} torn "
            f"bytes and every table equals leg a's")

    def leg_c(self) -> None:
        import gc

        from reth_tpu_torch.storage import ProviderFactory, db_store_path
        from reth_tpu_torch.storage.native import PagedDb
        from reth_tpu_torch.storage.tables import Tables, be64
        from reth_tpu_torch.storage.wal import attach_wal

        path = db_store_path("paged", self.dir / "c")
        t0 = time.perf_counter()
        db = PagedDb(path)
        rows = 0
        with db.tx_mut() as tx:
            for name, table in self.healed._tables.items():
                for k in sorted(table):
                    v = table[k]
                    for x in (v if isinstance(v, list) else [v]):
                        tx.put(name, k, x, dupsort=isinstance(v, list))
                        rows += 1
            src = self.sync.db._tables  # block 8's headers back
            for n in range(SYNC_UNWIND_TO + 1, SYNC_BLOCKS + 1):
                h = src[Tables.CanonicalHeaders.name][be64(n)]
                tx.put(Tables.CanonicalHeaders.name, be64(n), h)
                tx.put(Tables.Headers.name, be64(n), src[Tables.Headers.name][be64(n)])
                tx.put(Tables.HeaderNumbers.name, h, src[Tables.HeaderNumbers.name][h])
        self.walls["c copy"] = time.perf_counter() - t0
        log(f"recovery, leg c: {rows} rows copied into a PagedDb in {self.walls['c copy']:.3f} "
            f"s, headers {SYNC_UNWIND_TO + 1}-{SYNC_BLOCKS} put back, {path / 'data.rtpg'} "
            f"{(path / 'data.rtpg').stat().st_size} B; {host_memory()}")
        if attach_wal(db, self.dir / "c" / "wal") is not None:
            raise AssertionError("recovery, leg c: attach_wal gave the paged engine a WAL")
        # the smoke's room: no root check here (the second cut of its time
        # limit); the digests below hold these tables to leg a's, whose root
        # was checked
        report = self._recover("c", ProviderFactory(db), verify_root=False)
        healed = f"completed interrupted unwind {SYNC_BLOCKS} -> {SYNC_UNWIND_TO}"
        if healed not in report["healed"] or report["head_number"] != SYNC_UNWIND_TO \
                or report["root_verified"] is not None:
            raise AssertionError(f"recovery, leg c: {report}")
        # one walk, after the store is closed and reopened (the walk before
        # the reopen went for the time limit): the healed tables persisted
        gc.collect()  # no cursor of a finished transaction outlives the store
        db.close()
        db = PagedDb(path)
        again = store_digests(db, ENGINE_TABLES)
        gc.collect()
        db.close()
        if again != self.engine_digests:
            raise AssertionError(f"recovery, leg c: the reopened paged store's tables differ "
                                 f"from leg a's: {again}, against {self.engine_digests}")
        log(f"recovery, leg c: {healed} on the paged engine (its root not checked, cut for "
            f"time); the store closed and reopened, every row of its state and trie tables "
            f"equal to leg a's")

    def report(self, launches: dict) -> None:
        log("recovery: walls " + ", ".join(f"{k} {v:.3f} s" for k, v in self.walls.items())
            + f"; launches {json.dumps(launches)}")


# the engine paths: the sync path's chain imported by EngineTree from the sync
# path's genesis tables, each variant all of its blocks
ENGINE_PATHS = ("engine", "engine parallel", "engine pipelined")
# the tables the engine's persistence must leave equal to the first sync's
ENGINE_TABLES = ("PlainAccountState", "PlainStorageState", "Bytecodes", "HashedAccounts",
                 "HashedStorages", "AccountsTrie", "StoragesTrie")
# the engine variants cut to blocks 1-SYNC_UNWIND_TO for the smoke's room
# (their tables are held against the sync's at the unwind); "engine" imports
# every block, and the payload paths extend its tree
ENGINE_CUT = ("engine parallel", "engine pipelined")
# the four kernels, each by the module attribute the port calls it through
KERNEL_SITES = (("keccak256_absorb", "reth_tpu_torch.ops.keccak", "keccak256_words_masked"),
                ("packed_level", "reth_tpu_torch.ops.fused_commit", "packed_level"),
                ("branch_level", "reth_tpu_torch.ops.fused_commit", "branch_level"),
                ("subtrie_levels", "reth_tpu_torch.ops.fused_commit", "subtrie_levels"))
# the tree's phases of one newPayload, as its spans name them
ENGINE_PHASES = ("validate", "prepare", "recover_senders", "root_task_start", "execute",
                 "adopt_speculation", "post_validate", "write_overlay", "state_root", "finalize")


def kernel_launches() -> dict:
    """The kernels' launch counts now. Under the recorder a wrapper counts
    inside its lock, so the counts are read inside it too: no launch of
    another thread is half counted."""
    import importlib

    fns = {name: getattr(importlib.import_module(mod), attr)
           for name, mod, attr in KERNEL_SITES}
    recorder = getattr(fns["keccak256_absorb"], "recorder", None)
    lock = recorder.lock if recorder is not None else threading.Lock()
    with lock:
        return {name: fn.launches for name, fn in fns.items()}


class EngineCell:
    """The "engine" paths: the sync path's chain (``sync``, a ``SyncCell``
    after its path) imported through the entry points a consensus client
    calls, ``EngineTree.on_new_payload`` then ``on_forkchoice_updated`` for
    each block, on a MemDb restored from the sync path's tables right after
    its ``init_genesis``. The node's configuration: ``EngineTree(factory,
    TrieCommitter(device="cuda"), EthBeaconConsensus(committer,
    device="cuda"), EvmConfig(), persistence_threshold=2, device="cuda")``;
    after the last block one more fcU with a threshold of 0 persists the
    chain to its tip. "engine": the sparse strategy with hot state (kernel 1
    for the consensus roots, key hashing, proofs and reveals; kernel 4 for
    the arena's delta finish); "engine parallel": the same with the
    optimistic scheduler on the native core and the two-deep import
    pipeline, payload N+1 sent from a second thread once N is in its root
    phase (``block_pipeline.import_chain``); "engine pipelined":
    ``PipelinedStateRoot`` and ``IncrementalStateRoot`` (kernel 1 only)."""

    def __init__(self, sync):
        self.sync = sync
        self.blocks = sync.blocks
        self.results: dict[str, dict] = {}

    def tree(self, **kw):
        from reth_tpu_torch.consensus import EthBeaconConsensus
        from reth_tpu_torch.engine import EngineTree
        from reth_tpu_torch.evm import EvmConfig
        from reth_tpu_torch.storage import MemDb, ProviderFactory
        from reth_tpu_torch.trie.committer import TrieCommitter

        db = MemDb()
        db._tables = self.sync.genesis_tables  # published maps are immutable
        committer = TrieCommitter(device="cuda")
        tree = EngineTree(ProviderFactory(db), committer,
                          EthBeaconConsensus(committer, device="cuda"), EvmConfig(),
                          persistence_threshold=2, device="cuda", **kw)
        return self.instrument(tree)

    @staticmethod
    def instrument(tree):
        """Keep, per block, what the tree computes and then overwrites: the
        sparse task (its finish retries), ``last_sparse`` right after the
        root closes, the optimistic scheduler's stats, the pipelined route's
        failed prehash batches, and each persistence advance's wall."""
        rec = tree.smoke = {"tasks": [], "sparse": [], "exec": [], "prehash_failed": 0,
                            "persist_s": [], "returned": {}}
        new_payload = tree.on_new_payload
        start, close = tree._start_sparse_root, tree._sparse_root_or_fallback
        job, metrics, persist = (tree._state_root_job, tree._record_exec_metrics,
                                 tree._advance_persistence)

        def on_new_payload(blk, *a, **kw):
            st = new_payload(blk, *a, **kw)
            # the launch counts at the block's last return (a SYNCING
            # answer is retried)
            rec["returned"][blk.hash] = (time.perf_counter(), kernel_launches())
            return st

        def start_sparse_root(*a, **kw):
            task = start(*a, **kw)
            rec["tasks"].append(task)
            return task

        def sparse_root_or_fallback(*a):
            root = close(*a)
            rec["sparse"].append(dict(tree.last_sparse, retries=a[2].retries))
            return root

        def state_root_job(overlay, out, root_job=None):
            root = job(overlay, out, root_job)
            if root_job is not None:
                rec["prehash_failed"] += root_job.batches_failed
            return root

        def record_exec_metrics(bal=None, optimistic=None):
            if optimistic is not None:
                rec["exec"].append(dict(optimistic))
            return metrics(bal=bal, optimistic=optimistic)

        def advance_persistence():
            t0 = time.perf_counter()
            persist()
            rec["persist_s"].append(time.perf_counter() - t0)

        tree.on_new_payload = on_new_payload
        tree._start_sparse_root = start_sparse_root
        tree._sparse_root_or_fallback = sparse_root_or_fallback
        tree._state_root_job = state_root_job
        tree._record_exec_metrics = record_exec_metrics
        tree._advance_persistence = advance_persistence
        return tree

    @staticmethod
    def phases(block_hash: bytes, since: float) -> dict:
        """The tree's phase walls (ms) of one block, from its timeline's
        spans that started at or after ``since`` (a block's timeline is
        keyed by its hash, which every variant imports again)."""
        from reth_tpu_torch import tracing

        out = {}
        for r in tracing.block_timeline(block_hash.hex()) or []:
            if r["ts"] >= since and r["kind"] == "span" and (
                    r["name"] in ENGINE_PHASES or r["name"] == "speculate.exec"):
                out[r["name"]] = round(out.get(r["name"], 0.0) + r["dur_ms"], 3)
        return out

    def blocks_of(self, path: str) -> list:
        """The blocks a variant imports: all of the chain's, or blocks
        1-SYNC_UNWIND_TO on the cut variants (ENGINE_CUT)."""
        return self.blocks[:SYNC_UNWIND_TO] if path in ENGINE_CUT else self.blocks

    def drive(self, path: str) -> dict:
        """One variant over its blocks (``blocks_of``); returns its record."""
        import torch

        from reth_tpu_torch import tracing
        from reth_tpu_torch.engine.block_pipeline import import_chain

        kw = {"engine": dict(state_root_strategy="sparse", hot_state=True),
              "engine parallel": dict(state_root_strategy="sparse", hot_state=True,
                                      parallel_exec=True, pipeline_depth=2),
              "engine pipelined": dict(state_root_strategy="pipelined", hot_state=False)}[path]
        blocks = self.blocks_of(path)
        tree = self.tree(**kw)
        res = {"blocks": [], "statuses": []}
        tracing.set_trace_enabled(True)
        since = time.time()
        try:
            t_path = time.perf_counter()
            if path == "engine parallel":
                start = kernel_launches()
                statuses = import_chain(tree, blocks)
                torch.cuda.synchronize()
                res["import_s"] = time.perf_counter() - t_path
                res["statuses"] = [(s.status.value, s.latest_valid_hash) for s in statuses]
                # the blocks overlap, so a block's launches are those of its
                # window: from the previous return to its own, in return order
                returned = tree.smoke["returned"]
                window, prev = {}, start
                for blk in sorted(blocks, key=lambda b: returned[b.hash][0]):
                    now = returned[blk.hash][1]
                    window[blk.hash] = {k: now[k] - prev[k] for k in now}
                    prev = now
                for blk in blocks:
                    res["blocks"].append({"number": blk.header.number,
                                          "window_launches": window[blk.hash],
                                          "phases": self.phases(blk.hash, since)})
            else:
                for blk in blocks:
                    before = kernel_launches()
                    t0 = time.perf_counter()
                    st = tree.on_new_payload(blk)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    fcu = tree.on_forkchoice_updated(blk.hash)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    res["statuses"].append((st.status.value, st.latest_valid_hash))
                    if fcu.status.value != "VALID":
                        raise AssertionError(f"{path}: fcU to block {blk.header.number}: {fcu}")
                    res["blocks"].append({
                        "number": blk.header.number, "new_payload_s": t1 - t0,
                        "fcu_s": t2 - t1, "phases": self.phases(blk.hash, since),
                        "launches": {k: v - before[k]
                                     for k, v in kernel_launches().items()}})
                res["import_s"] = sum(b["new_payload_s"] for b in res["blocks"])
            t0 = time.perf_counter()
            tree.persistence_threshold = 0
            fcu = tree.on_forkchoice_updated(blocks[-1].hash)
            torch.cuda.synchronize()
            res["persist_tip_s"] = time.perf_counter() - t0
            res["path_s"] = time.perf_counter() - t_path
        finally:
            tracing.set_trace_enabled(False)
        if fcu.status.value != "VALID":
            raise AssertionError(f"{path}: the persisting fcU: {fcu}")
        res["tree"] = tree
        self.results[path] = res
        return res

    def check(self, path: str) -> None:
        """Every status VALID at its header's hash and root (the child's
        seal); 0 sparse fallbacks; native ranks and an adopted speculation on
        "engine parallel", no speculation aborted; 0 failed prehash batches;
        the arena with no fault, leaked row or pinned staging; persisted to
        the tip, the tables of ENGINE_TABLES equal the sync path's first sync
        at SYNC_BLOCKS row for row."""
        from reth_tpu_torch.storage import MemDb

        res = self.results[path]
        tree, rec = res["tree"], res["tree"].smoke
        blocks = self.blocks_of(path)
        want = [("VALID", blk.hash) for blk in blocks]
        if res["statuses"] != want:
            raise AssertionError(f"{path}: statuses {res['statuses']}, want VALID at each hash")
        for blk in blocks:
            if blk.header.state_root.hex() != self.sync.roots[blk.header.number]:
                raise AssertionError(f"{path}: block {blk.header.number}'s root is not the seal's")
        if path != "engine pipelined":
            strategies = [m["strategy"] for m in rec["sparse"]]
            if strategies != ["sparse"] * len(blocks) or tree.sparse_fallbacks:
                raise AssertionError(f"{path}: sparse strategies {strategies}, "
                                     f"{tree.sparse_fallbacks} fallbacks")
            arena = tree.hot_arena
            snap = arena.snapshot()
            pinned = arena.engine.pinned_bytes() if arena.engine is not None else 0
            if snap["faults"] or snap["leaked_rows"] or pinned:
                raise AssertionError(f"{path}: a fault, a leaked row or pinned staging in the "
                                     f"arena: {snap}, {pinned} B pinned")
            res["arena"] = snap
        elif rec["sparse"] or tree.last_sparse is not None:
            raise AssertionError(f"{path}: a sparse root on the pipelined strategy")
        if rec["prehash_failed"]:
            raise AssertionError(f"{path}: {rec['prehash_failed']} failed prehash batches")
        if path == "engine parallel":
            pipe = tree.pipeline.stats_snapshot()
            res["pipeline"] = pipe
            natives = [e["native"] for e in rec["exec"]]
            if (len(rec["exec"]) != len(blocks) or not all(natives)
                    or any(e["fallback"] for e in rec["exec"])):
                raise AssertionError(f"{path}: the optimistic scheduler's stats {rec['exec']}")
            if not pipe["adopted"] or pipe["aborted"] or pipe["prehash_failed"]:
                raise AssertionError(f"{path}: the import pipeline {pipe}")
        if tree.persisted_number != len(blocks):
            raise AssertionError(f"{path}: persisted to {tree.persisted_number}")
        first = MemDb()
        first._tables = self.sync.first if len(blocks) == SYNC_BLOCKS else self.sync.unwound
        # the unwind keeps later blocks' bytecodes: the cut variants' are a subset
        names = ENGINE_TABLES if len(blocks) == SYNC_BLOCKS else tuple(
            n for n in ENGINE_TABLES if n != "Bytecodes")
        want_t = table_digests(first, names)
        got_t = table_digests(tree.factory.db, names)
        if got_t != want_t:
            raise AssertionError(f"{path}: tables at {len(blocks)} differ from the sync's: "
                                 f"{got_t} against {want_t}")
        if names != ENGINE_TABLES:
            codes, kept = (dict(db._tables.get("Bytecodes", {}))
                           for db in (tree.factory.db, first))
            if any(kept.get(k) != v for k, v in codes.items()):
                raise AssertionError(f"{path}: a bytecode the sync's unwound tables lack")
        res["tables"] = {n: want_t[n][0] for n in names}

    def report(self, path: str, launches: dict) -> None:
        """Each block's newPayload wall by phase, its sparse task's walls,
        overlap, proof targets and finish retries, launches, the fcU and
        persistence walls; the import's Mgas/s."""
        res = self.results[path]
        rec = res["tree"].smoke
        blocks = self.blocks_of(path)
        for i, b in enumerate(res["blocks"]):
            line = f"{path}: block {b['number']}"
            if "new_payload_s" in b:
                line += (f" newPayload {b['new_payload_s']:.4f} s, fcU {b['fcu_s']:.4f} s, "
                         f"launches {json.dumps(b['launches'])}")
            else:
                line += (" launches in its window (from the previous newPayload's return to "
                         f"its own) {json.dumps(b['window_launches'])}")
            line += f"; phases (ms) {json.dumps(b['phases'])}"
            if i < len(rec["sparse"]):
                m = rec["sparse"][i]
                line += (f"; sparse: proof {m['proof']} s (summed over the pool), reveal "
                         f"{m['reveal']} s, finish {m['finish']} s, hash {m['hash']} s, worker "
                         f"busy {m['worker_busy']} s, exec wall {m['exec_wall']} s, overlap "
                         f"{m['overlap_fraction']}, proof targets {m['proof_targets']}, cache "
                         f"unblinds {m['cache_unblinds']}, finish retries {m['retries']}, "
                         f"proof shards {m['proof_shards']}, reused {m['reused']}")
            if i < len(rec["exec"]):
                e = rec["exec"][i]
                line += (f"; optimistic: native {e['native']}, python {e['python']}, "
                         f"speculative {e['speculative']}, serial reruns {e['serial_rerun']}, "
                         f"rounds {e['rounds']}, wall {e.get('wall_s')}")
            log(line)
        gas = sum(blk.header.gas_used for blk in blocks)
        log(f"{path}: {len(blocks)} blocks, {sum(len(b.transactions) for b in blocks)} "
            f"transactions, {gas} gas imported in {res['import_s']:.3f} s "
            f"({gas / res['import_s'] / 1e6:.3f} Mgas/s of import); persistence advances "
            f"{[round(x, 4) for x in rec['persist_s']]} s, the persisting fcU "
            f"{res['persist_tip_s']:.3f} s; path {res['path_s']:.3f} s; launches "
            f"{json.dumps(launches)}"
            + (f"; arena {json.dumps(res['arena'])}" if "arena" in res else "")
            + (f"; pipeline {json.dumps(res['pipeline'])}" if "pipeline" in res else "")
            + (f"; tables equal to the sync's at block {len(blocks)} "
               f"({json.dumps(res['tables'])} rows)" if "tables" in res else "")
            + (f"; cut to blocks 1-{len(blocks)} for the smoke's room" if path in ENGINE_CUT
               else ""))

    def profile(self) -> None:
        """Outside the main paths: block 1 of a fresh "engine" tree under
        torch.profiler, then block 2 under cProfile."""
        tree = self.tree(state_root_strategy="sparse", hot_state=True)
        b1, b2 = self.blocks[0], self.blocks[1]

        def payload(blk):
            st = tree.on_new_payload(blk)
            if (st.status.value, st.latest_valid_hash) != ("VALID", blk.hash):
                raise AssertionError(f"engine (profiled): block {blk.header.number}: {st}")
            tree.on_forkchoice_updated(blk.hash)

        device_profile("engine block 1", lambda: payload(b1))
        host_profile("engine block 2", payload, b2,
                     focus=("on_new_payload", "_execute_into_overlay", "execute",
                            "_sparse_root_or_fallback", "finish", "_finish_inner",
                            "multiproof", "_reveal", "_write_sparse_output",
                            "export_updates", "validate_block_post_execution",
                            "_sorted_keys", "hash_batch", "recover_senders"))

    def drills(self) -> list[dict]:
        """a) RETH_TPU_FAULT_SPARSE_ABORT=1 on block 1 of a fresh "engine"
        tree: the sparse commit aborts, the tree reruns the block on the
        incremental committer, VALID at the header's root, strategy
        "fallback"; b) block 2 of another, its arena's delta finish given a
        launch fault (``_build.check_launch`` of a CUDA error, as a failed
        launch of kernel 4 reports it): on_new_payload raises it, with no
        fallback and one arena fault."""
        import torch

        from reth_tpu_torch.engine import SparseRootError
        from reth_tpu_torch.ops import _build
        from reth_tpu_torch.ops import fused_commit as fc

        out = []
        b1, b2 = self.blocks[0], self.blocks[1]
        os.environ["RETH_TPU_FAULT_SPARSE_ABORT"] = "1"
        try:
            tree = self.tree(state_root_strategy="sparse", hot_state=True)
            t0 = time.perf_counter()
            st = tree.on_new_payload(b1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            del os.environ["RETH_TPU_FAULT_SPARSE_ABORT"]
        if ((st.status.value, st.latest_valid_hash) != ("VALID", b1.hash)
                or tree.last_sparse["strategy"] != "fallback" or tree.sparse_fallbacks != 1):
            raise AssertionError(f"engine drill a): {st}, {tree.last_sparse}, "
                                 f"{tree.sparse_fallbacks} fallbacks")
        out.append({"drill": "sparse abort", "rung": "fallback", "wall_s": round(wall, 4),
                    "error": tree.last_sparse["error"][:80]})
        tree = self.tree(state_root_strategy="sparse", hot_state=True)
        if tree.on_new_payload(b1).status.value != "VALID":
            raise AssertionError("engine drill b): block 1 did not validate")
        tree.on_forkchoice_updated(b1.hash)
        real = fc.subtrie_levels

        def failing(*_a):
            _build.check_launch(700, "subtrie_levels")

        fc.subtrie_levels = failing
        try:
            tree.on_new_payload(b2)
        except SparseRootError as e:
            cause = e.__cause__
        else:
            raise AssertionError("engine drill b): a launch fault in the arena's finish did "
                                 "not raise out of on_new_payload")
        finally:
            fc.subtrie_levels = real
        torch.cuda.synchronize()
        if (not isinstance(cause, _build.LaunchError) or tree.sparse_fallbacks
                or tree.hot_arena.faults != 1 or b2.hash in tree.blocks):
            raise AssertionError(f"engine drill b): cause {cause!r}, {tree.sparse_fallbacks} "
                                 f"fallbacks, {tree.hot_arena.faults} arena faults")
        out.append({"drill": "arena launch fault", "rung": "raised",
                    "error": f"{type(cause).__name__}: {cause}"[:80]})
        return out


# block production and stateless validation on the "engine" path's tree:
# blocks 9-11 built from the sync child's unsealed batches, then witnessed and
# validated from their witnesses alone
PAYLOAD_PATHS = ("payload", "stateless")
PAYLOAD_ROUTES = ("miner", "service", "producer")
PAYLOAD_COINBASE = b"\xc0" * 20


def clone_pool(pool):
    """A fresh pool with ``pool``'s transactions, admitted in submission
    order (the selection's tie-breaks match): what one serial
    ``build_payload`` would select from."""
    from reth_tpu_torch.pool import TransactionPool

    clone = TransactionPool(pool.state_reader, config=pool.config)
    clone.base_fee, clone.blob_base_fee = pool.base_fee, pool.blob_base_fee
    with pool._lock:
        for p in sorted(pool.by_hash.values(), key=lambda p: p.submission_id):
            clone.add_transaction(p.tx, sender=p.sender)
    return clone


class PayloadCell:
    """The "payload" and "stateless" paths on the "engine" path's tree
    (blocks 1-8 imported and persisted, ``EngineCell``), through the entry
    points a node that builds its own blocks calls, and a stateless
    validator's. "payload": before each build one of the sync child's
    unsealed batches (245 transactions) is admitted through ``TxBatcher``
    into a ``TransactionPool(PoolConfig(chain_id=1))`` over the tree's
    overlay, and before block 9's build the three transactions it must
    refuse (REFUSED); block 9 by ``LocalMiner(tree, pool).mine_block`` (the
    dev-mode route: the serial greedy build, newPayload, fcU, the pool's
    canonical update), block 10 by ``PayloadBuilderService.new_payload_job``
    + ``get_payload_with_fees`` then ``on_new_payload`` and
    ``on_forkchoice_updated`` (a consensus client's route), block 11 by a
    started ``BlockProducer``'s ``take()`` after ``prepare`` (held against
    one serial ``build_payload`` over a clone of the same pool). The builds
    root the state on the tree's incremental job and the ordered tries on
    kernel 1; each import roots it again on the sparse strategy (kernels 1
    and 4). The tree keeps blocks 9-11 in memory (persistence threshold
    PAYLOAD_BATCHES) for their witnesses. "stateless": for each block,
    ``generate_witness`` against its parent's overlay with
    ``provider_factory=`` and 4 proof workers on the tree's committer
    (kernel 1 on the proof lane), then one ``StatelessChain(device="cuda")``
    validates blocks 9, 10 and 11 in order from their witnesses alone
    (kernel 1), 10 and 11 on the preserved trie."""

    def __init__(self, engine):
        self.sync = engine.sync
        self.tree = engine.results["engine"]["tree"]
        self.blocks: list = []
        self.parents: list = []
        self.records: list[dict] = []
        self.witnesses: list = []

    def _timed_imports(self):
        """Wrap the tree's newPayload so each import's wall is kept."""
        tree, walls = self.tree, []
        inner = tree.on_new_payload

        def on_new_payload(blk, *a, **kw):
            t0 = time.perf_counter()
            st = inner(blk, *a, **kw)
            torch_sync()
            walls.append(time.perf_counter() - t0)
            return st

        tree.on_new_payload = on_new_payload
        return walls, lambda: setattr(tree, "on_new_payload", inner)

    def drive(self) -> None:
        """Path "payload"."""
        from reth_tpu_torch.consensus.validation import calc_next_base_fee
        from reth_tpu_torch.engine import LocalMiner
        from reth_tpu_torch.metrics import producer_metrics
        from reth_tpu_torch.payload import (BlockProducer, PayloadAttributes,
                                            PayloadBuilderService, build_payload)
        from reth_tpu_torch.pool import PoolConfig, TransactionPool, TxBatcher

        tree = self.tree
        tree.persistence_threshold = PAYLOAD_BATCHES
        self.fallbacks0 = (producer_metrics.fallback_total(), tree.sparse_fallbacks)
        pool = TransactionPool(lambda: tree.overlay_provider(), PoolConfig(chain_id=1))
        pool.base_fee = calc_next_base_fee(tree.overlay_provider().header_by_number(SYNC_BLOCKS))
        batcher = TxBatcher(pool)
        import_walls, unwrap = self._timed_imports()
        self.counters = {}
        try:
            for route, (number, txs, wds, _senders) in zip(PAYLOAD_ROUTES, self.sync.batches):
                rec = {"number": number, "route": route}
                parent_hash = tree.head_hash
                parent = tree.overlay_provider().header_by_number(number - 1)
                t0 = time.perf_counter()
                outcomes = [attempt_future(batcher.submit(tx)) for tx in txs]
                rec["admit_s"] = time.perf_counter() - t0
                rec["admitted"] = sum(o[0] == "ok" for o in outcomes)
                if route == "miner":
                    refused = [attempt_future(batcher.submit(tx)) for tx in self.sync.refused]
                    rec["refused"] = [o[2] for o in refused]
                attrs = PayloadAttributes(timestamp=parent.timestamp + 12,
                                          suggested_fee_recipient=PAYLOAD_COINBASE,
                                          withdrawals=wds)
                t0 = time.perf_counter()
                if route == "miner":
                    miner = LocalMiner(tree, pool)
                    block = miner.mine_block(timestamp=parent.timestamp + 12)
                    rec["build"] = dict(miner.last_stats)
                    self.counters["miner"] = (miner.producer_fallbacks, miner.serial_builds)
                    status = "VALID"  # mine_block raises on any other status
                elif route == "service":
                    svc = PayloadBuilderService(tree, pool, interval=2.0)
                    pid = svc.new_payload_job(parent_hash, attrs)
                    block, rec["fees"] = svc.get_payload_with_fees(pid)
                    job = svc.jobs[pid]
                    rec["build"] = dict(job.last_stats)
                    self.counters["job"] = (job.fallbacks, job.rebuilds)
                else:
                    prod = BlockProducer(tree, pool, interval=0.05)
                    prod.start()
                    try:
                        prod.prepare(parent_hash, attrs)
                        wait_producer(prod, pool, tree, attrs)
                        t1 = time.perf_counter()
                        serial, _ = build_payload(tree, clone_pool(pool), parent_hash, attrs)
                        rec["serial_build_s"] = time.perf_counter() - t1
                        t1 = time.perf_counter()
                        block, rec["fees"] = prod.take(parent_hash, attrs)
                        rec["take_s"] = time.perf_counter() - t1
                        rec["build"] = dict(prod.last_stats)
                        snap = prod.snapshot()
                    finally:
                        prod.stop()
                    self.counters["producer"] = (snap["errors"], snap["hits"], snap["misses"])
                    rec["producer"] = {k: snap[k] for k in ("refreshes", "full_rebuilds",
                                                           "exec_ranks", "reexec_ranks",
                                                           "hits", "misses", "errors")}
                    if block.hash != serial.hash:
                        raise AssertionError(f"payload: the producer's block 11 "
                                             f"{[t.hash.hex()[:8] for t in block.transactions]} "
                                             f"is not one serial build's")
                if route != "miner":
                    st = tree.on_new_payload(block)
                    status = st.status.value
                    if tree.on_forkchoice_updated(block.hash).status.value != "VALID":
                        raise AssertionError(f"payload: fcU to block {number}")
                    pool.on_canonical_state_change(calc_next_base_fee(block.header))
                torch_sync()
                rec["route_s"] = time.perf_counter() - t0
                rec["import_s"] = import_walls[-1]
                rec.update(status=status, txs=len(block.transactions),
                           batch=sorted(t.hash for t in txs) == sorted(
                               t.hash for t in block.transactions),
                           strategy=tree.last_sparse["strategy"], pool_left=len(pool),
                           gas=block.header.gas_used)
                self.records.append(rec)
                self.blocks.append(block)
                self.parents.append(parent)
        finally:
            unwrap()
            batcher.close()
        self.pool = pool

    def check_payload(self) -> None:
        """Every block VALID at its hash on the sparse strategy, all 245 of
        its batch selected, its ordered roots the host's (numpy), the pool
        empty after each canonical update, the refused transactions refused
        with the pool's messages, 0 catch-all and 0 sparse fallbacks."""
        from reth_tpu_torch.metrics import producer_metrics
        from reth_tpu_torch.primitives.keccak import keccak256_batch_np
        from reth_tpu_torch.primitives.rlp import rlp_encode
        from reth_tpu_torch.trie.committer import TrieCommitter
        from reth_tpu_torch.trie.state_root import ordered_trie_root

        host = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
        tree = self.tree
        for rec, block in zip(self.records, self.blocks):
            n = rec["number"]
            if (rec["status"], rec["strategy"], tree.head_hash == self.blocks[-1].hash) != (
                    "VALID", "sparse", True):
                raise AssertionError(f"payload: block {n}: {rec}")
            if not rec["batch"] or rec["admitted"] != len(block.transactions) or rec["pool_left"]:
                raise AssertionError(f"payload: block {n} selected {rec['txs']} of its batch "
                                     f"({rec['admitted']} admitted, {rec['pool_left']} left)")
            receipts = tree.blocks[block.hash].receipts
            h = block.header
            want = (ordered_trie_root([t.encode() for t in block.transactions], host),
                    ordered_trie_root([r.encode_2718() for r in receipts], host),
                    ordered_trie_root([rlp_encode(w.rlp_fields()) for w in block.withdrawals],
                                      host))
            if (h.transactions_root, h.receipts_root, h.withdrawals_root) != want:
                raise AssertionError(f"payload: block {n}'s ordered roots differ from the "
                                     f"host's numpy roots")
        if self.records[0]["refused"] != list(REFUSED):
            raise AssertionError(f"payload: refused {self.records[0]['refused']}, want "
                                 f"{list(REFUSED)}")
        fallbacks = (producer_metrics.fallback_total() - self.fallbacks0[0],
                     tree.sparse_fallbacks - self.fallbacks0[1])
        if fallbacks != (0, 0) or self.counters["miner"] != (0, 1) or \
                self.counters["job"][0] or self.counters["producer"][0]:
            raise AssertionError(f"payload: fallbacks (catch-all, sparse) {fallbacks}, "
                                 f"{self.counters}")
        log(f"payload: blocks {[r['number'] for r in self.records]} VALID on the sparse "
            f"strategy, {[r['txs'] for r in self.records]} transactions (every one of each "
            f"batch), transactions / receipts / withdrawals roots equal the host's numpy "
            f"ordered_trie_root; refused {self.records[0]['refused']}; the pool empty after "
            f"each canonical update; 0 catch-all fallbacks, 0 sparse fallbacks")

    def report(self, launches: dict) -> None:
        for rec in self.records:
            b = rec["build"]
            extra = ""
            if rec["route"] == "producer":
                extra = (f"; producer take {rec['take_s']:.4f} s, one serial build "
                         f"{rec['serial_build_s']:.4f} s (the same block), "
                         f"{json.dumps(rec['producer'])}")
            log(f"payload: block {rec['number']} by the {rec['route']}: admission "
                f"{rec['admit_s']:.4f} s ({rec['admitted']} admitted); build = selection and "
                f"execution {b.get('select_s', 0):.4f} s + state root "
                f"{b.get('state_root_s', 0):.4f} s + ordered roots "
                f"{b.get('ordered_roots_s', 0):.4f} s; import (newPayload) "
                f"{rec['import_s']:.4f} s; route {rec['route_s']:.4f} s; {rec['txs']} "
                f"transactions, {rec['gas']} gas{extra}")
        log(f"payload: launches {json.dumps(launches)}")

    def witness_all(self) -> list[dict]:
        """Path "stateless", first half: each block's witness from its
        parent's overlay."""
        from reth_tpu_torch.engine import generate_witness
        from reth_tpu_torch.primitives.types import recover_senders

        tree, out = self.tree, []
        for block, parent in zip(self.blocks, self.parents):
            stats: dict = {}
            t0 = time.perf_counter()
            w = generate_witness(tree.overlay_provider(parent.hash), block, tree.committer,
                                 senders=recover_senders(block.transactions),
                                 parent_header=parent, config=tree.config,
                                 provider_factory=lambda h=parent.hash: tree.overlay_provider(h),
                                 proof_workers=4, stats=stats)
            torch_sync()
            stats["wall_s"] = time.perf_counter() - t0
            self.witnesses.append(w)
            out.append(stats)
        return out

    def validate_all(self) -> list[dict]:
        """Path "stateless", second half: one chain over blocks 9-11."""
        from reth_tpu_torch.engine import StatelessChain

        chain = StatelessChain(self.tree.config, device="cuda")
        out = []
        for block, parent, w in zip(self.blocks, self.parents, self.witnesses):
            t0 = time.perf_counter()
            root = chain.validate(block, w, parent)
            torch_sync()
            out.append(dict(chain.last_stats, wall_s=time.perf_counter() - t0, root=root,
                            gas=chain.last_output.gas_used))
        self.chain = chain
        return out

    def drive_stateless(self) -> None:
        self.witness_stats = self.witness_all()
        self.stateless_stats = self.validate_all()

    def check_stateless(self) -> None:
        """Each stateless root and gas the header's; 10 and 11 on the
        preserved trie; each witness equal to itself through its JSON."""
        from reth_tpu_torch.engine import ExecutionWitness

        for block, st, w in zip(self.blocks, self.stateless_stats, self.witnesses):
            if (st["root"], st["gas"]) != (block.header.state_root, block.header.gas_used):
                raise AssertionError(f"stateless: block {block.header.number}: root "
                                     f"{st['root'].hex()}, gas {st['gas']}")
            if ExecutionWitness.from_json(w.to_json()) != w:
                raise AssertionError(f"stateless: block {block.header.number}'s witness "
                                     f"changed through its JSON")
        if self.chain.preserved.hits != len(self.blocks) - 1:
            raise AssertionError(f"stateless: {self.chain.preserved.hits} preserved-trie hits")
        log(f"stateless: {len(self.blocks)} of {len(self.blocks)} blocks valid from their "
            f"witnesses alone at the header's root and gas; blocks 10 and 11 on the preserved "
            f"trie; every witness equal to itself through to_json / from_json")

    def report_stateless(self, launches: dict) -> None:
        for block, ws, st in zip(self.blocks, self.witness_stats, self.stateless_stats):
            log(f"stateless: block {block.header.number}: witness {ws['wall_s']:.4f} s = "
                f"execution {ws['execute_s']:.4f} + multiproof {ws['multiproof_s']:.4f} + node "
                f"hashing {ws['hash_nodes_s']:.4f} + closure {ws['close_s']:.4f} s "
                f"({ws['rounds']} rounds); {ws['nodes']} nodes, {ws['codes']} codes, "
                f"{ws['keys']} keys, {ws['headers']} headers, {ws['bytes']} bytes; stateless "
                f"{st['wall_s']:.4f} s = reveal {st['reveal_s']:.4f} + execution "
                f"{st['execute_s']:.4f} + root {st['root_s']:.4f} s")
        log(f"stateless: launches {json.dumps(launches)}")

    def profile(self) -> None:
        """Outside the main paths: block 11 built again on block 10 from a
        pool of its transactions under torch.profiler, then block 10's
        witness."""
        from reth_tpu_torch.engine import generate_witness
        from reth_tpu_torch.payload import PayloadAttributes, build_payload
        from reth_tpu_torch.pool import PoolConfig, TransactionPool
        from reth_tpu_torch.primitives.types import recover_senders

        tree = self.tree
        block, parent = self.blocks[2], self.parents[2]
        pool = TransactionPool(lambda: tree.overlay_provider(parent.hash), PoolConfig(chain_id=1))
        for tx, sender in zip(block.transactions, recover_senders(block.transactions)):
            pool.add_transaction(tx, sender=sender)
        attrs = PayloadAttributes(timestamp=block.header.timestamp,
                                  suggested_fee_recipient=block.header.beneficiary,
                                  withdrawals=block.withdrawals)
        built = []
        device_profile("payload build (block 11 again)",
                       lambda: built.append(build_payload(tree, pool, parent.hash, attrs)[0]))
        log(f"payload (profiled): block 11 built again from a pool of its transactions "
            f"{'equals' if built[0].hash == block.hash else 'differs from'} block 11")
        b10, p10 = self.blocks[1], self.parents[1]
        device_profile("witness (block 10 again)", lambda: generate_witness(
            tree.overlay_provider(p10.hash), b10, tree.committer,
            senders=recover_senders(b10.transactions), parent_header=p10, config=tree.config,
            provider_factory=lambda: tree.overlay_provider(p10.hash), proof_workers=4))

    def drills(self) -> list[dict]:
        """a) block 9's witness without the parent's account-trie root node:
        "witness incomplete"; b) block 9's header with another state root:
        "stateless root mismatch"; c) a launch fault of kernel 1 in a payload
        build (``_build.check_launch`` of a CUDA error): it raises out of
        ``mine_block`` and out of ``PayloadJob``, the head and the pool as
        they were, no block; then the chain is persisted to its tip."""
        import dataclasses

        from reth_tpu_torch.engine import (ExecutionWitness, LocalMiner, StatelessChain,
                                           StatelessValidationError)
        from reth_tpu_torch.ops import _build
        from reth_tpu_torch.ops import keccak as ok
        from reth_tpu_torch.payload import PayloadAttributes, PayloadBuilderService
        from reth_tpu_torch.primitives.keccak import keccak256

        out = []
        block, parent, w = self.blocks[0], self.parents[0], self.witnesses[0]
        cut = ExecutionWitness(state=[n for n in w.state if keccak256(n) != parent.state_root],
                               codes=w.codes, keys=w.keys, headers=w.headers)
        bad = dataclasses.replace(block, header=dataclasses.replace(
            block.header, state_root=b"\xde" * 32))
        for name, want, run in (
                ("a) a needed node removed", "witness incomplete",
                 lambda: StatelessChain(self.tree.config, device="cuda").validate(
                     block, cut, parent)),
                ("b) the header's state root changed", "stateless root mismatch",
                 lambda: StatelessChain(self.tree.config, device="cuda").validate(
                     bad, w, parent))):
            try:
                run()
            except StatelessValidationError as e:
                if not str(e).startswith(want):
                    raise AssertionError(f"stateless drill {name}: {e}")
                out.append({"drill": name, "error": str(e)[:80]})
            else:
                raise AssertionError(f"stateless drill {name} validated")
        tree, pool = self.tree, self.pool
        pool.add_transaction(self.sync.drill_tx)
        head = tree.head_hash
        real = ok.keccak256_words_masked

        def failing(*_a):
            _build.check_launch(700, "keccak256_absorb")

        ok.keccak256_words_masked = failing
        raised = []
        try:
            for what, run in (("mine_block", lambda: LocalMiner(tree, pool).mine_block()),
                              ("PayloadJob", lambda: PayloadBuilderService(tree, pool)
                               .new_payload_job(head, PayloadAttributes(timestamp=2**40)))):
                try:
                    run()
                except _build.LaunchError as e:
                    raised.append(f"{what}: {e}")
                else:
                    raise AssertionError(f"payload drill c): a launch fault of kernel 1 did not "
                                         f"raise out of {what}")
        finally:
            ok.keccak256_words_masked = real
        if tree.head_hash != head or len(pool) != 1:
            raise AssertionError("payload drill c): the head moved or the pool changed")
        out.append({"drill": "c) a launch fault of kernel 1 in a build", "rung": "raised",
                    "error": raised})
        tree.persistence_threshold = 0
        head_number = tree.blocks[head].block.header.number
        if tree.on_forkchoice_updated(head).status.value != "VALID" or \
                tree.persisted_number != head_number:
            raise AssertionError(f"payload: persisting blocks 9-{head_number} failed")
        return out


# the JSON-RPC surface over the "payload" path's tree at block 11: a batch of
# eth_getProof, the witnesses of blocks 9-11, block 12 through the engine API
RPC_SEED = 53
RPC_ACCOUNTS, RPC_ABSENT, RPC_WRITER_REQS = 1000, 16, 8
RPC_WRITER_SLOTS, RPC_WRITER_WRITTEN = 80, 64
RPC_CLIENTS = 8  # threads submitting block 12's transactions


def http_post(port: int, body: bytes, token: str | None = None) -> tuple[int, bytes]:
    """One JSON POST to 127.0.0.1:``port``: (status, body)."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(f"http://127.0.0.1:{port}/", body, headers)
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def rpc_request(method: str, params: list, rid: int = 1) -> dict:
    return {"jsonrpc": "2.0", "id": rid, "method": method, "params": params}


def proof_json(address: str, proof) -> dict:
    """``eth_getProof``'s response for a direct ``ProofCalculator`` result."""
    from reth_tpu_torch.primitives.types import KECCAK_EMPTY

    acc = proof.account
    return {"address": address, "accountProof": ["0x" + n.hex() for n in proof.proof],
            "balance": hex(acc.balance if acc else 0), "nonce": hex(acc.nonce if acc else 0),
            "codeHash": "0x" + (acc.code_hash if acc else KECCAK_EMPTY).hex(),
            "storageHash": "0x" + proof.storage_root.hex(),
            "storageProof": [{"key": "0x" + sp.key.hex(), "value": hex(sp.value),
                              "proof": ["0x" + n.hex() for n in sp.proof]}
                             for sp in proof.storage_proofs]}


def verify_proofs(root: bytes, responses: list[dict]) -> int:
    """Every account proof against ``root`` and every storage proof against
    its account's storage root (``trie/proof.py`` verify_account_proof /
    verify_storage_proof), their nodes and keys hashed in one numpy batch
    first. Returns the storage proofs verified."""
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.primitives.types import Account
    from reth_tpu_torch.trie import proof as tp

    raw = lambda x: bytes.fromhex(x[2:])  # noqa: E731
    blobs = set()
    for r in responses:
        blobs.add(raw(r["address"]))
        blobs.update(raw(n) for n in r["accountProof"])
        for sp in r["storageProof"]:
            blobs.add(raw(sp["key"]))
            blobs.update(raw(n) for n in sp["proof"])
    blobs = sorted(blobs)
    digests = dict(zip(blobs, keccak256_batch_np(blobs)))
    real = tp.keccak256
    tp.keccak256 = lambda b: digests.get(bytes(b)) or real(b)
    n = 0
    try:
        for r in responses:
            addr, storage_root = raw(r["address"]), raw(r["storageHash"])
            acc = Account(nonce=int(r["nonce"], 16), balance=int(r["balance"], 16),
                          storage_root=storage_root, code_hash=raw(r["codeHash"]))
            nodes = [raw(x) for x in r["accountProof"]]
            # an absent account proves no leaf; a present one its encoding
            leaf = tp._verify_path(root, tp.unpack_nibbles(tp.keccak256(addr)), nodes)[1]
            ap = tp.AccountProof(addr, acc if leaf is not None else None, nodes, storage_root)
            if not tp.verify_account_proof(root, addr, ap):
                raise AssertionError(f"rpc: the account proof of {r['address']} does not verify")
            for sp in r["storageProof"]:
                if not tp.verify_storage_proof(storage_root, tp.StorageProof(
                        raw(sp["key"]), int(sp["value"], 16), [raw(x) for x in sp["proof"]])):
                    raise AssertionError(f"rpc: a storage proof of {r['address']} does not "
                                         f"verify")
                n += 1
    finally:
        tp.keccak256 = real
    return n


class RpcCell:
    """The "rpc" path on the "payload" path's tree at block 11 (blocks 9-11
    in memory), through the servers a node starts: ``RpcServer`` on
    127.0.0.1, port 0, twice, wired as the JAX package's ``node/node.py``
    (:504-547) wires them and sharing one lock: a public server with the
    eth, debug, net, web3, txpool, otterscan, flashbots and miner APIs, and
    an auth server with a JWT secret (``load_or_create_secret``) carrying
    ``EngineApi`` and ``EthApi``, over a ``TransactionPool`` with its
    ``TxBatcher`` and a ``PayloadBuilderService``. Every call below goes over
    HTTP. a) One JSON-RPC batch of 1,024 ``eth_getProof`` at "latest" from a
    fixed seed: 1,000 genesis accounts with 0-4 of their own slots and one
    absent slot, 16 absent addresses, 8 requests of 80 slots on the storage
    writer (64 it wrote, 16 absent: above ``SLOT_SPLIT_MIN``, the proof
    worker pool); kernel 1. b) ``debug_executionWitness`` of blocks 9-11;
    kernel 1. c) Block 12: the sync child's fourth batch through
    ``eth_sendRawTransaction`` (RPC_CLIENTS threads), ``forkchoiceUpdatedV2``
    with attributes, ``getPayloadV2``, the payload through
    ``flashbots_validateBuilderSubmissionV3`` (then with one byte of its
    state root flipped and its hash re-sealed), ``newPayloadV2`` (kernels 1
    and 4: the sparse root on the hot-state arena), ``forkchoiceUpdatedV2``
    to 12; then the latest block and the 245 receipts, and one engine call
    without the token."""

    def __init__(self, payload: "PayloadCell"):
        self.payload = payload
        self.sync = payload.sync
        self.tree = payload.tree
        self.walls: dict[str, float] = {}
        self.dir = Path(HERE) / "reth_tpu_torch" / "build" / f"rpc-{os.getpid()}"

    def start(self) -> None:
        """The node's wiring, without its ``Node``."""
        from reth_tpu_torch.consensus.validation import calc_next_base_fee
        from reth_tpu_torch.metrics import producer_metrics
        from reth_tpu_torch.payload import PayloadBuilderService
        from reth_tpu_torch.pool import PoolConfig, TransactionPool, TxBatcher
        from reth_tpu_torch.rpc import EngineApi, EthApi, RpcServer
        from reth_tpu_torch.rpc.debug import DebugApi
        from reth_tpu_torch.rpc.flashbots import BundleApi, ValidationApi
        from reth_tpu_torch.rpc.jwt import encode_jwt, load_or_create_secret
        from reth_tpu_torch.rpc.miner import MinerApi
        from reth_tpu_torch.rpc.net import NetApi, TxpoolApi, Web3Api
        from reth_tpu_torch.rpc.otterscan import OtterscanApi

        tree = self.tree
        # blocks 9-12 stay in memory: the payload path's profiled runs and
        # drills read 10's and 11's parents after this path
        tree.persistence_threshold = PAYLOAD_BATCHES + RPC_BATCHES
        self.fallbacks0 = (producer_metrics.fallback_total(), tree.sparse_fallbacks)
        self.head11, self.root11 = tree.head_hash, self.payload.blocks[-1].header.state_root
        pool = TransactionPool(lambda: tree.overlay_provider(), PoolConfig(chain_id=1))
        pool.base_fee = calc_next_base_fee(self.payload.blocks[-1].header)
        self.pool, self.batcher = pool, TxBatcher(pool)
        service = PayloadBuilderService(tree, pool)

        def maintain_pool(chain):
            if chain:
                pool.on_canonical_state_change(calc_next_base_fee(chain[-1].block.header))

        self.listener = maintain_pool
        tree.canon_listeners.append(maintain_pool)
        lock = threading.RLock()
        service.lock = lock
        eth = EthApi(tree, pool, 1, tx_batcher=self.batcher)
        public = RpcServer(lock=lock)
        debug = DebugApi(eth)
        for api in (eth, NetApi(1), Web3Api(), TxpoolApi(pool), debug,
                    OtterscanApi(eth, debug), BundleApi(eth), ValidationApi(eth),
                    MinerApi(service, pool)):
            public.register(api)
        secret = load_or_create_secret(self.dir / "jwt.hex")
        auth = RpcServer(lock=lock, jwt_secret=secret)
        auth.register(EngineApi(tree, service, pool=pool))
        auth.register(eth)
        self.servers = (public, auth)
        self.ports = (public.start(), auth.start())
        self.token = lambda: encode_jwt(secret)
        log(f"rpc: public server on 127.0.0.1:{self.ports[0]} ({len(public.methods)} methods), "
            f"auth server on 127.0.0.1:{self.ports[1]} ({len(auth.methods)} methods, JWT)")

    def close(self) -> None:
        import shutil

        for server in getattr(self, "servers", ()):
            server.stop()
        if getattr(self, "batcher", None) is not None:
            self.batcher.close()
        if getattr(self, "listener", None) in self.tree.canon_listeners:
            self.tree.canon_listeners.remove(self.listener)
        shutil.rmtree(self.dir, ignore_errors=True)

    def call(self, method: str, *params, auth: bool = False):
        status, body = http_post(self.ports[auth], json.dumps(
            rpc_request(method, list(params))).encode(), self.token() if auth else None)
        out = json.loads(body)
        if status != 200 or "error" in out:
            raise AssertionError(f"rpc: {method}: HTTP {status}, {out.get('error')}")
        return out["result"]

    def proof_requests(self) -> list[tuple[str, list[str]]]:
        """a)'s requests: (address, slots) from RPC_SEED."""
        from _torch_helpers import SyncChain

        rng = np.random.default_rng(RPC_SEED)
        contracts = (SyncChain.TOKEN, SyncChain.WRITER, SyncChain.CALLER)
        pool = sorted(a for a in self.sync.accounts if a not in contracts)
        picks = rng.choice(len(pool), size=RPC_ACCOUNTS, replace=False)
        absent = lambda: "0x" + bytes(rng.integers(0, 256, 32, dtype=np.uint8)).hex()  # noqa: E731
        reqs = []
        for i in picks:
            addr = pool[int(i)]
            own = sorted(self.sync.storage.get(addr, {}))
            k = min(int(rng.integers(0, 5)), len(own))
            slots = ["0x" + own[int(j)].hex() for j in sorted(rng.choice(len(own), k,
                                                                         replace=False))]
            reqs.append(("0x" + addr.hex(), slots + [absent()]))
        for _ in range(RPC_ABSENT):
            reqs.append(("0x" + bytes(rng.integers(0, 256, 20, dtype=np.uint8)).hex(),
                         [absent()]))
        written = []
        for blk in self.sync.blocks + self.payload.blocks:
            for tx in blk.transactions:
                if tx.to == SyncChain.WRITER:
                    written += [tx.data[32 * j:32 * j + 32] for j in range(4)]
        written = list(dict.fromkeys(written))
        for r in range(RPC_WRITER_REQS):
            mine = written[r * RPC_WRITER_WRITTEN:(r + 1) * RPC_WRITER_WRITTEN]
            slots = ["0x" + s.hex() for s in mine] + [
                absent() for _ in range(RPC_WRITER_SLOTS - len(mine))]
            reqs.append(("0x" + SyncChain.WRITER.hex(), slots))
        return reqs

    def drive(self) -> None:
        """Path "rpc"."""
        self.start()
        t0 = time.perf_counter()
        self.proof_reqs = self.proof_requests()
        body = json.dumps([rpc_request("eth_getProof", [a, s, "latest"], i)
                           for i, (a, s) in enumerate(self.proof_reqs)]).encode()
        t1 = time.perf_counter()
        status, raw = http_post(self.ports[0], body)
        torch_sync()
        self.walls["a_batch"] = time.perf_counter() - t1
        if status != 200:
            raise AssertionError(f"rpc: the eth_getProof batch answered HTTP {status}")
        self.proof_resps = json.loads(raw)
        self.walls["a"] = time.perf_counter() - t0
        self.proof_bytes = len(raw)
        t0 = time.perf_counter()
        self.witness_json, self.walls["b_blocks"] = [], []
        for blk in self.payload.blocks:
            t1 = time.perf_counter()
            self.witness_json.append(self.call("debug_executionWitness",
                                               hex(blk.header.number)))
            torch_sync()
            self.walls["b_blocks"].append(time.perf_counter() - t1)
        self.walls["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.block_12()
        self.walls["c"] = time.perf_counter() - t0

    def block_12(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        from reth_tpu_torch.primitives.keccak import keccak256_batch_np
        from reth_tpu_torch.rpc.engine_api import payload_to_block
        from reth_tpu_torch.trie.committer import TrieCommitter

        number, txs, wds, _senders = self.sync.batches[PAYLOAD_BATCHES]
        self.batch = txs
        walls = self.walls
        t0 = time.perf_counter()
        with ThreadPoolExecutor(RPC_CLIENTS) as ex:
            self.sent = list(ex.map(lambda tx: self.call(
                "eth_sendRawTransaction", "0x" + tx.encode().hex()), txs))
        walls["c_admit"] = time.perf_counter() - t0
        parent = self.payload.blocks[-1].header
        coinbase = "0x" + PAYLOAD_COINBASE.hex()
        attrs = {"timestamp": hex(parent.timestamp + 12), "prevRandao": "0x" + "00" * 32,
                 "suggestedFeeRecipient": coinbase,
                 "withdrawals": [{"index": hex(w.index), "validatorIndex": hex(w.validator_index),
                                  "address": "0x" + w.address.hex(), "amount": hex(w.amount)}
                                 for w in wds]}
        head = "0x" + self.head11.hex()
        t0 = time.perf_counter()
        fcu = self.call("engine_forkchoiceUpdatedV2", {"headBlockHash": head,
                                                       "safeBlockHash": head,
                                                       "finalizedBlockHash": head},
                        attrs, auth=True)
        self.fcu_attrs = fcu["payloadStatus"]
        got = self.call("engine_getPayloadV2", fcu["payloadId"], auth=True)
        torch_sync()
        walls["c_build"] = time.perf_counter() - t0
        payload = self.payload_json = got["executionPayload"]
        msg = {"feeRecipient": coinbase, "value": "0x0"}
        t0 = time.perf_counter()
        self.valid = self.call("flashbots_validateBuilderSubmissionV3",
                               {"executionPayload": payload, "message": msg})
        torch_sync()
        walls["c_validate"] = time.perf_counter() - t0
        flipped = dict(payload)
        root = bytearray(bytes.fromhex(payload["stateRoot"][2:]))
        root[0] ^= 0x01
        flipped["stateRoot"] = "0x" + bytes(root).hex()
        host = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
        flipped["blockHash"] = "0x" + payload_to_block(flipped, host).hash.hex()
        t0 = time.perf_counter()
        self.invalid = self.call("flashbots_validateBuilderSubmissionV3",
                                 {"executionPayload": flipped, "message": msg})
        torch_sync()
        walls["c_validate_flipped"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.status = self.call("engine_newPayloadV2", payload, auth=True)
        torch_sync()
        walls["c_new_payload"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        new_head = payload["blockHash"]
        self.fcu = self.call("engine_forkchoiceUpdatedV2", {
            "headBlockHash": new_head, "safeBlockHash": head, "finalizedBlockHash": head},
            auth=True)["payloadStatus"]
        walls["c_fcu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.latest = self.call("eth_getBlockByNumber", "latest", False)
        status, raw = http_post(self.ports[0], json.dumps(
            [rpc_request("eth_getTransactionReceipt", ["0x" + tx.hash.hex()], i)
             for i, tx in enumerate(txs)]).encode())
        self.receipts = json.loads(raw) if status == 200 else []
        walls["c_reads"] = time.perf_counter() - t0
        self.unauthorized = http_post(self.ports[1], json.dumps(rpc_request(
            "engine_exchangeCapabilities", [[]])).encode())[0]

    def check(self) -> None:
        """a) each proof's JSON the direct ProofCalculator call's at block 11,
        each account and storage proof verified against its root; b) each
        witness the "stateless" path's to_json(); c) block 12 VALID at its
        header's root with 245 of 245, the bad-root submission invalid, the
        reads the tree's, 401 without the token; 0 kernel faults on both
        servers, no sparse or catch-all fallback; the pool empty."""
        from reth_tpu_torch.metrics import producer_metrics
        from reth_tpu_torch.trie.proof import ProofCalculator

        tree = self.tree
        t0 = time.perf_counter()
        resps = sorted(self.proof_resps, key=lambda r: r["id"])
        if len(resps) != len(self.proof_reqs) or any("error" in r for r in resps):
            raise AssertionError(f"rpc: {len(resps)} proof responses, errors "
                                 f"{[r['error'] for r in resps if 'error' in r][:3]}")
        view = tree.overlay_provider(self.head11)
        calc = ProofCalculator(view, tree.committer)
        for (addr, slots), r in zip(self.proof_reqs, resps):
            direct = calc.account_proof(bytes.fromhex(addr[2:]),
                                        [int(s, 16).to_bytes(32, "big") for s in slots])
            if r["result"] != proof_json(addr, direct):
                raise AssertionError(f"rpc: eth_getProof({addr}, {len(slots)} slots) differs "
                                     f"from the direct ProofCalculator call")
        torch_sync()
        direct_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_storage = verify_proofs(self.root11, [r["result"] for r in resps])
        self.proof_check = (direct_s, time.perf_counter() - t0, n_storage)
        for blk, w, got in zip(self.payload.blocks, self.payload.witnesses, self.witness_json):
            if got != json.loads(json.dumps(w.to_json())):
                raise AssertionError(f"rpc: debug_executionWitness({blk.header.number}) differs "
                                     f"from the stateless path's witness")
        sent_ok = self.sent == ["0x" + tx.hash.hex() for tx in self.batch]
        payload = self.payload_json
        block_hash = bytes.fromhex(payload["blockHash"][2:])
        entry = tree.blocks.get(block_hash)
        batch = sorted("0x" + tx.hash.hex() for tx in self.batch)
        if not sent_ok or entry is None or self.fcu_attrs["status"] != "VALID":
            raise AssertionError(f"rpc: block 12's admission or build failed "
                                 f"({sum(a == b for a, b in zip(self.sent, batch))} hashes)")
        txs_12 = ["0x" + tx.hash.hex() for tx in entry.block.transactions]
        if (self.status["status"], self.status["latestValidHash"], self.fcu["status"]) != (
                "VALID", payload["blockHash"], "VALID") or tree.head_hash != block_hash:
            raise AssertionError(f"rpc: block 12: newPayload {self.status}, fcU {self.fcu}")
        if entry.block.header.state_root.hex() != payload["stateRoot"][2:] or \
                sorted(txs_12) != batch or len(txs_12) != len(self.batch):
            raise AssertionError(f"rpc: block 12 carries {len(txs_12)} of {len(self.batch)}")
        if self.valid != {"status": "Valid", "proposerPayment": self.valid.get(
                "proposerPayment")} or self.invalid.get("status") != "Invalid" or \
                not self.invalid.get("validationError", "").startswith("state root mismatch"):
            raise AssertionError(f"rpc: builder validation {self.valid}, flipped {self.invalid}")
        latest = self.latest
        if (latest["hash"], latest["number"], latest["transactions"]) != (
                payload["blockHash"], hex(entry.block.header.number), txs_12):
            raise AssertionError("rpc: eth_getBlockByNumber(latest) is not the tree's block 12")
        receipts = sorted(self.receipts, key=lambda r: r["id"])
        want = {"0x" + tx.hash.hex(): (i, rc) for i, (tx, rc) in enumerate(
            zip(entry.block.transactions, entry.receipts))}
        for tx, r in zip(self.batch, receipts):
            i, rc = want["0x" + tx.hash.hex()]
            got = r.get("result") or {}
            if (got.get("blockHash"), got.get("transactionIndex"), got.get("status"),
                    got.get("cumulativeGasUsed"), len(got.get("logs", ()))) != (
                    payload["blockHash"], hex(i), hex(1 if rc.success else 0),
                    hex(rc.cumulative_gas_used), len(rc.logs)):
                raise AssertionError(f"rpc: the receipt of {tx.hash.hex()} is not the tree's")
        if len(receipts) != len(self.batch) or self.unauthorized != 401:
            raise AssertionError(f"rpc: {len(receipts)} receipts; an engine call without the "
                                 f"token answered HTTP {self.unauthorized}")
        faults = [s.kernel_faults for s in self.servers]
        fallbacks = (producer_metrics.fallback_total() - self.fallbacks0[0],
                     tree.sparse_fallbacks - self.fallbacks0[1])
        if faults != [0, 0] or fallbacks != (0, 0) or len(self.pool):
            raise AssertionError(f"rpc: kernel faults {faults}, fallbacks (catch-all, sparse) "
                                 f"{fallbacks}, {len(self.pool)} transactions left in the pool")
        log(f"rpc: {len(resps)} eth_getProof responses equal to the direct ProofCalculator "
            f"calls and verified against block 11's root ({n_storage} storage proofs); "
            f"witnesses of blocks {[b.header.number for b in self.payload.blocks]} equal "
            f"the stateless path's; block 12 VALID at its header's root with {len(txs_12)} of "
            f"{len(self.batch)} transactions, the flipped root '{self.invalid['validationError'][:40]}"
            f"...', latest and {len(receipts)} receipts the tree's, HTTP 401 without the token; "
            f"0 kernel faults, 0 fallbacks")

    def report(self, launches: dict) -> None:
        w = self.walls
        n = len(self.proof_reqs)
        log(f"rpc: a) {n} eth_getProof in one batch: {w['a_batch']:.4f} s over HTTP "
            f"({n / w['a_batch']:.1f} proofs/s, {self.proof_bytes} bytes of JSON), "
            f"{w['a']:.4f} s with the requests' making; the direct calls "
            f"{self.proof_check[0]:.4f} s and the verification {self.proof_check[1]:.4f} s "
            f"outside the path")
        log(f"rpc: b) debug_executionWitness {[round(x, 4) for x in w['b_blocks']]} s, "
            f"{w['b']:.4f} s")
        log(f"rpc: c) block 12 {w['c']:.4f} s: admission {w['c_admit']:.4f} s "
            f"({len(self.batch)} eth_sendRawTransaction, {RPC_CLIENTS} clients), fcU + "
            f"getPayload {w['c_build']:.4f} s, builder validation {w['c_validate']:.4f} s "
            f"(flipped root {w['c_validate_flipped']:.4f} s), newPayload "
            f"{w['c_new_payload']:.4f} s, fcU {w['c_fcu']:.4f} s, latest + "
            f"{len(self.batch)} receipts {w['c_reads']:.4f} s")
        log(f"rpc: launches {json.dumps(launches)}")


# the "net" path: the sync path's database at block 8 behind a port
# NetworkManager on 127.0.0.1 (fixed node keys), a client from the genesis
# tables: blocks 0..NET_ERA_TO from era1 archives over HTTP, the rest online
NET_SERVER_KEY, NET_CLIENT_KEY, NET_THIRD_KEY = 0x5E12E7, 0xC11E47, 0x7D12D
NET_ERA_FILES = ((0, 2), (3, SYNC_UNWIND_TO))  # the era1 archives' block ranges
NET_RESPONSE_BYTES = 512 * 1024  # every snap response at most (the host's MAC cost)
NET_TRIE_PATHS = (b"", b"\x01", b"\x5a\x10", b"\xf0\x0f\xf0")  # account-trie paths asked


class WireCounter:
    """Counts one RLPx session's frames and bytes from its own side: frames
    sent and received, their payloads as framed (after snappy) and as the
    messages were (before snappy), and the bytes on the wire (the 32-byte
    header and its MAC, the payload padded to 16, the frame MAC)."""

    def __init__(self, session):
        self.counts = {d: {"frames": 0, "wire": 0, "framed": 0, "messages": 0}
                       for d in ("sent", "received")}
        send_frame, send_msg, parse = session.send_frame, session.send_msg, session.parse_frame

        def count(direction, framed):
            c = self.counts[direction]
            c["frames"] += 1
            c["framed"] += framed
            c["wire"] += 32 + framed + (-framed % 16) + 16

        def counted_send_frame(payload):
            count("sent", len(payload))
            return send_frame(payload)

        def counted_send_msg(msg_id, body):
            self.counts["sent"]["messages"] += len(body)
            return send_msg(msg_id, body)

        def counted_parse(frame):
            count("received", len(frame))
            msg_id, body = parse(frame)
            self.counts["received"]["messages"] += len(body)
            return msg_id, body

        session.send_frame, session.send_msg = counted_send_frame, counted_send_msg
        session.parse_frame = counted_parse

    def delta(self, before: dict) -> dict:
        return {d: {k: v - before[d][k] for k, v in c.items()} for d, c in self.counts.items()}

    def snapshot(self) -> dict:
        return json.loads(json.dumps(self.counts))


class NetCell:
    """The "net" path: networking, the online stages and era archives on the
    "sync" path's database at block 8 (251,372 accounts, 8 blocks of 245
    transactions; its first sync's published tables, ``SyncCell.first``),
    served by ``NetworkManager(device="cuda")`` on 127.0.0.1 with a fixed
    node key, beside a ``Discv4`` and the era1 archives of blocks 0-4 (two
    files and an ``index.txt`` of sha256 sums, ``export_era`` from the
    server's database) on an ``http.server`` thread, and ``admin_*`` behind
    the port's ``RpcServer``. The client is a ``MemDb`` over the sync's
    genesis tables. Legs:

    a) discovery: a client ``Discv4`` bootstraps off the server's enode and
       bonds; the client's ``NetworkManager`` dials the discovered record's
       enode over encrypted RLPx with snappy on;
    b) era: ``Pipeline(client, [EraStage(EraDownloader(HttpEraSource(url),
       cache), EthBeaconConsensus(device="cuda")), *default_stages(
       device="cuda")]).run(4)``: MerkleStage from checkpoint 0 on kernels
       2-3, the consensus roots and hashing on kernel 1;
    c) online: ``sync_from_peer(client, peer)`` (no pipeline): Headers and
       Bodies baselined at 4, blocks 5-8 over eth/68, the offline tail on
       the card;
    d) snap, at header 8's root, every response at most NET_RESPONSE_BYTES:
       ``GetAccountRange`` from 0x00.., mid keyspace and the last account's
       key, ``GetStorageRanges`` of the storage writer, ``GetByteCodes`` of
       every genesis code, ``GetTrieNodes`` of NET_TRIE_PATHS; the server
       proves on kernel 1; the leg runs under cProfile (the client's thread:
       its ingress MAC's keccak and snappy);
    e) admin over HTTP: ``admin_nodeInfo``, ``admin_peers``, then
       ``admin_addPeer`` / ``admin_removePeer`` of a third manager."""

    def __init__(self, sync: "SyncCell"):
        self.sync = sync
        self.dir = Path(HERE) / "reth_tpu_torch" / "build" / f"net-{os.getpid()}"
        self.walls: dict[str, float] = {}
        self.closers: list = []

    def start(self) -> None:
        """The server, its discovery, its archives over HTTP and its admin RPC."""
        import http.server

        from reth_tpu_torch.era import export_era
        from reth_tpu_torch.era_sync import EraSource
        from reth_tpu_torch.net import NetworkManager, Status
        from reth_tpu_torch.net.discv4 import Discv4
        from reth_tpu_torch.rpc import RpcServer
        from reth_tpu_torch.rpc.admin import AdminApi
        from reth_tpu_torch.storage import MemDb, ProviderFactory

        t0 = time.perf_counter()
        db = MemDb()
        db._tables = self.sync.first  # published maps are immutable
        self.served = ProviderFactory(db)
        with self.served.provider() as p:
            self.header8 = p.header_by_number(SYNC_BLOCKS)
        genesis = self.sync.genesis.hash
        self.status = Status(network_id=1, head=self.header8.hash, genesis=genesis)
        self.client_status = Status(network_id=1, head=genesis, genesis=genesis)
        self.server = NetworkManager(self.served, self.status, node_priv=NET_SERVER_KEY,
                                     device="cuda")
        self.closers.append(self.server.stop)
        port = self.server.start()
        self.disc = Discv4(NET_SERVER_KEY, host="127.0.0.1", tcp_port=port)
        self.disc.start()
        self.closers.append(self.disc.stop)
        src = self.dir / "archives"
        src.mkdir(parents=True, exist_ok=True)
        for i, (first, last) in enumerate(NET_ERA_FILES):
            export_era(self.served, first, last, src / f"sync-{i:05d}.era1")
        EraSource.build_index(src)
        self.era_bytes = sum(p.stat().st_size for p in src.glob("*.era1"))

        class Quiet(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **kw):
                super().__init__(*a, directory=str(src), **kw)

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
        threading.Thread(target=self.httpd.serve_forever, daemon=True,
                         name="net-era-http").start()
        self.closers.append(self.httpd.shutdown)
        self.rpc = RpcServer()
        self.rpc.register(AdminApi(self.server, self.disc, 1))
        self.rpc_port = self.rpc.start()
        self.closers.append(self.rpc.stop)
        self.walls["setup"] = time.perf_counter() - t0
        log(f"net: server {self.server.enode} (discv4 udp {self.disc.port}), era1 archives of "
            f"blocks {NET_ERA_FILES} ({self.era_bytes} B) on "
            f"http://127.0.0.1:{self.httpd.server_address[1]}, admin on 127.0.0.1:"
            f"{self.rpc_port}; set up in {self.walls['setup']:.3f} s")

    def close(self) -> None:
        import shutil

        for close in reversed(self.closers):
            try:
                close()
            except Exception as e:  # noqa: BLE001 — a fault kept by a manager raises here
                self.close_error = getattr(self, "close_error", None) or e
        self.closers = []
        shutil.rmtree(self.dir, ignore_errors=True)
        if getattr(self, "close_error", None) is not None:
            raise self.close_error

    def leg(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch_sync()
        self.walls[name] = time.perf_counter() - t0
        return out

    def drive(self) -> None:
        """Path "net": legs a-e, each one's wall kept."""
        self.start()
        self.requeued0 = self.requeued()
        self.leg("a", self.discover)
        self.leg("b", self.era)
        self.before_c = self.wire.snapshot()
        self.leg("c", self.online)
        self.wire_c = self.wire.delta(self.before_c)
        before = self.wire.snapshot()
        self.snap = self.leg("d", lambda: host_profile(
            "net, snap leg", self.snap_leg, focus=("keccak_f1600", "update", "digest",
                                                   "compress", "decompress", "_mac_step",
                                                   "_frame_mac", "recv_frame")))
        self.wire_d = self.wire.delta(before)
        self.leg("e", self.admin)

    @staticmethod
    def requeued() -> int:
        from reth_tpu_torch.net.downloader import BodiesDownloader

        return BodiesDownloader.requeued_total

    def discover(self) -> None:
        from reth_tpu_torch.net import NetworkManager
        from reth_tpu_torch.net.discv4 import Discv4
        from reth_tpu_torch.storage import MemDb, ProviderFactory

        db = MemDb()
        db._tables = self.sync.genesis_tables
        self.client = ProviderFactory(db)
        self.client_net = NetworkManager(self.client, self.client_status,
                                         node_priv=NET_CLIENT_KEY, device="cuda")
        self.closers.append(self.client_net.stop)
        self.client_disc = Discv4(NET_CLIENT_KEY, host="127.0.0.1")
        self.client_disc.start()
        self.closers.append(self.client_disc.stop)
        self.client_disc.bootstrap([self.disc.enode()])
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            rec = self.client_disc.table.by_id.get(self.disc.node_id)
            if rec is not None and rec.bonded:
                break
            time.sleep(0.02)
        else:
            raise AssertionError("net: the client never bonded with the server's discv4")
        self.record = rec.enode()
        self.peer = self.client_net.connect_to(self.record)
        self.wire = WireCounter(self.peer.session)

    def era(self) -> None:
        from reth_tpu_torch.consensus import EthBeaconConsensus
        from reth_tpu_torch.era_sync import EraDownloader, EraStage, HttpEraSource
        from reth_tpu_torch.stages import Pipeline, default_stages

        url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.era_stage = EraStage(EraDownloader(HttpEraSource(url), self.dir / "cache"),
                                  EthBeaconConsensus(device="cuda"))
        stages = [self.era_stage, *default_stages(device="cuda")]
        self.era_rows: list[dict] = []
        Pipeline(self.client, [TimedStage(s, self.era_rows) for s in stages]).run(
            SYNC_UNWIND_TO)

    def online(self) -> None:
        from reth_tpu_torch.net import sync_from_peer

        self.tip = sync_from_peer(self.client, self.peer)

    def snap_leg(self) -> dict:
        from _torch_helpers import SyncChain

        from reth_tpu_torch.net import snap
        from reth_tpu_torch.primitives.keccak import keccak256

        peer, root = self.peer, self.header8.state_root
        with self.served.provider() as p:
            cur = p.tx.cursor("HashedAccounts")
            last = cur.last()[0]
        origins = (b"\x00" * 32, b"\x80" + b"\x00" * 31, last)
        out = {"origins": origins, "walls": {}}

        def timed(name, fn):
            t0 = time.perf_counter()
            res = fn()
            out["walls"][name] = time.perf_counter() - t0
            return res

        out["ranges"] = [timed(f"account range {i}", lambda o=o: peer.get_account_range(
            root, o, b"\xff" * 32, response_bytes=NET_RESPONSE_BYTES))
            for i, o in enumerate(origins)]
        self.writer = keccak256(SyncChain.WRITER)
        out["storage"] = timed("storage ranges", lambda: peer._snap_request(
            snap.GetStorageRanges(next(peer._req_ids), root, [self.writer], b"", b"",
                                  NET_RESPONSE_BYTES), snap.StorageRanges))
        self.code_hashes = sorted(self.sync.codes)
        out["codes"] = timed("byte codes", lambda: peer._snap_request(
            snap.GetByteCodes(next(peer._req_ids), self.code_hashes, NET_RESPONSE_BYTES),
            snap.ByteCodes))
        out["nodes"] = timed("trie nodes", lambda: peer._snap_request(
            snap.GetTrieNodes(next(peer._req_ids), root, [[p] for p in NET_TRIE_PATHS],
                              NET_RESPONSE_BYTES), snap.TrieNodes))
        return out

    def admin(self) -> None:
        from reth_tpu_torch.net import NetworkManager
        from reth_tpu_torch.storage import MemDb, ProviderFactory

        def call(method, *params):
            status, body = http_post(self.rpc_port, json.dumps(
                rpc_request(method, list(params))).encode())
            out = json.loads(body)
            if status != 200 or "error" in out:
                raise AssertionError(f"net: {method}: HTTP {status}, {out.get('error')}")
            return out["result"]

        third = NetworkManager(ProviderFactory(MemDb()), self.client_status,
                               node_priv=NET_THIRD_KEY, device="cuda")
        third.start()
        self.closers.append(third.stop)
        self.third = third
        self.admin_out = {"info": call("admin_nodeInfo"), "peers": call("admin_peers"),
                          "add": call("admin_addPeer", third.enode)}
        self.admin_out["peers_added"] = call("admin_peers")
        self.admin_out["remove"] = call("admin_removePeer", third.enode)
        self.admin_out["peers_removed"] = call("admin_peers")

    def check(self) -> None:
        """a) bonded, the dialed enode the server's, snappy on; b)-c) header
        8's root, Finish at 8, every data table equal to the sync's at block
        8 (store_digests; the stage checkpoints left out); d) each account
        range verified (``verify_account_range``) and equal to the server's
        HashedAccounts rows over its keys, the writer's slots its
        HashedStorages rows, each code and trie node hashing to what was
        asked; e) the admin answers; 0 swarm kernel faults, 0 peers
        penalized, 0 body windows re-queued."""
        from reth_tpu_torch.net import snap
        from reth_tpu_torch.net.rlpx import node_id
        from reth_tpu_torch.primitives.keccak import keccak256
        from reth_tpu_torch.primitives.rlp import encode_int, rlp_decode, rlp_encode
        from reth_tpu_torch.storage import tables as T

        if self.record.split("@")[0] != self.server.enode.split("@")[0] or \
                not self.peer.session.snappy_enabled:
            raise AssertionError(f"net: a) dialed {self.record}, snappy "
                                 f"{self.peer.session.snappy_enabled}")
        with self.client.provider() as p:
            header = p.header_by_number(SYNC_BLOCKS)
            checkpoints = {s: p.stage_checkpoint(s) for s in ("Era", "Headers", "Bodies",
                                                              "MerkleExecute", "Finish")}
        if self.tip != SYNC_BLOCKS or header is None or header.hash != self.header8.hash or \
                header.state_root != self.header8.state_root or checkpoints["Finish"] != 8:
            raise AssertionError(f"net: c) tip {self.tip}, checkpoints {checkpoints}")
        skip = ("StageCheckpoints", "StageCheckpointProgresses")
        want_names = sorted(n for n, t in self.sync.first.items() if t and n not in skip)
        got_names = sorted(n for n, t in self.client.db._tables.items() if t and n not in skip)
        t0 = time.perf_counter()
        want = table_digests(self.served.db, want_names)
        got = store_digests(self.client.db, want_names)
        if got != want or got_names != want_names:
            raise AssertionError(f"net: c) the client's tables differ from the sync's at block "
                                 f"8: {[n for n in want_names if got.get(n) != want[n]]}, "
                                 f"tables {got_names}")
        digest_s = time.perf_counter() - t0
        root = self.header8.state_root
        run = self.snap
        n_accounts = 0
        with self.served.provider() as p:
            for origin, rng in zip(run["origins"], run["ranges"]):
                if not rng.accounts or not snap.verify_account_range(root, origin, rng):
                    raise AssertionError(f"net: d) the range from {origin.hex()} does not "
                                         f"verify ({len(rng.accounts)} accounts)")
                cur = p.tx.cursor("HashedAccounts")
                entry = cur.seek(origin)
                for key, body in rng.accounts:
                    if entry is None or entry[0] != key or \
                            snap.slim_account(T.decode_account(entry[1])) != body:
                        raise AssertionError(f"net: d) the range from {origin.hex()} differs "
                                             f"from HashedAccounts at {key.hex()}")
                    entry = cur.next()
                n_accounts += len(rng.accounts)
                size = sum(32 + len(b) for _, b in rng.accounts) + sum(map(len, rng.proof))
                if size > NET_RESPONSE_BYTES + 4096:
                    raise AssertionError(f"net: d) a range of {size} B")
            slots = [(v[:32], v) for _k, v in p.tx.cursor("HashedStorages").walk_dup(
                self.writer)]
        got_slots = run["storage"].slots
        if len(got_slots) != 1 or [h for h, _ in got_slots[0]] != [h for h, _ in slots]:
            raise AssertionError(f"net: d) the writer's storage range has "
                                 f"{sum(map(len, got_slots))} slots of {len(slots)}")
        for (h, body), (_h, row) in zip(got_slots[0], slots):
            if body != rlp_encode(encode_int(T.decode_storage_entry(row)[1])):
                raise AssertionError(f"net: d) the writer's slot {h.hex()} differs")
        codes = run["codes"].codes
        if sorted(keccak256(c) for c in codes) != self.code_hashes:
            raise AssertionError(f"net: d) {len(codes)} codes of {len(self.code_hashes)}")
        nodes = run["nodes"].nodes
        refs = {root}
        for n in nodes:
            item = rlp_decode(n)
            for child in (item[:16] if len(item) == 17 else item[1:]):
                if isinstance(child, bytes) and len(child) == 32:
                    refs.add(child)
        if not nodes or keccak256(nodes[0]) != root or any(
                keccak256(n) not in refs for n in nodes if len(n) >= 32):
            raise AssertionError(f"net: d) {len(nodes)} trie nodes do not chain to the root")
        info, add = self.admin_out["info"], self.admin_out["add"]
        client_id, third_id = node_id(NET_CLIENT_KEY).hex(), node_id(NET_THIRD_KEY).hex()
        ids = lambda key: [x["id"] for x in self.admin_out[key]]  # noqa: E731
        if info["enode"] != self.server.enode or client_id not in ids("peers") or \
                add is not True or third_id not in ids("peers_added") or \
                self.admin_out["remove"] is not True or third_id in ids("peers_removed"):
            raise AssertionError(f"net: e) admin answered {json.dumps(self.admin_out)[:400]}")
        penalized = [n.hex()[:16] for m in (self.server, self.client_net)
                     for n, r in m.peers_manager.peers.items() if r.reputation < 0]
        faults = (self.server.kernel_faults, self.client_net.kernel_faults)
        requeued = self.requeued() - self.requeued0
        if faults != (0, 0) or penalized or requeued:
            raise AssertionError(f"net: kernel faults {faults}, penalized {penalized}, "
                                 f"{requeued} body windows re-queued")
        self.counts = dict(accounts=n_accounts, slots=len(slots), codes=len(codes),
                           nodes=len(nodes), digest_s=digest_s, checkpoints=checkpoints)
        log(f"net: a) bonded and dialed the discovered enode, snappy on; c) header 8's root "
            f"{root.hex()}, checkpoints {json.dumps(checkpoints)}, every row of "
            f"{len(want_names)} tables equal to the sync's at block 8 ({digest_s:.1f} s); "
            f"d) {n_accounts} accounts in {len(run['ranges'])} ranges, each verified and equal "
            f"to HashedAccounts, {len(slots)} writer slots, {len(codes)} codes, {len(nodes)} "
            f"trie nodes chained to the root; e) nodeInfo, peers, add and remove as asked; "
            f"0 kernel faults, 0 peers penalized, 0 body windows re-queued")

    def report(self, launches: dict) -> None:
        w = self.walls
        log(f"net: legs a {w['a']:.3f} s (discovery, bond, dial), b {w['b']:.3f} s (era import "
            f"of blocks 1-{SYNC_UNWIND_TO} and the offline stages), c {w['c']:.3f} s (online "
            f"{SYNC_UNWIND_TO + 1}-{SYNC_BLOCKS}), d {w['d']:.3f} s (snap under cProfile), e "
            f"{w['e']:.3f} s (admin); set-up {w['setup']:.3f} s outside the path")
        for r in self.era_rows:
            log(f"net: b) {r['stage']} {r['kind']} {r['wall_s']:.4f} s")
        log(f"net: d) " + ", ".join(f"{k} {v:.3f} s" for k, v in self.snap["walls"].items()))
        for leg, delta in (("c", self.wire_c), ("d", self.wire_d)):
            for d, c in delta.items():
                log(f"net: {leg}) wire {d}: {c['frames']} frames, {c['wire']} B on the wire, "
                    f"{c['framed']} B framed (after snappy), {c['messages']} B of messages "
                    f"(before snappy)")
        log(f"net: launches {json.dumps(launches)}")


def attempt_future(fut, timeout: float = 120.0) -> tuple:
    """A submitted transaction's outcome: ("ok", hash) or ("err", class,
    message)."""
    try:
        return ("ok", fut.result(timeout))
    except Exception as e:  # noqa: BLE001 — the outcome is the observation
        return ("err", type(e).__name__, str(e))


def wait_producer(prod, pool, tree, attrs, timeout: float = 300.0) -> None:
    """Wait until the producer's candidate is at pool parity on the head
    with ``attrs``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if prod.fault is not None:
            raise prod.fault
        with prod._lock:
            cand = prod.candidate
            if (cand is not None and cand.window is None and cand.attrs == attrs
                    and cand.parent_hash == tree.head_hash and cand.pool_seq == pool.event_seq):
                return
        time.sleep(0.01)
    raise AssertionError(f"payload: the producer never reached pool parity: {prod.snapshot()}")


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


# the hot tip: one account trie of HOT_ACCOUNTS seeded keys, two sibling
# forks imported interleaved (A1 B1 A2 B2 ...), HOT_BLOCKS blocks a fork,
# each of HOT_WRITES writes (half of them keys of the fork's previous block)
# and HOT_DELETES deletes (the shape of bench.py's hotstate mode, at the trie
# level)
HOT_ACCOUNTS, HOT_BLOCKS, HOT_WRITES, HOT_DELETES = 262_144, 2, 2048, 128
HOT_NEW = 128  # of each block's writes, keys new to the fork (inserts)


def clone_trie(trie):
    """A structural copy of a fully revealed, hashed SparseTrie (refs
    included); blinds are shared, as nothing mutates one."""
    from reth_tpu_torch.trie import sparse as sp

    def cp(n):
        if n is None or isinstance(n, sp._Blind):
            return n
        if isinstance(n, sp._Leaf):
            c = sp._Leaf(n.path, n.value)
        elif isinstance(n, sp._Ext):
            c = sp._Ext(n.path, cp(n.child))
        else:
            c = sp._Branch([cp(x) for x in n.children], n.value)
        c._ref = n._ref
        return c

    out = sp.SparseTrie()
    out.root, out.root_hash = cp(trie.root), trie.root_hash
    return out


class HotStream:
    """The hot tip's block stream, made from (seed, block): blocks alternate
    between forks A and B; each writes HOT_WRITES keys of its fork (half
    from the fork's previous block, HOT_NEW new, the rest drawn from the
    fork's keys) and deletes HOT_DELETES others. Blocks are made on demand
    and kept, so two lineages replay the same stream."""

    def __init__(self, keys: list[bytes], seed: int = 17):
        self.seed = seed
        self.keys = {f: list(keys) for f in "AB"}  # each fork's live keys
        self.prev = {f: [] for f in "AB"}
        self.blocks: list[tuple[str, list, list]] = []  # (fork, writes, deletes)

    def block(self, i: int):
        while len(self.blocks) <= i:
            self._make(len(self.blocks))
        return self.blocks[i]

    def _make(self, i: int) -> None:
        from reth_tpu_torch.primitives.types import Account, encode_account

        fork = "AB"[i % 2]
        rng = np.random.default_rng([self.seed, i])
        live = self.keys[fork]
        prev = self.prev[fork]
        n_prev = min(len(prev), HOT_WRITES // 2)
        chosen = ([prev[int(j)] for j in rng.choice(len(prev), n_prev, replace=False)]
                  if prev else [])
        taken = set(chosen)
        while len(chosen) < HOT_WRITES - HOT_NEW:
            k = live[int(rng.integers(0, len(live)))]
            if k not in taken:
                taken.add(k)
                chosen.append(k)
        chosen += [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(HOT_NEW)]
        writes = [(k, encode_account(Account(nonce=int(rng.integers(0, 1000)),
                                             balance=int(rng.integers(1, 1 << 60)))))
                  for k in chosen]
        deletes = []
        while len(deletes) < HOT_DELETES:
            k = live[int(rng.integers(0, len(live)))]
            if k not in taken:
                taken.add(k)
                deletes.append(k)
        gone = set(deletes)
        self.keys[fork] = [k for k in live if k not in gone] + chosen[-HOT_NEW:]
        self.prev[fork] = [k for k, _ in writes]
        self.blocks.append((fork, writes, deletes))


class HotTip:
    """One lineage of the hot tip: per block a blind SparseTrie at the
    fork's root, revealed along the block's keys (through the shared
    TrieNodeCache when ``cached``, else, and for what the cache misses, by a
    "proof fetch": ``node_at`` on the fork's fully revealed CPU twin and
    ``reveal_at``), the block applied, the root committed by ``committer``
    on the card and held against the twin's (the twin: the same block
    applied and committed on the CPU with the numpy hasher), and, when
    cached, the block absorbed into the cache (``invalidate_key`` +
    ``harvest``). The cached lineage stamps its reveals and commits through
    a DigestArena; the cold one does neither."""

    def __init__(self, stream: HotStream, genesis, committer, cached: bool):
        from reth_tpu_torch.primitives.keccak import keccak256_batch_np
        from reth_tpu_torch.trie.hot_cache import TrieNodeCache
        from reth_tpu_torch.trie.sparse import ParallelSparseCommitter

        self.stream, self.committer, self.cached = stream, committer, cached
        self.twins = {f: clone_trie(genesis) for f in "AB"}
        self.roots = {f: genesis.root_hash for f in "AB"}
        self.cache = TrieNodeCache() if cached else None
        self.twin_committer = ParallelSparseCommitter(device="cpu")
        self.hash_np = keccak256_batch_np
        self.next = 0
        self.records: list[dict] = []

    def block(self) -> dict:
        """The next block of the stream on this lineage; returns its record."""
        import torch

        from reth_tpu_torch.trie.hot_cache import ACCOUNT_OWNER
        from reth_tpu_torch.trie.sparse import BlindedNodeError, SparseTrie, _encode_rlp

        fork, writes, deletes = self.stream.block(self.next)
        twin, cache = self.twins[fork], self.cache
        blind = SparseTrie(root_hash=self.roots[fork])
        blind.stamp_reveals = self.cached
        n = {"fetches": 0, "cache_unblinds": 0}
        c0 = dict(cache.stats()) if cache is not None else {}

        def fetch(path) -> None:
            node = twin.node_at(bytes(path))
            if node is None or not blind.reveal_at(bytes(path), _encode_rlp(node)):
                raise AssertionError(f"hot tip: the twin cannot reveal {bytes(path).hex()}")
            n["fetches"] += 1

        def apply(op) -> None:
            for _ in range(400):
                try:
                    return op()
                except BlindedNodeError as e:
                    path = bytes(e.path)
                    h = blind.blind_hash_at(path)
                    rlp = cache.lookup(ACCOUNT_OWNER, path, h) if cache and h else None
                    if rlp is not None and blind.reveal_at(path, rlp):
                        n["cache_unblinds"] += 1
                        continue
                    fetch(path)
            raise AssertionError("hot tip: the reveal loop did not converge")

        t0 = time.perf_counter()
        for k, _ in writes + [(k, None) for k in deletes]:
            if cache is not None and cache.reveal_through(blind, ACCOUNT_OWNER, k):
                continue
            apply(lambda k=k: blind.get(k))
        for k, v in writes:
            apply(lambda k=k, v=v: blind.update(k, v))
        for k in deletes:
            apply(lambda k=k: blind.delete(k))
        reveal_s = time.perf_counter() - t0
        if blind.root is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        with GcPauses() as gcp:
            t0 = time.perf_counter()
            (root,) = self.committer.commit([blind])
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stats = dict(self.committer.last)
        for k, v in writes:
            twin.update(k, v)
        for k in deletes:
            twin.delete(k)
        (want,) = self.twin_committer.commit([twin], self.hash_np)
        if root != want:
            raise AssertionError(f"hot tip: block {self.next} ({fork}) root differs from the "
                                 f"CPU twin's")
        arena = getattr(self.committer, "arena", None)
        if arena is not None:
            snap = arena.snapshot()
            pinned = arena.engine.pinned_bytes() if arena.engine is not None else 0
            if snap["faults"] or snap["leaked_rows"] or pinned:
                raise AssertionError(f"hot tip: a fault, a leaked row or pinned staging left "
                                     f"after block {self.next}: {snap}, {pinned} B pinned")
        absorb_s = 0.0
        if cache is not None:
            t0 = time.perf_counter()
            changed = [k for k, _ in writes] + deletes
            for k in changed:
                cache.invalidate_key(ACCOUNT_OWNER, k)
            cache.harvest(blind, ACCOUNT_OWNER, changed)
            cache.record_block()
            absorb_s = time.perf_counter() - t0
        self.roots[fork] = root
        c1 = cache.stats() if cache is not None else {}
        rec = {"block": self.next, "fork": fork, "root": root.hex()[:16],
               "finish_s": round(wall, 4), "finish_gc_s": gcp.stats()["gc_s"],
               "reveal_s": round(reveal_s, 4), "absorb_s": round(absorb_s, 4),
               "proof_fetches": n["fetches"], "cache_unblinds": n["cache_unblinds"],
               "cache_hits": c1.get("hits", 0) - c0.get("hits", 0),
               "cache_misses": c1.get("misses", 0) - c0.get("misses", 0),
               "cache_entries": c1.get("entries", 0),
               "poison_caught": c1.get("poison_caught", 0) - c0.get("poison_caught", 0),
               "hashed": stats.get("hashed"), "h2d_bytes": stats.get("h2d_bytes"),
               "stamped_rows": stats.get("stamped_rows"),
               "delta_fraction": stats.get("delta_fraction"),
               "arena_fresh": stats.get("arena_fresh"), "root_bytes": root}
        self.records.append(rec)
        self.next += 1
        return rec


def hot_genesis(seed: int = 19):
    """The hot tip's genesis account trie: HOT_ACCOUNTS seeded hashed keys
    with account values, built and hashed on the CPU (numpy hasher).
    Returns (trie, keys)."""
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.primitives.types import Account, encode_account
    from reth_tpu_torch.trie.sparse import ParallelSparseCommitter, SparseTrie

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, size=(HOT_ACCOUNTS, 32), dtype=np.uint8)
    keys = [bytes(k) for k in np.unique(keys.view("S32").ravel()).view(np.uint8).reshape(-1, 32)]
    balances = rng.integers(1, 1 << 60, size=len(keys))
    t = SparseTrie()
    for i, k in enumerate(keys):
        t.update(k, encode_account(Account(nonce=i % 300, balance=int(balances[i]))))
    ParallelSparseCommitter(device="cpu").commit([t], keccak256_batch_np)
    return t, keys


def hot_tip_setup():
    """The hot tip's genesis and stream, and its two lineages: the cold one
    (no cache, no arena, no stamping; the classic fused finish on the card,
    subtrie_levels=8) driven over the whole stream here, outside the main
    paths, and the cached one (stamped reveals through a TrieNodeCache, the
    arena's delta finish on the card) returned for the main path "hot tip"."""
    from reth_tpu_torch.ops.fused_commit import DigestArena
    from reth_tpu_torch.trie.sparse import ParallelSparseCommitter

    log(f"hot tip: {HOT_BLOCKS} blocks a fork (cut from 8 to 4 to make room for the control "
        f"plane's phases, and to 2 for the MerkleStage cell's, inside the time limit)")
    t0 = time.perf_counter()
    genesis, keys = hot_genesis()
    log(f"hot tip: genesis account trie of {len(keys)} keys built and hashed on the CPU in "
        f"{time.perf_counter() - t0:.1f} s, root {genesis.root_hash.hex()}")
    stream = HotStream(keys)
    cold = HotTip(stream, genesis, ParallelSparseCommitter(subtrie_levels=8, device="cuda"),
                  cached=False)
    hot = HotTip(stream, genesis, ParallelSparseCommitter(arena=DigestArena(), device="cuda"),
                 cached=True)
    t0 = time.perf_counter()
    for _ in range(2 * HOT_BLOCKS):
        cold.block()
    log(f"hot tip, cold lineage: {len(cold.records)} blocks ({HOT_WRITES} writes, "
        f"{HOT_DELETES} deletes each) in {time.perf_counter() - t0:.1f} s, outside the main "
        f"paths, every root equal to its fork's CPU twin")
    return hot, cold


def hot_tip_report(hot: HotTip, cold: HotTip) -> None:
    """Each hot-tip block on both lineages: the same root (each already held
    against its fork's twin), and, cached / cold, proof fetches, the
    cache's hits, misses and entries, stamped rows and delta fraction,
    bytes staged to the card and the finish wall."""
    arena = hot.committer.arena
    for h, c in zip(hot.records, cold.records):
        if h["root_bytes"] != c["root_bytes"]:
            raise AssertionError(f"hot tip: block {h['block']} root differs between the cached "
                                 f"and the cold lineage")
        log(f"hot tip, block {h['block']} ({h['fork']}), cached / cold: proof fetches "
            f"{h['proof_fetches']} / {c['proof_fetches']}, cache hits {h['cache_hits']}, misses "
            f"{h['cache_misses']}, entries {h['cache_entries']}, cache unblinds "
            f"{h['cache_unblinds']}, hashed {h['hashed']} / {c['hashed']}, stamped rows "
            f"{h['stamped_rows']}, delta fraction {h['delta_fraction']}, h2d bytes "
            f"{h['h2d_bytes']} / {c['h2d_bytes']}, finish {h['finish_s']} / {c['finish_s']} s "
            f"(collector {h['finish_gc_s']} / {c['finish_gc_s']} s), "
            f"reveal {h['reveal_s']} / {c['reveal_s']} s, absorb {h['absorb_s']} s, full epoch "
            f"{h['arena_fresh']}")
    n = len(cold.records)
    recs = hot.records[:n]

    def total(rs, key):
        return sum(r[key] for r in rs)

    def median(rs, key):
        v = sorted(r[key] for r in rs)
        return v[len(v) // 2]

    snap = arena.snapshot()
    log(f"hot tip: {n} blocks, every root equal on both lineages and to the twins; proof "
        f"fetches {total(recs, 'proof_fetches')} cached / {total(cold.records, 'proof_fetches')} "
        f"cold; cache {json.dumps(hot.cache.stats())}; stamped rows "
        f"{total(recs, 'stamped_rows')}, mean delta fraction "
        f"{total(recs, 'delta_fraction') / n:.4f}; h2d bytes {total(recs, 'h2d_bytes')} / "
        f"{total(cold.records, 'h2d_bytes')}; median finish {median(recs, 'finish_s')} / "
        f"{median(cold.records, 'finish_s')} s, median reveal {median(recs, 'reveal_s')} / "
        f"{median(cold.records, 'reveal_s')} s, median absorb {median(recs, 'absorb_s')} s; "
        f"arena {json.dumps(snap)}")
    if snap["faults"] or snap["leaked_rows"] or snap["full_epochs"] != 1:
        raise AssertionError(f"hot tip: the arena faulted, leaked or left its delta epochs "
                             f"on a clean path: {snap}")


def join_supervised(timeout: float = 120.0) -> int:
    """Join every watchdog worker thread (``supervised-*``): one the watchdog
    abandoned may still call into a dropped engine and launch on the card,
    so no launch counter is read, and the script does not exit, while one
    runs. Returns how many were found; raises if one outlives ``timeout``."""
    return join_threads("supervised-", timeout)


def journal_size(backend) -> tuple[int, int]:
    """A SupervisedBackend's journal: (entries, bytes of the host arrays it
    holds). It only grows until the commit's terminal call and is kept
    until the next begin, so after a commit this is its peak."""
    arrays = [a for _, args in backend._journal for a in args if isinstance(a, np.ndarray)]
    return len(backend._journal), sum(a.nbytes for a in arrays)


def supervisor_startup():
    """The --hasher auto startup: a DeviceSupervisor (default budgets and
    breaker, its own registry) runs its real probe, a child process that
    loads kernel 1 and hashes keccak256(b"") on the card. Fails unless the
    probe is ok and the breaker closed."""
    from reth_tpu_torch.metrics import MetricsRegistry
    from reth_tpu_torch.ops.supervisor import DeviceSupervisor

    sup = DeviceSupervisor(registry=MetricsRegistry())
    ok = sup.startup()
    if not ok or sup.breaker.state != "closed":
        raise AssertionError(f"startup probe failed: {sup.last_probe.diag}; breaker "
                             f"{sup.breaker.state}")
    log(f"supervisor startup: probe ok in {sup.last_probe.latency:.3f} s (a child process: "
        f"torch import, CUDA context, kernel 1 loaded, keccak256(b'') on the card), breaker "
        f"{sup.breaker.state}, dispatch budget {sup.dispatch_budget} s")
    return sup


# -- the control plane: warm-up and the shared hash service ---------------------

# bench.py's RETH_TPU_BENCH_MODE=service workload: clients x requests a client
# x keys a request, 64-byte keys from seed 7, the lanes round-robin by client
SVC_CLIENTS, SVC_REQS, SVC_KEYS = 8, 300, 4


def join_threads(prefix: str, timeout: float = 120.0) -> int:
    """Join every thread whose name starts with ``prefix`` (an abandoned
    warm-up step still launches once its injected sleep ends); raises if one
    outlives ``timeout``. Returns how many were found."""
    found = [t for t in threading.enumerate() if t.name.startswith(prefix)]
    for t in found:
        t.join(timeout)
    alive = [t.name for t in found if t.is_alive()]
    if alive:
        raise AssertionError(f"threads still running after {timeout} s: {alive}")
    return len(found)


def warmup_child(cache_dir: str) -> int:
    """``--warmup-child DIR``: one warm-up run in a fresh process (nothing of
    the port loaded yet): ``build_warmup(supervisor=, cache_dir=DIR)`` over
    ``default_menu()``, with the cache probe child and each shape's wall and
    kernel launches recorded. Prints one JSON line."""
    sys.path.insert(0, HERE)
    from reth_tpu_torch.metrics import MetricsRegistry
    from reth_tpu_torch.ops import _build
    from reth_tpu_torch.ops import fused_commit as fc
    from reth_tpu_torch.ops import keccak as ok
    from reth_tpu_torch.ops import warmup as ow
    from reth_tpu_torch.ops.supervisor import DeviceSupervisor

    nvcc_runs: list[str] = []
    command = _build._command

    def counted(src, out):
        if src.suffix == ".cu":
            nvcc_runs.append(src.name)
        return command(src, out)

    _build._command = counted
    wrapper = {"keccak.masked": ok.keccak256_words_masked,
               "keccak.exact": ok.keccak256_words_masked, "fused.plain": fc.packed_level,
               "fused.splice": fc.packed_level, "fused.subtrie": fc.subtrie_levels}
    shapes = {}

    def builder(shape):
        w = wrapper[shape.program]
        before = w.launches
        t0 = time.perf_counter()
        ow.build_shape(shape, "cuda")
        shapes[str(shape)] = {"wall_s": round(time.perf_counter() - t0, 4),
                              "launches": w.launches - before}

    sup = DeviceSupervisor(registry=MetricsRegistry())
    mgr = ow.build_warmup(supervisor=sup, cache_dir=cache_dir, builder=builder,
                          registry=MetricsRegistry())
    t0 = time.perf_counter()
    snap = mgr.run()
    print(json.dumps({"snapshot": snap, "wall_s": round(time.perf_counter() - t0, 3),
                      "nvcc_runs": nvcc_runs, "builds": mgr.builds, "shapes": shapes,
                      "validate": mgr.cache.last_report, "breaker": sup.breaker.state,
                      "wedges": mgr.wedges}))
    return 0


def run_warmup_child(base, what: str) -> dict:
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--warmup-child", str(base)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"warm-up child ({what}) failed rc={r.returncode}: "
                             f"{r.stderr[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["process_s"] = round(time.perf_counter() - t0, 3)
    return out


def warmup_phase() -> dict:
    """Warm-up on the card, cold and warm: ``build_warmup`` over the default
    menu in a fresh child process on a fresh cache directory (every shape
    WARM, misses equal to the shapes, nvcc run for both kernel libraries),
    then a second child on the same directory (hits equal to the shapes, no
    nvcc run), then the cache probe child alone, then the drill of a
    truncated library (the third child quarantines the directory and
    rebuilds). Each shape's wall and launches are logged."""
    import shutil
    from pathlib import Path

    from reth_tpu_torch.ops import _build
    from reth_tpu_torch.ops import warmup as ow
    from reth_tpu_torch.ops.supervisor import probe_device

    base = Path(HERE) / "reth_tpu_torch" / "build" / f"warmup-cache-{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    cache_dir = ow.CompileCache(base).dir
    total = len(ow.default_menu())
    out = {}
    try:
        for what in ("cold", "warm"):
            res = out[what] = run_warmup_child(base, what)
            snap = res["snapshot"]
            hits, misses = (0, total) if what == "cold" else (total, 0)
            want_nvcc = sorted(_build.KERNEL_SOURCES) if what == "cold" else []
            if (snap["state"], snap["warm"], snap["cache_hits"], snap["cache_misses"],
                    sorted(res["nvcc_runs"]), snap["cache"]["loaded_elsewhere"]) != \
                    ("warm", total, hits, misses, want_nvcc, 0) or \
                    snap["cache"]["mode"] != what or \
                    any(v["launches"] != 1 for v in res["shapes"].values()):
                raise AssertionError(f"warm-up, {what} cache: {json.dumps(res)}")
            log(f"warm-up, {what} cache ({res['process_s']} s for the child process, run() "
                f"{res['wall_s']} s): {snap['warm']}/{snap['total']} shapes WARM, hits "
                f"{snap['cache_hits']}, misses {snap['cache_misses']}, nvcc runs "
                f"{res['nvcc_runs']}, libraries built {res['builds']}, cache {snap['cache']}, "
                f"validate {res['validate']}, breaker {res['breaker']}")
            log(f"warm-up, {what} cache, each shape's wall and launches: "
                + ", ".join(f"{k} {v['wall_s']} s x{v['launches']}"
                            for k, v in res["shapes"].items()))
        probe = probe_device(cache_dir=str(cache_dir))
        if not probe.ok:
            raise AssertionError(f"the cache probe child failed: {probe.diag}")
        out["probe_s"] = round(probe.latency, 3)
        log(f"warm-up, the cache probe child (kernel 1 loaded from {cache_dir.name}, "
            f"keccak256(b'') on the card): ok in {probe.latency:.3f} s")
        lib = _build.library_path(_build.CUDA_SRC_DIR / "keccak.cu", cache_dir)
        data = lib.read_bytes()
        lib.write_bytes(data[:len(data) // 3])
        res = out["truncated"] = run_warmup_child(base, "truncated")
        snap = res["snapshot"]
        quarantined = sorted(p.name for p in base.glob("*.quarantine-*"))
        if (res["validate"]["quarantined"], res["validate"]["corrupt"], snap["state"],
                snap["cache_misses"], sorted(res["nvcc_runs"]), len(quarantined)) != \
                (True, 1, "warm", total, sorted(_build.KERNEL_SOURCES), 1):
            raise AssertionError(f"warm-up, truncated library: {json.dumps(res)}")
        log(f"warm-up drill, {lib.name} truncated to {len(data) // 3} of {len(data)} bytes: "
            f"validate {res['validate']}, the directory quarantined as {quarantined[0]}, "
            f"rebuilt (nvcc runs {res['nvcc_runs']}), {snap['warm']}/{snap['total']} shapes "
            f"WARM, misses {snap['cache_misses']} ({res['process_s']} s)")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


def state_root_warming(run_path, recorder, accounts, storages) -> tuple:
    """The main paths "state_root degraded" and "state_root warming":
    state_root() through TrieCommitter(supervisor=, warmup=) while a warm-up
    manager, started in the background, is held at the menu's first shape
    (a builder that waits on an event): every bucket is hashed on the host,
    counted in cpu_routed, and no kernel is launched. Then the manager is
    released and finishes (outside the main paths), and the same committer
    runs again: cpu_routed does not grow and every bucket goes through
    kernel 1. Returns both runs' (root, details)."""
    from reth_tpu_torch.metrics import MetricsRegistry
    from reth_tpu_torch.ops import warmup as ow
    from reth_tpu_torch.ops.supervisor import DeviceSupervisor
    from reth_tpu_torch.trie.committer import TrieCommitter
    from reth_tpu_torch.trie.state_root import state_root

    sup = DeviceSupervisor(registry=MetricsRegistry())
    held = ow.default_menu()[0]
    release = threading.Event()

    def builder(shape):
        if shape == held:
            release.wait()
        ow.build_shape(shape, "cuda")

    recorder.path = None
    mgr = ow.WarmupManager(supervisor=sup, builder=builder, budget=600, attempts=1, backoff=0,
                           registry=MetricsRegistry())
    committer = TrieCommitter(supervisor=sup, warmup=mgr, device="cuda")
    mgr.start()
    deadline = time.monotonic() + 60
    while mgr.snapshot()["compiling"] != str(held):
        if time.monotonic() > deadline:
            raise AssertionError(f"warm-up never reached {held}: {mgr.snapshot()}")
        time.sleep(0.005)
    t0 = time.perf_counter()
    degraded = run_path("state_root degraded",
                        lambda: state_root(accounts, storages, committer=committer))
    wall_degraded = time.perf_counter() - t0
    dev = committer.hasher._device.__self__
    routed, host = mgr.cpu_routed, dev.host_hashed
    if routed == 0 or host == 0 or sup.failovers:
        raise AssertionError(f"state_root degraded: cpu_routed {routed}, host-hashed {host}, "
                             f"failovers {sup.failovers}")
    log(f"state_root degraded (warm-up held at {held}, {mgr.overall_state()}): "
        f"{wall_degraded:.3f} s, {routed} buckets routed to the CPU twin, {host} messages hashed "
        f"on the host, no launch")
    recorder.path = None  # the warm-up's own launches belong to no main path
    t0 = time.perf_counter()
    release.set()
    mgr.wait(300)
    snap = mgr.snapshot()
    if snap["state"] != "warm" or snap["warm"] != snap["total"]:
        raise AssertionError(f"warm-up did not finish warm: {snap}")
    log(f"warm-up released: {snap['warm']}/{snap['total']} shapes WARM in "
        f"{time.perf_counter() - t0:.3f} s, compile walls {snap['compile_wall_s']} s")
    t0 = time.perf_counter()
    warm = run_path("state_root warming",
                    lambda: state_root(accounts, storages, committer=committer))
    wall_warm = time.perf_counter() - t0
    if mgr.cpu_routed != routed or dev.host_hashed != host or sup.failovers:
        raise AssertionError(f"state_root warming: cpu_routed {routed} -> {mgr.cpu_routed}, "
                             f"host-hashed {host} -> {dev.host_hashed} after warm-up")
    log(f"state_root warming (warm-up {mgr.overall_state()}): {wall_warm:.3f} s, cpu_routed "
        f"stayed {routed}, every bucket through kernel 1 ({dev.uploads} host-to-device copies "
        f"by its KeccakDevice)")
    return degraded, warm


def service_workload() -> list[list[bytes]]:
    rng = np.random.default_rng(7)
    return [[rng.integers(0, 256, size=64, dtype=np.uint8).tobytes() for _ in range(SVC_KEYS)]
            for _ in range(SVC_CLIENTS * SVC_REQS)]


def run_clients(workload, dispatch) -> tuple[float, list, list]:
    """bench.py's clients: SVC_CLIENTS threads, each its SVC_REQS requests
    on lane ``client % 4``; returns (wall s, digests by request, each
    request's round trip in s)."""
    from reth_tpu_torch.ops.hash_service import LANES

    out = [None] * len(workload)
    lat = [0.0] * len(workload)
    errs: list = []

    def worker(c):
        try:
            for i in range(c * SVC_REQS, (c + 1) * SVC_REQS):
                t0 = time.perf_counter()
                out[i] = dispatch(LANES[c % 4], workload[i])
                lat[i] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — raised below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(c,)) for c in range(SVC_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return time.perf_counter() - t0, out, lat


def service_path(run_path, recorder, launches) -> None:
    """The main path "service": bench.py's service workload through
    HashService(backend=KeccakDevice(1024, block_tier=4).hash_batch), after
    the same requests per call (each request its own launch, outside the
    main paths). Every digest equals keccak256_batch_np's; no replay, and
    fewer kernel-1 launches than requests. Logs both walls, the coalesce
    factor, the dispatches and each lane's wait."""
    from reth_tpu_torch.metrics import MetricsRegistry
    from reth_tpu_torch.ops.hash_service import HashService
    from reth_tpu_torch.ops.keccak import KeccakDevice
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np

    workload = service_workload()
    flat = [m for r in workload for m in r]
    want = keccak256_batch_np(flat)
    recorder.path = None
    direct = KeccakDevice(min_tier=1024, block_tier=4, device="cuda").hash_batch
    direct(workload[0])
    wall_direct, out_direct, lat_direct = run_clients(workload, lambda lane, msgs: direct(msgs))
    svc = HashService(backend=KeccakDevice(min_tier=1024, block_tier=4, device="cuda").hash_batch,
                      registry=MetricsRegistry())
    try:
        wall_svc, out_svc, lat_svc = run_path(
            "service", lambda: run_clients(workload, lambda lane, msgs: svc.hash(lane, msgs)))
    finally:
        svc.stop()
    n_req = len(workload)
    for label, out in (("per call", out_direct), ("service", out_svc)):
        if [d for r in out for d in r] != want:
            raise AssertionError(f"service workload, {label}: a digest differs from numpy's")
    k1 = launches["service"]["keccak256_absorb"]
    if svc.replays or not 0 < k1 < n_req:
        raise AssertionError(f"service: replays {svc.replays}, kernel-1 launches {k1} for "
                             f"{n_req} requests")
    _c, svc_total, svc_n = svc.metrics._service.snapshot()
    waits = [w for lane in svc._waits.values() for w in lane]
    handoff = np.mean(lat_svc) - np.mean(waits) - svc_total / svc_n
    log(f"service workload ({SVC_CLIENTS} clients x {SVC_REQS} requests x {SVC_KEYS} keys of 64 "
        f"bytes, seed 7): per call {wall_direct:.3f} s ({len(flat) / wall_direct:.1f} hashes/s, "
        f"{n_req} launches), coalesced {wall_svc:.3f} s ({len(flat) / wall_svc:.1f} hashes/s), "
        f"{svc.dispatches} dispatches, coalesce factor {svc.coalesce_factor():.2f}, "
        f"{k1} kernel-1 launches, replays {svc.replays}; every digest equals numpy's")
    log(f"service round trip per request: per call p50 {np.percentile(lat_direct, 50) * 1e3:.3f} "
        f"/ p99 {np.percentile(lat_direct, 99) * 1e3:.3f} ms, service p50 "
        f"{np.percentile(lat_svc, 50) * 1e3:.3f} / p99 {np.percentile(lat_svc, 99) * 1e3:.3f} ms; "
        f"mean dispatch (service time) {svc_total / svc_n * 1e3:.3f} ms, mean queue wait "
        f"{np.mean(waits) * 1e3:.3f} ms, mean round trip less both (hand-off and the interpreter "
        f"lock) {handoff * 1e3:.3f} ms; lane waits {json.dumps(svc.lane_waits())}")
    # the coalesced run once more, after the counts were read: the card's
    # busy time and idle share (its cProfile sees the joining thread only)
    recorder.path = None
    svc = HashService(backend=KeccakDevice(min_tier=1024, block_tier=4, device="cuda").hash_batch,
                      registry=MetricsRegistry())
    try:
        profile_path("service, coalesced",
                     lambda: run_clients(workload, lambda lane, msgs: svc.hash(lane, msgs)))
    finally:
        svc.stop()


def rebuild_leased(run_path, rebuild, committer, service) -> list:
    """The main path "rebuild leased": the full rebuild through
    TurboCommitter(hash_service=service) on the default engine, one lease a
    commit, while one thread keeps submitting 4-key live-lane requests (each
    held against numpy). Requires leases equal to the commits and no replay;
    logs the lease bypasses and the live lane's waits."""
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np

    stop = threading.Event()
    live = {"requests": 0, "bad": 0, "lat": []}

    def live_client():
        rng = np.random.default_rng(11)
        while not stop.is_set():
            msgs = [rng.integers(0, 256, size=64, dtype=np.uint8).tobytes() for _ in range(4)]
            t0 = time.perf_counter()
            got = service.hash("live", msgs)
            live["lat"].append(time.perf_counter() - t0)
            live["requests"] += 1
            live["bad"] += got != keccak256_batch_np(msgs)
            time.sleep(0.001)

    def drive():
        t = threading.Thread(target=live_client, name="live-client")
        t.start()
        try:
            return rebuild(committer, "rebuild leased engine")
        finally:
            stop.set()
            t.join()

    res = run_path("rebuild leased", drive)
    snap = service.snapshot()
    if snap["leases"] != 2 or snap["replays"] or live["bad"] or snap["leased_by"] is not None:
        raise AssertionError(f"rebuild leased: {snap}, live client {live['requests']} requests, "
                             f"{live['bad']} wrong")
    lat = np.array(live["lat"])
    log(f"rebuild leased: {snap['leases']} leases for 2 commits, {snap['lease_bypasses']} lease "
        f"bypasses (aged live requests hashed on the twin), replays 0; live client "
        f"{live['requests']} requests, round trip p50 {np.percentile(lat, 50) * 1e3:.3f} / p99 "
        f"{np.percentile(lat, 99) * 1e3:.3f} ms, lane waits {json.dumps(service.lane_waits())}")
    return res


# the "mesh" path's rosters: the real topology, and one card named four and
# three times (three: tiers the members do not divide evenly)
MESH_ROSTERS = ((None, "HashMesh.build(1)"), (4, "cuda:0 x4"), (3, "cuda:0 x3"))
MESH_ENGINES = ((0, "FusedMeshEngine"), (8, "SubtrieMeshEngine k=8"))
MESH_LEASED = 2  # members the service leases to the rebuild, of four
MESH_WEDGED = 2  # the member the drill wedges
MESH_RESET_S = 0.5  # the drill's breaker cooldown
MESH_SINGLE_ROWS = 16_380  # sharded_keccak's one-block rows (divisible by 3 and 4)


class MeshCell:
    """The "mesh" path: the port's member mesh (parallel/mesh.py,
    ops/fused_commit.py FusedMeshEngine / SubtrieMeshEngine, the meshed
    HashService) on the card. Rosters may name cuda:0 more than once: each
    entry is a member with its own stream and its own replica of the digest
    buffer, so a roster of four runs the sharding, the exchange, the
    breakers and the lease on one card. No number of it is a multi-card
    figure.

    a) The rebuild (``rebuild``, slice_phase's) through TurboCommitter(mesh=)
       on each roster of MESH_ROSTERS, with each engine of MESH_ENGINES;
       roots and branch nodes must equal the "default" path's (``want``),
       and every live replica must be byte-equal after each commit (the
       engines check it at the terminal fetch). b) Kernel 1: MeshKeccak
       over the 65,543 messages of the kernel checks on four members, and
       sharded_keccak over one-block rows on four and three, each equal to
       kernel 1 on one member (``check_keccak``, after the path's counts).
       c) A meshed HashService leases MESH_LEASED of
       four members to the account trie's rebuild while a live client hashes
       on the other two: live dispatches complete during the lease, no lease
       bypass, the roots the default path's. d) The wedge drill: member
       MESH_WEDGED wedged (FaultInjector(device_wedge=)), shed, the batch
       replayed bit-identical on the three left, no numpy replay, one
       shrink; the member rejoins after its breaker's cooldown."""

    def __init__(self, rebuild, want, account_want, account_jobs, seed: int,
                 device: str = "cuda"):
        self.device = device  # "cpu" rehearses the path on the plain versions
        self.member = "cuda:0" if device == "cuda" else "cpu"
        self.rebuild = rebuild
        self.want = want
        self.account_want = account_want
        self.account_jobs = account_jobs
        self.seed = seed
        self.walls: dict[str, float] = {}
        self.stats: dict[str, str] = {}
        self.checks = {}

    def drive(self):
        self._rebuilds()
        self._keccak()
        self._lease()
        self._wedge()

    def _roster(self, n):
        from reth_tpu_torch.metrics import MetricsRegistry
        from reth_tpu_torch.parallel import HashMesh

        if n is None:
            return HashMesh.build(1, device=self.device, registry=MetricsRegistry())
        return HashMesh([self.member] * n, registry=MetricsRegistry())

    def _sync(self) -> None:
        if self.device == "cuda":
            torch_sync()

    def _rebuilds(self) -> None:
        from reth_tpu_torch.trie.turbo import TurboCommitter

        for n, roster in MESH_ROSTERS:
            hm = self._roster(n)
            for k, engine in MESH_ENGINES:
                c = TurboCommitter(backend="device", device=self.device, mesh=hm,
                                   subtrie_levels=k)
                made = track_engines(c, "_device_engine")
                self._sync()
                t0 = time.perf_counter()
                res = self.rebuild(c)
                self._sync()
                wall = time.perf_counter() - t0
                label = f"{roster}, {engine}"
                if [r.root for r in res] != [r.root for r in self.want]:
                    raise AssertionError(f"mesh: rebuild roots on {label} differ from the "
                                         f"default path's")
                if [r.branch_nodes for r in res] != [r.branch_nodes for r in self.want]:
                    raise AssertionError(f"mesh: rebuild branch nodes on {label} differ from "
                                         f"the default path's")
                checked = sum(e.replicas_checked for e in made)
                if checked != (len(made) if hm.n_devices > 1 else 0):
                    raise AssertionError(f"mesh: {checked} replica checks for {len(made)} "
                                         f"commits on {label}")
                self.walls[label] = wall
                self.stats[label] = (
                    f"{len(made)} commits, {sum(e.dispatches for e in made)} dispatches, "
                    f"{sum(e.member_launches for e in made)} member launches, "
                    f"{sum(e.exchanges for e in made)} exchanges, "
                    f"{sum(e.uploads for e in made)} host-to-device copies, replicas "
                    f"byte-equal after {checked} of them")
                log(f"mesh: rebuild on {label}: {wall:.3f} s wall; {len(res)} roots and "
                    f"{sum(len(r.branch_nodes) for r in res)} branch nodes equal the default "
                    f"path's; {self.stats[label]}")

    def _keccak(self) -> None:
        """Kernel 1's two mesh front-ends on the path; ``check_keccak``
        compares them with kernel 1 on one member afterwards, outside the
        path's counts."""
        from reth_tpu_torch.parallel import MeshKeccak, sharded_keccak
        from reth_tpu_torch.primitives.keccak import pad_batch

        rng = np.random.default_rng(self.seed)  # kernel_checks' 65,543 messages
        lens = list(rng.integers(0, 601, size=65536)) + [0, 135, 136, 271, 272, 543, 544]
        msgs = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lens]
        hm4 = self._roster(4)
        front = MeshKeccak(hm4, min_tier=1024, block_tier=4)
        t0 = time.perf_counter()
        four = front.hash_sharded(msgs, hm4.mesh)
        wall = time.perf_counter() - t0
        single = [rng.integers(0, 136, dtype=np.int64) for _ in range(MESH_SINGLE_ROWS)]
        words = np.ascontiguousarray(pad_batch(
            [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in single],
            1)).view("<u4").reshape(-1, 34)
        sharded = {n: sharded_keccak(self._roster(n), words) for n in (4, 3)}
        self._kernel1 = (front, hm4, msgs, four, words, sharded)
        self.checks["keccak"] = {"messages": len(msgs), "sharded_wall_s": round(wall, 4),
                                 "single_block_rows": MESH_SINGLE_ROWS}

    def check_keccak(self) -> None:
        """After the path: MeshKeccak's digests on four members and
        sharded_keccak's on four and three against kernel 1 on one member."""
        import torch

        from reth_tpu_torch.ops.keccak import keccak256_words
        from reth_tpu_torch.primitives.keccak import keccak256

        front, hm4, msgs, four, words, sharded = self._kernel1
        one = front.hash_sharded(msgs, hm4._mesh_for((0,)))
        if four != one or four[:64] != [keccak256(m) for m in msgs[:64]]:
            raise AssertionError("mesh: MeshKeccak on four members differs from kernel 1 on one")
        want = keccak256_words(torch.from_numpy(words).to(self.device), 1).cpu().numpy()
        for n, got in sharded.items():
            if not np.array_equal(got, want):
                raise AssertionError(f"mesh: sharded_keccak on {n} members differs from kernel "
                                     f"1 on one")
        log(f"mesh: MeshKeccak over {len(msgs)} messages on four members "
            f"({self.checks['keccak']['sharded_wall_s']:.3f} s) and sharded_keccak over "
            f"{MESH_SINGLE_ROWS} one-block rows on four and three members equal kernel 1 on "
            f"one member")

    def _lease(self) -> None:
        from reth_tpu_torch.metrics import MetricsRegistry
        from reth_tpu_torch.ops.hash_service import HashService
        from reth_tpu_torch.primitives.keccak import keccak256_batch_np
        from reth_tpu_torch.trie.turbo import TurboCommitter

        hm = self._roster(4)
        svc = HashService(mesh=hm, rebuild_devices=MESH_LEASED, registry=MetricsRegistry(),
                          device=self.device)
        try:
            c = TurboCommitter(backend="device", device=self.device, hash_service=svc)
            made = track_engines(c, "_device_engine")
            rng = np.random.default_rng(self.seed + 5)
            msgs = [rng.integers(0, 256, size=32, dtype=np.uint8).tobytes() for _ in range(512)]
            want = keccak256_batch_np(msgs)
            stop = threading.Event()
            live = {"during": 0, "total": 0, "bad": 0}

            def client():
                while not stop.is_set():
                    held = svc.rebuild_mesh() is not None
                    ok = svc.client("live")(msgs) == want
                    live["total"] += 1
                    live["bad"] += not ok
                    live["during"] += held and svc.rebuild_mesh() is not None

            t = threading.Thread(target=client, name="mesh-live-client")
            t.start()
            try:
                res = c.commit_hashed_pipelined(self.account_jobs, collect_branches=True,
                                                start_depth=2)
            finally:
                stop.set()
                t.join()
            snap = svc.snapshot()
        finally:
            svc.stop()
        if [r.root for r in res] != [r.root for r in self.account_want] or \
                [r.branch_nodes for r in res] != [r.branch_nodes for r in self.account_want]:
            raise AssertionError("mesh: the leased account-trie rebuild differs from the "
                                 "default path's")
        sizes = {e.mesh.size for e in made}
        if (not live["during"] or live["bad"] or snap["lease_bypasses"]
                or snap["mesh"]["submesh_leases"] != 1 or sizes != {MESH_LEASED}
                or snap["mesh"]["leased"] != 0):
            raise AssertionError(f"mesh: the sub-mesh lease: live {live}, engines over "
                                 f"{sizes} members, {snap}")
        self.checks["lease"] = {**live, "lease_bypasses": snap["lease_bypasses"],
                                "sharded": snap["mesh"]["sharded_dispatches"]}
        log(f"mesh: sub-mesh lease of {MESH_LEASED} of 4 members for the account trie's "
            f"rebuild (engine over {sizes} members, roots equal the default path's); live "
            f"lane {live['total']} requests, {live['during']} completed during the lease, 0 "
            f"wrong, 0 lease bypasses; service {json.dumps(snap['mesh'])}")

    def _wedge(self) -> None:
        from reth_tpu_torch.metrics import MetricsRegistry
        from reth_tpu_torch.ops.hash_service import HashService
        from reth_tpu_torch.ops.supervisor import DeviceBreakerBoard, FaultInjector
        from reth_tpu_torch.primitives.keccak import keccak256_batch_np

        hm = self._roster(4)
        inj = FaultInjector(device_wedge=(MESH_WEDGED,))
        board = DeviceBreakerBoard(hm, failure_threshold=1, reset_timeout=MESH_RESET_S)
        svc = HashService(mesh=hm, breaker_board=board, device_injector=inj,
                          registry=MetricsRegistry(), device=self.device)
        try:
            rng = np.random.default_rng(self.seed + 6)
            msgs = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
                    for n in rng.integers(1, 300, size=4096)]
            want = keccak256_batch_np(msgs)
            fut = svc.submit("live", msgs)
            shed_ok = fut.result(120) == want and fut.completions == 1
            shed = svc.snapshot()["mesh"]
            replays_shed = svc.replays
            inj.device_wedge = frozenset()  # the fault clears
            time.sleep(MESH_RESET_S + 0.2)
            back_ok = svc.client("payload")(msgs) == want
            back = svc.snapshot()["mesh"]
        finally:
            svc.stop()
        shrinks = hm.metrics._shrinks.value
        if not (shed_ok and back_ok and shed["healthy"] == 3 and shed["mesh_replays"] == 1
                and replays_shed == 0 and svc.replays == 0 and shrinks == 1
                and back["healthy"] == 4 and back["recoveries"] == 1
                and board.breakers[MESH_WEDGED].state == "closed"):
            raise AssertionError(f"mesh: the wedge drill: shed {shed}, back {back}, numpy "
                                 f"replays {svc.replays}, mesh_shrinks_total {shrinks}")
        self.checks["wedge"] = {"shed": MESH_WEDGED, "mesh_replays": shed["mesh_replays"],
                                "numpy_replays": svc.replays, "mesh_shrinks_total": shrinks,
                                "recoveries": back["recoveries"]}
        log(f"mesh: wedge drill: member {MESH_WEDGED} shed, the batch of {len(msgs)} replayed "
            f"bit-identical on 3 members (mesh replays {shed['mesh_replays']}, numpy replays 0, "
            f"mesh_shrinks_total {shrinks:.0f}); after the {MESH_RESET_S} s cooldown it rejoined "
            f"(recoveries {back['recoveries']}, breaker closed)")


def exchange_row(recorder, launches: dict, rng, ptxas: dict) -> dict:
    """The kernels line's row of exchange_slots, at the "mesh" path's median
    and largest launch: bit for bit against its plain version (index_copy_
    from each member's replica into the others') on fresh random replicas,
    and so is its first design, the debug entry exchange_slots_warp_row (a
    warp a row); then the two timed in turns by CUDA events (50 launches
    behind the holding spin kernel, as ab_ms), beside the plain version, the
    bound (bytes over the HBM rate: each row's slot and 32 bytes read once,
    32 bytes written to each other replica) and one index_copy_ of the same
    rows into the replicas stacked in one tensor, the source rows gathered
    beforehand (the library yardstick). The kernel is also timed at one row
    of the median launch (launch_floor_ms). Repeated launches find the rows
    in L2, as the main path's exchange does right after the level kernels
    wrote them: a time below the HBM bound is reported as L2-resident, not
    as a share of the bound above 1. ``ptxas``: the registers, stack and
    spills of each of the kernel's instances (a row a thread, and
    EXCHANGE_RIF rows a thread above one wave)."""
    import torch

    from reth_tpu_torch.ops import fused_commit as fc

    name = "exchange_slots"
    if fc.exchange_slots_warp_row.launches:
        raise AssertionError(f"the debug entry exchange_slots_warp_row launched "
                             f"{fc.exchange_slots_warp_row.launches} times before its timing")
    row = dict(name=name, route="cuda", source="reth_tpu_torch/ops/csrc/fused_level.cu",
               replaces="reth_tpu/ops/fused_commit.py:892",
               launches_by_path={p: launches[p][name] for p in PATHS}, ptxas=ptxas)
    row["launches"] = sum(row["launches_by_path"].values())
    calls = recorder.calls["mesh"][name]
    sizes = sorted(recorder.rows(name, a) for a in calls)
    log(f"{name} (main path mesh): {len(calls)} launches, rows per launch min {sizes[0]}, "
        f"median {sizes[len(sizes) // 2]}, max {sizes[-1]}; ptxas {ptxas}")
    for label, (slots, bounds, s_rows, m) in recorder.picks(name, "mesh").items():
        base = [torch.from_numpy(rng.integers(0, 256, size=(s_rows, 32), dtype=np.uint8)).to("cuda")
                for _ in range(m)]
        k_bufs = [b.clone() for b in base]
        w_bufs = [b.clone() for b in base]
        r_bufs = [b.clone() for b in base]
        fc.exchange_slots(k_bufs, slots, bounds)
        fc.exchange_slots_warp_row(w_bufs, slots, bounds)
        fc.exchange_slots_ref(r_bufs, slots, bounds)
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(k_bufs, r_bufs))
        err_w = max(max_abs_err(a, b) for a, b in zip(w_bufs, r_bufs))
        if err or err_w:
            raise AssertionError(f"{name} (max abs err {err}) or exchange_slots_warp_row (max "
                                 f"abs err {err_w}) differs from the plain version at the mesh "
                                 f"path's {label} launch")
        n = slots.shape[0]
        ms, warp_ms = ab_ms(lambda: fc.exchange_slots(k_bufs, slots, bounds),
                            lambda: fc.exchange_slots_warp_row(w_bufs, slots, bounds), 50)
        plain_ms = cuda_ms(lambda: fc.exchange_slots_ref(r_bufs, slots, bounds), 3)
        stacked = torch.stack(base).view(m * s_rows, 32)
        dst, src = [], []
        for j in range(m):
            own = slots[bounds[j]:bounds[j + 1]]
            for k in range(m):
                if k != j:
                    dst.append(own + k * s_rows)
                    src.append(own + j * s_rows)
        dst = torch.cat(dst)
        rows = stacked.index_select(0, torch.cat(src))
        lib_ms = cuda_ms(lambda: stacked.index_copy_(0, dst, rows), 50, hold_ms=HOLD_MS)
        nbytes = n * (8 + 32 + 32 * (m - 1))
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        l2 = ms < b_ms
        share = None if l2 else b_ms / ms
        log(f"{name} at the mesh path's {label} launch ({n} rows over {m} replicas of "
            f"{s_rows} rows, {nbytes} B): both designs bit-exact vs plain; kernel {ms:.4f} ms, "
            f"warp a row {warp_ms:.4f} ms, plain {plain_ms:.4f} ms, index_copy_ {lib_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms (bytes), "
            + ("below the HBM bound: L2-resident" if l2 else f"{share:.3f} of the bound"))
        if label == "median":
            one = [0] + [1] * m
            floor_ms = cuda_ms(lambda: fc.exchange_slots(k_bufs, slots[:1], one), 50,
                               hold_ms=HOLD_MS)
            log(f"{name} at one row over {m} replicas (the launch floor): {floor_ms:.4f} ms")
            row.update(max_abs_err=max(err, err_w), ms=ms, warp_row_ms=warp_ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes", library_ms=lib_ms,
                       launch_floor_ms=floor_ms, rows_timed=n, replicas=m)
        else:
            row.update(largest_ms=ms, largest_warp_row_ms=warp_ms, largest_plain_ms=plain_ms,
                       largest_bound_ms=b_ms, largest_library_ms=lib_ms,
                       largest_bound_share=share, largest_l2_resident=l2,
                       largest_rows_timed=n, largest_replicas=m)
    return row


def control_drills() -> list[dict]:
    """Drills of warm-up and the service on the card, each on its rung:
    a) RETH_TPU_FAULT_COMPILE_WEDGE=1 (the first step wedges past its budget,
    the retry warms the shape); b) a wedge forever with attempts=1 (the
    breaker trips, serving degrades to the host, and after the cooldown the
    real half-open probe promotes the shape); c)
    RETH_TPU_FAULT_SERVICE_WEDGE_EVERY=2 (a supervised service replays,
    every future completing once with equal digests; an unsupervised one
    fails every second future with the wedge and replays nothing); d) RETH_TPU_FAULT_SERVICE_QUEUE_CAP with
    block=False (LaneOverloaded); e) RETH_TPU_FAULT_SERVICE_STALL under a
    lease (aged requests bypass onto the twin)."""
    from reth_tpu_torch.metrics import MetricsRegistry
    from reth_tpu_torch.ops import keccak as ok
    from reth_tpu_torch.ops import warmup as ow
    from reth_tpu_torch.ops.hash_service import HashService, InjectedServiceWedge, LaneOverloaded
    from reth_tpu_torch.ops.keccak import KeccakDevice
    from reth_tpu_torch.ops.supervisor import CircuitBreaker, DeviceSupervisor, FaultInjector
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np

    out = []
    shape = ow.MenuShape("keccak.masked", 4, 1024)

    def env_armed(knobs: dict, make):
        os.environ.update(knobs)
        try:
            return make()
        finally:
            for k in knobs:
                del os.environ[k]

    t0 = time.perf_counter()
    sup = env_armed({"RETH_TPU_FAULT_COMPILE_WEDGE": "1"},
                    lambda: DeviceSupervisor(registry=MetricsRegistry()))
    mgr = ow.WarmupManager(menu=[shape], supervisor=sup, budget=2.0, attempts=3, backoff=0,
                           registry=MetricsRegistry())
    snap = mgr.run()
    join_threads("warmup-")
    if (snap["state"], mgr.wedges, mgr.retries, sup.injector.compiles_wedged,
            sup.breaker.state) != ("warm", 1, 1, 1, "closed"):
        raise AssertionError(f"drill a) compile wedge: {snap}")
    out.append({"drill": "a) RETH_TPU_FAULT_COMPILE_WEDGE=1", "rung": "retried, warm",
                "wedges": mgr.wedges, "retries": mgr.retries,
                "wall_s": round(time.perf_counter() - t0, 4)})
    log(f"control drill a) RETH_TPU_FAULT_COMPILE_WEDGE=1: wedged once past its 2 s budget, "
        f"retried, {snap['state']} ({out[-1]['wall_s']} s)")

    t0 = time.perf_counter()
    inj = FaultInjector(compile_wedge=-1)
    sup = DeviceSupervisor(breaker=CircuitBreaker(failure_threshold=1, reset_timeout=1.0),
                           injector=inj, registry=MetricsRegistry())
    mgr = ow.WarmupManager(menu=[shape], supervisor=sup, budget=1.0, attempts=1, backoff=0,
                           registry=MetricsRegistry())
    snap = mgr.run()
    dev = KeccakDevice(min_tier=1024, block_tier=4, warmup=mgr, device="cuda")
    msgs = [bytes([i % 251]) * 64 for i in range(1024)]
    k0 = ok.keccak256_words_masked.launches
    degraded_ok = dev.hash_batch(msgs) == keccak256_batch_np(msgs)
    degraded = (snap["state"], sup.breaker.state, dev.host_hashed,
                ok.keccak256_words_masked.launches - k0)
    if not degraded_ok or degraded != ("degraded", "open", len(msgs), 0):
        raise AssertionError(f"drill b) wedge forever: {degraded}, {snap}")
    with inj._lock:
        inj.compile_wedge = 0  # the fault clears
    time.sleep(1.2)  # past the breaker's cooldown
    probed = sup.allows_device()  # the real half-open probe, a child on the card
    deadline = time.monotonic() + 120
    while not mgr.device_ready() and time.monotonic() < deadline:
        time.sleep(0.05)
    join_threads("device-warmup-retry")
    join_threads("warmup-")
    k0 = ok.keccak256_words_masked.launches
    promoted_ok = dev.hash_batch(msgs) == keccak256_batch_np(msgs)
    promoted = (probed, mgr.overall_state(), sup.breaker.state, dev.host_hashed,
                ok.keccak256_words_masked.launches - k0)
    if not promoted_ok or promoted != (True, "warm", "closed", len(msgs), 1):
        raise AssertionError(f"drill b) half-open promotion: {promoted}, {mgr.snapshot()}")
    out.append({"drill": "b) compile wedge forever, attempts=1", "rung": "open, degraded, "
                "promoted", "probe_s": round(sup.last_probe.latency, 3),
                "wall_s": round(time.perf_counter() - t0, 4)})
    log(f"control drill b) compile wedge forever: breaker open, {len(msgs)} messages hashed on "
        f"the host while degraded, half-open probe ok in {sup.last_probe.latency:.3f} s, the "
        f"shape promoted and the next bucket launched kernel 1 ({out[-1]['wall_s']} s)")

    t0 = time.perf_counter()
    reqs = [[b"wedge-%d-%d" % (i, j) for j in range(4)] for i in range(16)]
    want = [keccak256_batch_np(r) for r in reqs]
    rungs = {}
    for rung, kw in (("replayed", {"supervisor": DeviceSupervisor(registry=MetricsRegistry())}),
                     ("raised", {})):
        svc = env_armed({"RETH_TPU_FAULT_SERVICE_WEDGE_EVERY": "2"},
                        lambda: HashService(registry=MetricsRegistry(), **kw))
        futs, outs = [], []
        for r in reqs:  # one at a time: one dispatch each, every second one wedged
            futs.append(svc.submit("payload", r))
            try:
                outs.append(futs[-1].result(60))
            except InjectedServiceWedge:
                outs.append(None)
        svc.stop()
        expect = want if rung == "replayed" else [
            None if i % 2 else d for i, d in enumerate(want)]
        if outs != expect or [f.completions for f in futs] != [1] * 16 or \
                (svc.replays, svc.failed_dispatches) != ((8, 0) if rung == "replayed" else (0, 8)):
            raise AssertionError(f"drill c) service wedge, {rung}: {svc.snapshot()}")
        rungs[rung] = svc
    out.append({"drill": "c) RETH_TPU_FAULT_SERVICE_WEDGE_EVERY=2",
                "rung": "replayed under a supervisor, raised without one",
                "replays": rungs["replayed"].replays,
                "raised": rungs["raised"].failed_dispatches,
                "wall_s": round(time.perf_counter() - t0, 4)})
    log(f"control drill c) RETH_TPU_FAULT_SERVICE_WEDGE_EVERY=2: supervised, "
        f"{rungs['replayed'].replays} of {rungs['replayed'].dispatches} dispatches replayed on "
        f"the twin, 16 futures completed once each, digests equal; unsupervised, "
        f"{rungs['raised'].failed_dispatches} futures raised the wedge, replays "
        f"{rungs['raised'].replays}, the other 8 digests equal")

    t0 = time.perf_counter()
    svc = env_armed({"RETH_TPU_FAULT_SERVICE_QUEUE_CAP": "4"},
                    lambda: HashService(registry=MetricsRegistry(), lease_bypass_s=30.0))
    with svc.lease("drill"):
        svc.submit("proof", [b"a"] * 4)
        try:
            svc.submit("proof", [b"b"], block=False)
            rejected = False
        except LaneOverloaded:
            rejected = True
    svc.stop()
    if not rejected or svc.rejects != 1 or svc.lane_capacity != 4:
        raise AssertionError(f"drill d) queue cap: {svc.snapshot()}")
    out.append({"drill": "d) RETH_TPU_FAULT_SERVICE_QUEUE_CAP=4, block=False",
                "rung": "LaneOverloaded", "rejects": svc.rejects,
                "wall_s": round(time.perf_counter() - t0, 4)})
    log("control drill d) RETH_TPU_FAULT_SERVICE_QUEUE_CAP=4: the fifth message raised "
        "LaneOverloaded under block=False")

    t0 = time.perf_counter()
    svc = env_armed({"RETH_TPU_FAULT_SERVICE_STALL": "0.05"},
                    lambda: HashService(registry=MetricsRegistry(), lease_bypass_s=0.01))
    reqs = [[b"stall-%d" % i] for i in range(8)]
    with svc.lease("drill"):
        outs = [svc.hash("live", r) for r in reqs]
        bypassed = svc.lease_bypasses
    after = svc.hash("live", [b"after"])
    svc.stop()
    if outs != [keccak256_batch_np(r) for r in reqs] or bypassed != len(reqs) or \
            after != keccak256_batch_np([b"after"]) or svc.injector.dispatches != 1:
        raise AssertionError(f"drill e) stall under a lease: {svc.snapshot()}")
    out.append({"drill": "e) RETH_TPU_FAULT_SERVICE_STALL=0.05 under a lease",
                "rung": "bypassed", "lease_bypasses": bypassed,
                "wall_s": round(time.perf_counter() - t0, 4)})
    log(f"control drill e) RETH_TPU_FAULT_SERVICE_STALL=0.05 under a lease: {bypassed} aged "
        f"requests bypassed onto the twin, then one stalled dispatch on the card")
    return out


def slice_phase(args, storage_jobs, account_jobs, sup, kids: dict):
    """The main paths (``PATHS``), each with the launch counts zeroed just
    before it and read just after; the supervised ones ("auto", "auto k=8",
    "state_root auto") through ``sup``. Starts the drills' child
    (``kids["drills"]``) before the MerkleStage cell. Returns the launch
    counts of each, the recorder holding each launch's arguments and the
    hot tip."""
    import torch

    from reth_tpu_torch.convert import jobs_to_device
    from reth_tpu_torch.metrics import MetricsRegistry, fused_metrics, pipeline_metrics
    from reth_tpu_torch.ops import fused_commit as fc
    from reth_tpu_torch.ops.hash_service import HashService
    from reth_tpu_torch.ops.keccak import KeccakDevice, keccak256_words_masked
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.trie.committer import TrieCommitter
    from reth_tpu_torch.trie.state_root import state_root
    from reth_tpu_torch.trie.turbo import TurboCommitter

    state = jobs_to_device(storage_jobs + account_jobs, "cuda")
    state_bytes = sum(t.numel() * t.element_size() for job in state for t in job)
    del state
    log(f"rebuild input on the card: {state_bytes} B "
        f"({sum(len(j[1]) for j in storage_jobs)} storage slots in {len(storage_jobs)} tries, "
        f"{sum(len(j[1]) for j in account_jobs)} accounts in {len(account_jobs)} prefix subtries)")

    reports: dict[str, list[dict]] = {}

    def rebuild(committer, label=None):
        """The rebuild's two commits; with a label, each commit's pipeline
        report (stage times, windows, queue peak, the backend that hashed
        it, and the k-level engine's rung) is logged and kept."""
        stages = []
        res = []
        for jobs, depth in ((storage_jobs, 0), (account_jobs, 2)):
            fused_metrics.last = None
            res += committer.commit_hashed_pipelined(jobs, collect_branches=True,
                                                     start_depth=depth)
            stages.append(dict(pipeline_metrics.last,
                               mode=(fused_metrics.last or {}).get("mode")))
        if label:
            reports[label] = stages
            for what, st in zip(("storage tries", "account trie"), stages):
                log(f"rebuild stages, {label}, {what}: wall {st['wall_s']} s = sweep "
                    f"{st['sweep_s']} (summed over the sweep threads) / pack {st['pack_s']} / "
                    f"dispatch {st['dispatch_s']} / fetch {st['fetch_s']} s; {st['windows']} "
                    f"windows of {st['groups']} sweep groups, queue peak {st['queue_peak']}; "
                    f"hashed by {st['backend']}, k-level rung {st['mode']}")
        return res

    accounts, storages = plain_state(args.state_accounts, args.state_slots, args.seed + 1)
    committers = {"default": TurboCommitter(backend="device", device="cuda"),
                  "k=8": TurboCommitter(backend="device", device="cuda", subtrie_levels=8),
                  "auto": TurboCommitter(backend="auto", device="cuda", supervisor=sup),
                  "auto k=8": TurboCommitter(backend="auto", device="cuda", supervisor=sup,
                                             subtrie_levels=8)}
    engines = {name: track_engines(c, "_device_engine") for name, c in committers.items()}
    backends = {name: track_engines(committers[name]) for name in AUTO_TWIN}
    # the control plane's services: the sparse finish's live lane (k-level
    # windows 8 levels a launch) and the leased rebuild's
    svc_sparse = HashService(subtrie_levels=8, registry=MetricsRegistry())
    svc_rebuild = HashService(registry=MetricsRegistry())
    leased = TurboCommitter(backend="device", device="cuda", hash_service=svc_rebuild)
    engines["rebuild leased"] = track_engines(leased, "_device_engine")
    fused = TrieCommitter(fused=True, device="cuda",
                          hasher=KeccakDevice(min_tier=1024, block_tier=4, device="cuda").hash_batch)
    sr_auto = TrieCommitter(supervisor=sup, device="cuda")
    wrappers = {"keccak256_absorb": keccak256_words_masked, "packed_level": fc.packed_level,
                "branch_level": fc.branch_level, "subtrie_levels": fc.subtrie_levels,
                "exchange_slots": fc.exchange_slots}

    recorder = MainPathRecorder()
    launches, got, walls, guarded = {}, {}, {}, {}
    fallbacks = fused_metrics._fallbacks.value
    cell = SparseCell(svc_sparse)
    cell.baseline()
    sparse_walls: dict[str, list] = {}
    hot, cold = hot_tip_setup()

    def run_path(path: str, drive):
        recorder.path = path
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        g0 = sup.guarded_calls
        t0 = time.perf_counter()
        out = drive()
        torch.cuda.synchronize()
        walls[path] = time.perf_counter() - t0
        join_supervised()
        launches[path] = {k: fn.launches for k, fn in wrappers.items()}
        guarded[path] = sup.guarded_calls - g0
        log(f"main path {path}: launches {json.dumps(launches[path])}; {host_memory()}")
        return out

    with recorder:
        for name, committer in committers.items():
            got[name] = run_path(name, lambda: rebuild(committer, f"{name} engine"))
        root_dev, det_dev = run_path("state_root",
                                     lambda: state_root(accounts, storages, committer=fused))
        root_auto, det_auto = run_path("state_root auto",
                                       lambda: state_root(accounts, storages, committer=sr_auto))
        n_engines = len(cell.engines)
        sparse_runs = {name: run_path(name, lambda: cell.drive(name, sparse_walls))
                       for name in SPARSE_PATHS}
        run_path("hot tip", lambda: [hot.block() for _ in range(2 * HOT_BLOCKS)])
        # the control plane: warm-up's degraded serving, the shared service
        (root_deg, det_deg), (root_warm, det_warm) = state_root_warming(
            run_path, recorder, accounts, storages)
        service_path(run_path, recorder, launches)
        service_runs = {name: run_path(name, lambda: cell.drive(name, sparse_walls))
                        for name in SERVICE_SPARSE_PATHS}
        got["rebuild leased"] = rebuild_leased(run_path, rebuild, leased, svc_rebuild)
        # the member mesh: rosters that name cuda:0 several times
        recorder.path = None
        mesh = MeshCell(rebuild, got["default"], got["default"][len(storage_jobs):],
                        account_jobs, args.seed)
        run_path("mesh", mesh.drive)
        log(f"main path mesh: {walls.pop('mesh'):.3f} s wall")
        recorder.path = None
        mesh.check_keccak()
        # every rebuild's numpy twin, outside the paths, while the sync
        # chain's child may still be sealing
        recorder.path = None
        t0 = time.perf_counter()
        want = rebuild(TurboCommitter(backend="numpy"))
        wall_np = time.perf_counter() - t0
        # the staged sync, its chain sealed on the host by the child process
        # started with the smoke; before the MerkleStage cell, whose twin
        # child takes longer
        recorder.path = None
        sync = SyncCell(kids["chain"].result())
        run_path("sync", sync.drive)
        log(f"main path sync: {walls.pop('sync'):.3f} s wall")
        sync.report(launches["sync"])
        sync.check()
        # startup recovery over datadirs made from the sync's database
        recovery = RecoveryCell(sync)
        try:
            run_path("recovery", recovery.drive)
            log(f"main path recovery: {walls.pop('recovery'):.3f} s wall")
            recovery.report(launches["recovery"])
        finally:
            recovery.close()
        # the engine tree over the sync path's genesis tables and chain
        recorder.path = None
        engine = EngineCell(sync)
        for name in ENGINE_PATHS:
            run_path(name, lambda: engine.drive(name))
            walls.pop(name)
            engine.check(name)
            engine.report(name, launches[name])
        # block production and stateless validation on the "engine" tree
        recorder.path = None
        payload = PayloadCell(engine)
        run_path("payload", payload.drive)
        log(f"main path payload: {walls.pop('payload'):.3f} s wall")
        payload.check_payload()
        payload.report(launches["payload"])
        run_path("stateless", payload.drive_stateless)
        log(f"main path stateless: {walls.pop('stateless'):.3f} s wall")
        payload.check_stateless()
        payload.report_stateless(launches["stateless"])
        # the JSON-RPC surface over that tree at block 11, then block 12
        rpc = RpcCell(payload)
        try:
            run_path("rpc", rpc.drive)
            log(f"main path rpc: {walls.pop('rpc'):.3f} s wall (a {rpc.walls['a']:.3f} s, "
                f"b {rpc.walls['b']:.3f} s, c {rpc.walls['c']:.3f} s)")
            recorder.path = None
            rpc.check()
            rpc.report(launches["rpc"])
        finally:
            rpc.close()
        # networking, the online stages and era archives over the sync's
        # database at block 8
        net = NetCell(sync)
        try:
            run_path("net", net.drive)
            log(f"main path net: {walls.pop('net'):.3f} s wall")
            recorder.path = None
            net.check()
            net.report(launches["net"])
        finally:
            net.close()
        # the drills, but the hot tip's, in a child process beside the paths
        # below
        kids["drills"] = ChildProcess("drills", "--drills", [])
        # the MerkleStage path, its state built outside the paths, its twin in
        # the child process started with the smoke
        recorder.path = None
        merkle = MerkleCell(args.accounts, args.slots, args.seed + 3, kids["twin"].result())
        run_path("merkle stage", merkle.drive_stage)
        log(f"main path merkle stage: {walls.pop('merkle stage'):.3f} s wall")
        merkle.report("merkle stage", merkle.rows)
        merkle.check_stage()
        merkle.restore(1)
        inc_walls = run_path("merkle incremental", merkle.drive_incremental)
        log(f"main path merkle incremental: {walls.pop('merkle incremental'):.3f} s wall; "
            + ", ".join(f"{k} {v:.3f} s" for k, v in inc_walls.items()))
        merkle.report("merkle incremental", merkle.rows)
        # the live tip on the same database, its blocks' writes as outputs
        recorder.path = None
        live = LiveTip(merkle)
        for name, drive in zip(LIVE_PATHS, (live.cold, live.cached, live.reused, live.service)):
            res = run_path(name, drive)
            walls.pop(name)
            live.report(res, launches[name])
            live.check(res)
        run_path("proofs", live.proofs)
        walls.pop("proofs")
        recorder.path = None
    merkle.check_incremental()
    live.finish_checks()
    live.check_proofs()
    svc_sparse_snap = svc_sparse.snapshot()
    svc_sparse_waits = svc_sparse.lane_waits()
    svc_sparse.stop()
    svc_rebuild.stop()
    wall_sr = walls.pop("state_root")
    wall_sr_auto = walls.pop("state_root auto")
    # state_root auto's unsupervised twin (KeccakDevice without the
    # supervisor), outside the main paths: its launches are not counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    root_plain, _ = state_root(accounts, storages, committer=TrieCommitter(device="cuda"))
    torch.cuda.synchronize()
    wall_sr_plain = time.perf_counter() - t0
    for _ in range(SPARSE_BLOCKS):
        cell.block("twin")
    cell.check(f"{SPARSE_BLOCKS} blocks")
    fused_engines = cell.engines[n_engines:]
    for name in SPARSE_PATHS:
        w = sorted(sparse_walls[name])
        hashed = [stats["hashed"] for _, stats in sparse_runs[name]]
        if name == "sparse":
            copies = (f"{cell.copies[name]} host-to-device copies (counted by KeccakDevice: "
                      f"words and counts per launch)")
        elif name == "sparse k=8":
            copies = (f"{sum(e.uploads for e in fused_engines)} host-to-device copies over "
                      f"{len(fused_engines)} SubtrieFusedEngine commits, "
                      f"{sum(e.levels_staged for e in fused_engines)} levels staged")
        else:
            copies = "one SubtrieFusedEngine (the arena's) across the blocks"
        log(f"sparse finish, {name}: median wall {w[len(w) // 2]:.4f} s over "
            f"{len(w)} blocks ({', '.join(f'{x:.4f}' for x in sparse_walls[name])}), "
            f"hashed nodes {hashed}, launches {json.dumps(launches[name])}, {copies}")
    for b, ((wk, sk), (wa, sa)) in enumerate(zip(sparse_runs["sparse k=8"],
                                                 sparse_runs["sparse arena"])):
        log(f"sparse arena beside sparse k=8, block {b}: finish {wa:.4f} / {wk:.4f} s, "
            f"launches {sa['launches']} / {sk['launches']}, staged rows {sa['staged_rows']} / "
            f"{sk['hashed']}, h2d bytes {sa['h2d_bytes']} / {sk['h2d_bytes']}; arena: resident "
            f"rows {sa['resident_rows']}, buffer {sa['buffer_rows']} rows, growths "
            f"{sa['growths']} ({sa['grown_bytes']} B, {sa['grow_ms']} ms on the card), pinned "
            f"{sa['pinned_bytes']} B after the epoch")
    for name in SERVICE_SPARSE_PATHS:
        w = sorted(sparse_walls[name])
        log(f"sparse finish, {name}: median wall {w[len(w) // 2]:.4f} s over {len(w)} blocks "
            f"({', '.join(f'{x:.4f}' for x in sparse_walls[name])}), streamed "
            f"{[stats['streamed'] for _, stats in service_runs[name]]}, launches "
            f"{json.dumps(launches[name])}")
        if not all(stats["streamed"] for _, stats in service_runs[name]):
            raise AssertionError(f"{name}: a block did not go through the live lane")
    if svc_sparse_snap["replays"] or not svc_sparse_snap["window_dispatches"]:
        raise AssertionError(f"the sparse finish's service: {svc_sparse_snap}")
    log(f"sparse finish's service (live lane): {json.dumps(svc_sparse_snap)}, lane waits "
        f"{json.dumps(svc_sparse_waits)}")
    hot_tip_report(hot, cold)
    summaries = {name: engine_summary(made) for name, made in engines.items()}
    if any(st["backend"] != "device" for st in reports["rebuild leased engine"]):
        raise AssertionError(f"rebuild leased: a commit left the card: "
                             f"{reports['rebuild leased engine']}")
    ladders = {name: {e.ladder for e in engines[name]} for name in ("k=8", "auto k=8")}
    if ladders != {"k=8": {False}, "auto k=8": {True}}:
        raise AssertionError(f"the k-level ladder is armed off the supervised route, or not "
                             f"on it: {ladders}")
    for made in engines.values():
        del made[:]
    for name, twin in AUTO_TWIN.items():
        sizes = [journal_size(b) for b in backends[name]]
        log(f"supervision cost, {name}: {walls[name]:.3f} s wall against {walls[twin]:.3f} s "
            f"for {twin} (unsupervised, same run); {guarded[name]} guarded calls (watchdog "
            f"threads started); journal at its peak per commit (storage tries, account trie): "
            + ", ".join(f"{n} entries holding {b} B" for n, b in sizes))
        for st in reports[f"{name} engine"]:
            if st["backend"] != "device" or (name == "auto k=8" and st["mode"] != "fused"):
                raise AssertionError(f"main path {name} left the device route: {st}")
        del backends[name][:]
    log(f"supervision cost, state_root auto: {wall_sr_auto:.3f} s wall against "
        f"{wall_sr_plain:.3f} s for the same committer without the supervisor (same run, "
        f"outside the main paths); {guarded['state_root auto']} guarded calls")
    snap = sup.snapshot()
    if (snap["failovers"], snap["dispatch_timeouts"], snap["dispatch_errors"], snap["breaker"],
            fused_metrics._fallbacks.value - fallbacks) != (0, 0, 0, "closed", 0):
        raise AssertionError(f"a failover, timeout, error or fallback on the main paths, which "
                             f"armed no fault: {snap}, k-level fallbacks "
                             f"{fused_metrics._fallbacks.value - fallbacks}")
    log(f"supervised main paths: breaker {snap['breaker']}, 0 failovers, 0 watchdog timeouts, "
        f"0 errors, 0 k-level fallbacks; every commit hashed on the device route")

    log(f"rebuild on the numpy twin (host): {wall_np:.3f} s wall")
    for name, res in got.items():
        hashed = sum(r.hashed_nodes for r in res)
        log(f"rebuild on the card, {name} engine: {walls[name]:.3f} s wall, {hashed} hashed "
            f"nodes, {hashed / walls[name]:.1f} hashed nodes/s; {summaries[name]}")
        if [r.root for r in res] != [r.root for r in want]:
            raise AssertionError(f"rebuild roots differ between the {name} engine and the numpy twin")
        if [r.branch_nodes for r in res] != [r.branch_nodes for r in want]:
            raise AssertionError(f"rebuild branch nodes differ between the {name} engine and "
                                 f"the numpy twin")
        log(f"rebuild, {name} engine: {len(res)} roots and "
            f"{sum(len(r.branch_nodes) for r in res)} branch nodes equal the numpy twin's")

    t0 = time.perf_counter()
    root_np, det_np = state_root(accounts, storages,
                                 committer=TrieCommitter(hasher=keccak256_batch_np))
    wall_sr_np = time.perf_counter() - t0
    if root_dev != root_np or det_dev["branch_nodes"] != det_np["branch_nodes"] \
            or det_dev["storage_roots"] != det_np["storage_roots"]:
        raise AssertionError("state_root differs between the fused card committer and numpy")
    log(f"state_root ({len(accounts)} accounts, {sum(len(s) for s in storages.values())} slots): "
        f"fused on the card {wall_sr:.3f} s, per-level numpy {wall_sr_np:.3f} s, "
        f"root {root_dev.hex()} equal")
    if root_auto != root_np or det_auto["branch_nodes"] != det_np["branch_nodes"] \
            or det_auto["storage_roots"] != det_np["storage_roots"] or root_plain != root_np:
        raise AssertionError("state_root differs between the supervised card committer and numpy")
    for what, (root, det) in (("degraded", (root_deg, det_deg)), ("warming", (root_warm, det_warm))):
        if root != root_np or det["branch_nodes"] != det_np["branch_nodes"] \
                or det["storage_roots"] != det_np["storage_roots"]:
            raise AssertionError(f"state_root {what} differs from the numpy committer's")
    log(f"state_root degraded and state_root warming (TrieCommitter(supervisor=, warmup=)): "
        f"root {root_warm.hex()}, branch nodes and storage roots equal numpy's on both runs")
    log(f"state_root auto (TrieCommitter(supervisor=...), kernel 1 through SupervisedHasher): "
        f"{wall_sr_auto:.3f} s, root, branch nodes and storage roots equal numpy's")
    for path, kernels in PATH_KERNELS.items():
        for name in KERNELS:
            if name in PATH_MAY.get(path, ()):
                continue
            if (launches[path][name] > 0) != (name in kernels):
                raise AssertionError(f"{name} was launched {launches[path][name]} times on main "
                                     f"path {path}, which launches {kernels} and no other kernel")
    for path in PATHS:
        for name in KERNELS:
            if len(recorder.calls[path][name]) != launches[path][name]:
                raise AssertionError(f"{name} on main path {path}: "
                                     f"{len(recorder.calls[path][name])} launches recorded, "
                                     f"{launches[path][name]} counted")
    # the template levels splice and hash in kernel 2; kernel 1 hashes keys
    # only, launched by KeccakDevice alone
    if (hasattr(fc, "keccak256_words_masked") or KECCAK_DEVICE not in recorder.callers
            or not recorder.callers <= {KECCAK_DEVICE, *KECCAK_MESH}):
        raise AssertionError(f"keccak256_absorb was launched from {sorted(recorder.callers)}; "
                             f"only {KECCAK_DEVICE} and the mesh's {KECCAK_MESH} launch it")
    log(f"keccak256_absorb launched only by {sorted(recorder.callers)}; state_root's template "
        f"levels went through packed_level ({launches['state_root']['packed_level']} launches)")
    # the rebuilds and state_root have no profiled runs since "recovery"
    # came (the time limit; their findings stand in PERF.md)
    for name in SPARSE_PATHS:
        profile_path(f"sparse finish, {name}", lambda: cell.close(name),
                     prepare=lambda: cell.apply(name),
                     focus=("_upload", "_engine", "hash_batch", "export_branch_updates",
                            "peek_slots", "begin_delta"))
    for _ in range(2):  # each card path's two profiled blocks
        cell.block("twin")
    cell.check("with the profiled blocks")
    cell.check_arena("the profiled blocks")
    # "merkle stage" and "merkle incremental" have no profiled runs since the
    # sync path came, the hot tip none since the payload paths, the live tip
    # none since "recovery" (their findings stand in PERF.md): no room in the
    # time limit
    engine.profile()
    # after the main paths' fallback count: drill a) counts an arena fault
    # (the injected abort), and b) one more
    log(f"engine drills: {json.dumps(engine.drills())}")
    payload.profile()
    log(f"payload and stateless drills: {json.dumps(payload.drills())}")
    return launches, recorder, hot


def drills(device: str = "cuda", probe_fn=None, seed: int = 49) -> list[dict]:
    """The supervised route's fault drills, after the main paths, on
    bench.py's generator at DRILL_ACCOUNTS / DRILL_SLOTS (the storage
    tries' commit; h: a trie of account leaves). Each arms one fault, checks
    the rung it expects and its counters, holds its roots and branch nodes
    against the numpy twin's, and joins every watchdog thread before its
    launches are read. ``device`` and ``probe_fn`` exist for a rehearsal on
    the CPU (device="cpu", a stand-in probe); the smoke runs them on the
    card with the real probe. Returns one record per drill."""
    import torch

    from reth_tpu_torch.metrics import MetricsRegistry, fused_metrics, pipeline_metrics, trie_metrics
    from reth_tpu_torch.ops import fused_commit as fc
    from reth_tpu_torch.ops import keccak as ok
    from reth_tpu_torch.ops.supervisor import (CircuitBreaker, DeviceSupervisor, FaultInjector,
                                               InjectedPipelineAbort)
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.primitives.nibbles import unpack_nibbles
    from reth_tpu_torch.trie.committer import TrieCommitter
    from reth_tpu_torch.trie.turbo import TurboCommitter

    storage_jobs, account_jobs = build_state(DRILL_ACCOUNTS, DRILL_SLOTS, seed)
    want = TurboCommitter(backend="numpy").commit_hashed_pipelined(storage_jobs, True)
    leaves = [(unpack_nibbles(bytes(key)), val)
              for keys, vals in account_jobs[:16] for key, val in zip(keys, vals)]
    want_h = TrieCommitter(hasher=keccak256_batch_np).commit(leaves)
    wrappers = (ok.keccak256_words_masked, fc.packed_level, fc.branch_level, fc.subtrie_levels)
    records = []

    def supervisor(**kw):
        kw.setdefault("registry", MetricsRegistry())
        if probe_fn is not None:
            kw.setdefault("probe_fn", probe_fn)
        return DeviceSupervisor(**kw)

    def commit(committer, serial=False) -> str:
        """The storage tries' commit, held against the twin; returns the
        backend that hashed it."""
        if serial:
            res = committer.commit_hashed_many(storage_jobs, True)
        else:
            res = committer.commit_hashed_pipelined(storage_jobs, True)
        if [r.root for r in res] != [r.root for r in want] or \
                [r.branch_nodes for r in res] != [r.branch_nodes for r in want]:
            raise AssertionError("a drill's roots or branch nodes differ from the numpy twin's")
        return trie_metrics.last["backend"]

    def drill(name: str, expect: str, run, launch: bool | None = None, fallbacks_: int = 0):
        """Run one drill: ``run`` returns (rung, detail). It must take rung
        ``expect`` with ``fallbacks_`` k-level fallbacks; on the card,
        ``launch`` True / False asks for kernel launches / none."""
        before = sum(w.launches for w in wrappers)
        fallbacks = fused_metrics._fallbacks.value
        t0 = time.perf_counter()
        rung, detail = run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        threads = join_supervised()
        launched = sum(w.launches for w in wrappers) - before
        fell = int(fused_metrics._fallbacks.value - fallbacks)
        if rung != expect or fell != fallbacks_:
            raise AssertionError(f"drill {name} took rung {rung!r} with {fell} k-level fallbacks, "
                                 f"expected {expect!r} with {fallbacks_} ({detail})")
        if device == "cuda" and launch is not None and (launched > 0) != launch:
            raise AssertionError(f"drill {name}: {launched} kernel launches, expected "
                                 f"{'some' if launch else 'none'}")
        rec = {"drill": name, "rung": rung, "wall_s": round(wall, 4), "launches": launched,
               "k_level_fallbacks": fell, "watchdog_threads": threads}
        log(f"drill {name}: rung {rung} as expected, {wall:.3f} s wall, {launched} kernel "
            f"launches, {rec['k_level_fallbacks']} k-level fallbacks, {threads} watchdog threads "
            f"joined; {detail}")
        records.append(rec)

    def expect(cond: bool, what: str) -> None:
        if not cond:
            raise AssertionError(what)

    def guarded_calls(serial=False, k=0) -> int:
        """Guarded calls of a clean supervised commit (a counting injector)."""
        counting = supervisor(injector=FaultInjector())
        commit(TurboCommitter(backend="auto", supervisor=counting, subtrie_levels=k,
                              device=device), serial)
        return counting.injector.dispatch_count

    # a) a wedge mid-commit (half its guarded calls; a pipelined commit's
    # windows vary from run to run): the journal replays on the numpy twin
    for k in (0, 8):
        mid = guarded_calls(k=k) // 2
        sup = supervisor(injector=FaultInjector(wedge_every=mid))
        c = TurboCommitter(backend="auto", supervisor=sup, subtrie_levels=k, device=device)

        def run_a():
            kind = commit(c)
            expect((sup.failovers, sup.injector.wedged, sup.breaker.state) == (1, 1, "closed"),
                   f"a): {sup.snapshot()}")
            last = pipeline_metrics.last
            return kind, (f"1 failover at guarded call {mid}, {last['drained_windows']} of "
                          f"{last['windows']} windows drained onto the twin")

        drill(f"a) wedge mid-commit, auto{' k=8' if k else ''}", "numpy", run_a)

    # b) the wedge at the terminal finish, where the staging engine first
    # meets the card (serial: its guarded calls are deterministic)
    calls = guarded_calls(serial=True)
    sup = supervisor(injector=FaultInjector(wedge_every=calls))
    c = TurboCommitter(backend="auto", supervisor=sup, device=device)
    made = track_engines(c)

    def run_b():
        kind = commit(c, serial=True)
        expect((sup.failovers, sup.injector.wedged) == (1, 1), f"b): {sup.snapshot()}")
        n, nbytes = journal_size(made[-1])
        return kind, (f"wedged at guarded call {calls} of {calls} (finish); the journal "
                      f"replayed {n} entries holding {nbytes} B")

    drill("b) wedge at the terminal finish, auto", "numpy", run_b)

    # c) a real watchdog timeout: every call delayed past the budget
    sup = supervisor(injector=FaultInjector(delay=0.5), dispatch_budget=0.1)
    c = TurboCommitter(backend="auto", supervisor=sup, device=device)

    def run_c():
        kind = commit(c)
        expect((sup.dispatch_timeouts, sup.failovers) == (1, 1), f"c): {sup.snapshot()}")
        return kind, "1 watchdog timeout (delay 0.5 s, budget 0.1 s), 1 failover"

    drill("c) delay above the watchdog budget, auto", "numpy", run_c)

    # d) the k-level engine's own ladder, armed through its env knobs
    for knob, rung, fell in (("RETH_TPU_FAULT_SUBTRIE_WEDGE", "perlevel", 1),
                             ("RETH_TPU_FAULT_SUBTRIE_ABORT", "cpu", 2)):
        sup = supervisor()
        c = TurboCommitter(backend="auto", supervisor=sup, subtrie_levels=8, device=device)

        def run_d():
            os.environ[knob] = "2"
            try:
                fused_metrics.last = None
                kind = commit(c)
            finally:
                del os.environ[knob]
            expect(kind == "device" and sup.failovers == 0, f"d): {kind}, {sup.snapshot()}")
            return fused_metrics.last["mode"], f"{knob}=2, {fused_metrics.last}"

        drill(f"d) {knob}=2, auto k=8", rung, run_d, launch=True, fallbacks_=fell)

    # e) the breaker forced open routes to numpy; after its cooldown the
    # half-open probe (a child) closes it and the device route returns
    sup = supervisor(breaker=CircuitBreaker(failure_threshold=3, reset_timeout=2.0))
    c = TurboCommitter(backend="auto", supervisor=sup, device=device)
    sup.breaker.force_open()

    def run_e1():
        kind = commit(c)
        expect(sup.failovers == 0, f"e): {sup.snapshot()}")
        return kind, "routed on the open breaker, 0 failovers"

    drill("e) breaker forced open, auto", "numpy", run_e1, launch=False)
    time.sleep(2.5)

    def run_e2():
        kind = commit(c)
        expect(sup.breaker.transitions[-3:] == ["open", "half_open", "closed"]
               and sup.last_probe.ok, f"e): {sup.breaker.transitions}, {sup.snapshot()}")
        return kind, f"half-open probe ok in {sup.last_probe.latency:.3f} s, breaker closed"

    drill("e) half-open probe after the cooldown, auto", "device", run_e2, launch=True)

    # f) the pipeline killed at a window boundary
    sup = supervisor(injector=FaultInjector(pipeline_abort=3))
    c = TurboCommitter(backend="auto", supervisor=sup, device=device)

    def run_f():
        try:
            commit(c)
        except InjectedPipelineAbort:
            pass
        else:
            raise AssertionError("f): the pipeline abort did not raise")
        left = [t.name for t in threading.enumerate() if t.name.startswith(("trie-sweep",
                                                                              "trie-hash"))]
        expect(not left and sup.failovers == 0, f"f): threads {left}, {sup.snapshot()}")
        return "abort, then " + commit(c), "window 3 raised, no sweeper thread left"

    drill("f) RETH_TPU_FAULT_PIPELINE_ABORT=3, auto", "abort, then device", run_f)

    # g) every probe failing: startup leaves the breaker open
    sup = supervisor(injector=FaultInjector(probe_fail=-1))

    def run_g():
        ok_ = sup.startup()
        expect(not ok_ and "injected" in sup.last_probe.diag, f"g): {sup.last_probe.diag}")
        return sup.breaker.state, sup.last_probe.diag

    drill("g) probe_fail=-1, startup", "open", run_g)

    # h) the general committer's fused levels (B5) through SupervisedBackend
    sup = supervisor(injector=FaultInjector(wedge_every=6))
    c = TrieCommitter(fused=True, supervisor=sup, device=device)

    def run_h():
        got = c.commit(leaves)
        expect((got.root, got.branch_nodes) == (want_h.root, want_h.branch_nodes),
               "h): the fused committer's root or branch nodes differ from the twin's")
        expect(sup.failovers == 1, f"h): {sup.snapshot()}")
        return c._engine.effective_kind, (f"{len(leaves)} leaves, wedged at guarded call 6, "
                                          f"1 failover, root equal")

    drill("h) wedge_every=6, TrieCommitter(fused=True, supervisor=...)", "numpy", run_h)
    return records


def hot_drills(hot: HotTip | None, device: str = "cuda", which: str = "abcde") -> list[dict]:
    """The hot-state plane's drills, after the main paths: a), b), d) and e)
    on a state of the "sparse arena" size (bench.py's sparse generator,
    SPARSE_TRIES x SPARSE_SLOTS, seed 7) and its CPU twin, one seeded block
    per commit on both, every root held against the twin's; c) on one more
    block of the hot tip's cached lineage. Each checks the rungs it expects
    ("full" and "delta": the arena's epochs; "classic": the finish without
    the arena):

    a) a launch that raises inside a delta epoch: one fault, one eviction,
       the same commit's root from the classic finish on the card (kernel 1),
       then a full epoch, then a delta one;
    b) RETH_TPU_FAULT_HOTSTATE_EVICT_STORM=1: every epoch full;
    c) RETH_TPU_FAULT_HOTSTATE_POISON=3: every poisoned serve counted in
       poison_caught and none revealed (each root still the twin's);
    d) max_rows shrunk (after the first epoch, to 1.5 times its rows) so
       that begin_epoch evicts: a delta epoch, then a full one after the
       eviction, no leaked row;
    e) a second thread holds the arena: the classic finish, contended 1.

    ``which`` names the drills to run: the smoke runs c) in its own process
    (it needs the hot tip, ``hot``) and the others in the drills' child."""
    import torch

    from reth_tpu_torch.ops import fused_commit as fc
    from reth_tpu_torch.ops import keccak as ok
    from reth_tpu_torch.ops.fused_commit import DigestArena
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.trie.hot_cache import HotStateFaultInjector
    from reth_tpu_torch.trie.sparse import ParallelSparseCommitter

    wrappers = (ok.keccak256_words_masked, fc.packed_level, fc.branch_level, fc.subtrie_levels)
    if set(which) - {"c"}:
        t0 = time.perf_counter()
        card, owners, keys = sparse_base(SPARSE_TRIES, SPARSE_SLOTS, seed=7)
        twin = sparse_base(SPARSE_TRIES, SPARSE_SLOTS, seed=7)[0]
        twin_c = ParallelSparseCommitter(device="cpu")
        if card.root(committer=ParallelSparseCommitter(subtrie_levels=8, device=device)) != \
                twin.root(keccak256_batch_np, committer=twin_c):
            raise AssertionError("hot drills: the baseline root differs from the CPU twin's")
        log(f"hot drills: state and twin generated and hashed in "
            f"{time.perf_counter() - t0:.1f} s")
    block = [0]
    records = []

    def commit(c) -> tuple[str, dict]:
        """One more seeded block on both states, the card's committed through
        ``c``; returns its rung and the launches by kernel."""
        for st in (card, twin):
            sparse_block(st, owners, keys, SPARSE_DIRTY, block[0], seed=7)
        block[0] += 1
        before = [w.launches for w in wrappers]
        root = card.root(committer=c)
        if device == "cuda":
            torch.cuda.synchronize()
        launched = {k: w.launches - b for k, w, b in zip(KERNELS, wrappers, before) if
                    w.launches > b}
        if root != twin.root(keccak256_batch_np, committer=twin_c):
            raise AssertionError(f"hot drills: block {block[0] - 1}'s root differs from the "
                                 f"CPU twin's")
        fresh = c.last.get("arena_fresh")
        return ("classic" if fresh is None else "full" if fresh else "delta"), launched

    def drill(name: str, expect: list, run) -> None:
        if name[0] not in which:
            return
        t1 = time.perf_counter()
        rungs, detail = run()
        wall = time.perf_counter() - t1
        if rungs != expect:
            raise AssertionError(f"hot drill {name} took rungs {rungs}, expected {expect} "
                                 f"({detail})")
        records.append({"drill": name, "rungs": rungs, "wall_s": round(wall, 4)})
        log(f"hot drill {name}: rungs {rungs} as expected, {wall:.3f} s wall; {detail}")

    def check(cond: bool, what: str) -> None:
        if not cond:
            raise AssertionError(what)

    # a) a failed launch inside a delta epoch
    arena = DigestArena()
    c = ParallelSparseCommitter(arena=arena, device=device)

    def run_a():
        rungs = [commit(c)[0], commit(c)[0]]
        real = fc.subtrie_levels

        def failing(*_a):
            raise RuntimeError("injected launch fault (hot drill a)")

        fc.subtrie_levels = failing
        try:
            rung, launched = commit(c)
        finally:
            fc.subtrie_levels = real
        snap = arena.snapshot()
        check((snap["faults"], snap["evictions"], arena.engine) == (1, 1, None)
              and (device != "cuda" or launched.get("keccak256_absorb", 0) > 0),
              f"a): {snap}, {launched}")
        rungs += [rung, commit(c)[0], commit(c)[0]]
        check(arena.snapshot()["faults"] == 1 and arena.leaked_rows() == 0, f"a): {snap}")
        return rungs, f"the faulted commit on the classic finish launched {launched}; {snap}"

    drill("a) a launch fault in a delta epoch", ["full", "delta", "classic", "full", "delta"],
          run_a)

    # b) the evict storm
    os.environ["RETH_TPU_FAULT_HOTSTATE_EVICT_STORM"] = "1"
    try:
        arena = DigestArena()
        c = ParallelSparseCommitter(arena=arena, device=device)
    finally:
        del os.environ["RETH_TPU_FAULT_HOTSTATE_EVICT_STORM"]

    def run_b():
        rungs = [commit(c)[0] for _ in range(3)]
        snap = arena.snapshot()
        check((snap["delta_epochs"], snap["full_epochs"], snap["evictions"], snap["faults"],
               snap["leaked_rows"]) == (0, 3, 3, 0, 0), f"b): {snap}")
        return rungs, json.dumps(snap)

    drill("b) RETH_TPU_FAULT_HOTSTATE_EVICT_STORM=1", ["full"] * 3, run_b)

    # c) poisoned cache serves on the hot tip
    def run_c():
        os.environ["RETH_TPU_FAULT_HOTSTATE_POISON"] = "3"
        try:
            hot.cache.injector = HotStateFaultInjector.from_env()
        finally:
            del os.environ["RETH_TPU_FAULT_HOTSTATE_POISON"]
        caught0 = hot.cache.poison_caught
        try:
            recs = [hot.block()]  # one block (two before the time limit's cut)
        finally:
            inj, hot.cache.injector = hot.cache.injector, None
        caught = hot.cache.poison_caught - caught0
        check(caught == inj.poisons > 0, f"c): {caught} caught of {inj.poisons} poisoned serves")
        return (["caught"],
                f"{inj.poisons} poisoned serves of {inj.lookups} lookups that found an entry, "
                f"all caught; blocks "
                + "; ".join(f"{r['block']}: {r['proof_fetches']} proof fetches, "
                            f"{r['cache_hits']} hits" for r in recs))

    drill("c) RETH_TPU_FAULT_HOTSTATE_POISON=3, hot tip", ["caught"], run_c)

    # d) a row budget that begin_epoch evicts at: set after the first epoch
    # to 1.5 times its rows, so the second epoch fits and the third evicts
    arena = DigestArena()
    c = ParallelSparseCommitter(arena=arena, device=device)

    def run_d():
        rungs = [commit(c)[0]]
        arena.max_rows = arena.next_slot * 3 // 2  # the constructor floors at 1024
        rungs += [commit(c)[0] for _ in range(2)]
        snap = arena.snapshot()
        check(snap["evictions"] == 1 and snap["leaked_rows"] == 0 and not snap["faults"],
              f"d): {snap}")
        return rungs, f"max_rows {arena.max_rows}; {json.dumps(snap)}"

    drill("d) max_rows at 1.5 epochs' rows", ["full", "delta", "full"], run_d)

    # e) a second finish holds the arena
    arena = DigestArena()
    c = ParallelSparseCommitter(arena=arena, device=device)

    def run_e():
        held, done = threading.Event(), threading.Event()

        def holder():
            if arena.try_acquire():
                held.set()
                done.wait(120)
                arena.release()

        t = threading.Thread(target=holder, name="arena-holder")
        t.start()
        check(held.wait(60), "e): the holder did not take the arena")
        try:
            rung, launched = commit(c)
        finally:
            done.set()
            t.join()
        snap = arena.snapshot()
        check(snap["contended"] == 1 and snap["epoch"] == 0, f"e): {snap}")
        return [rung, commit(c)[0]], f"contended {snap['contended']}, launched {launched}"

    drill("e) the arena held by a second thread", ["classic", "full"], run_e)
    return records


def drills_child(out_path: str) -> int:
    """``--drills OUT``: the supervised route's drills, the hot-state
    drills but c) and the control plane's drills, in a child process of
    their own that the smoke starts before the MerkleStage cell, so that
    they run beside that cell and the live tip (their faults are armed in
    this process's environment only). Writes the three lists of records to
    ``out_path`` as JSON."""
    from reth_tpu_torch.device import resolve

    resolve("cuda")
    out = {"drills": drills(), "hot": hot_drills(None, which="abde"),
           "control": control_drills()}
    join_supervised()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def profile_path(label: str, drive, prepare=None, focus=()) -> None:
    """Two more runs of a main path, after its counters were read (so
    their launches are not counted): one under torch.profiler
    (``device_profile``), one under cProfile (``host_profile``, with the
    cumulative time of the functions named in ``focus``). ``prepare``, when
    given, runs before each, outside both."""
    if prepare is not None:
        prepare()
    device_profile(label, drive)
    if prepare is not None:
        prepare()
    host_profile(label, drive, focus=focus)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--accounts", type=int, default=1_000_000,
                    help="the MerkleStage cell's accounts")
    ap.add_argument("--slots", type=int, default=400_000, help="the MerkleStage cell's slots")
    ap.add_argument("--rebuild-accounts", type=int, default=250_000,
                    help="the rebuild paths' accounts (cut from 1,000,000)")
    ap.add_argument("--rebuild-slots", type=int, default=100_000,
                    help="the rebuild paths' slots (cut from 400,000)")
    ap.add_argument("--state-accounts", type=int, default=50_000,
                    help="the state_root paths' accounts (cut from 100,000)")
    ap.add_argument("--state-slots", type=int, default=20_000,
                    help="the state_root paths' slots (cut from 40,000)")
    ap.add_argument("--sync-accounts", type=int, default=250_000,
                    help="the sync path's genesis accounts (cut from 1,000,000)")
    ap.add_argument("--sync-slots", type=int, default=100_000,
                    help="the sync path's genesis slots (cut from 400,000)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--warmup-child", metavar="DIR", default=None,
                    help="internal: one warm-up run on the compile cache under DIR")
    ap.add_argument("--merkle-twin", metavar="OUT", default=None,
                    help="internal: the MerkleStage cell's CPU twin, its result to OUT")
    ap.add_argument("--sync-chain", metavar="OUT", default=None,
                    help="internal: seal the sync path's chain on the host, to OUT")
    ap.add_argument("--drills", metavar="OUT", default=None,
                    help="internal: the drills but the hot tip's, their records to OUT")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.warmup_child is not None:
        return warmup_child(args.warmup_child)
    sys.path.insert(0, HERE)
    if args.merkle_twin is not None:
        return merkle_twin(args.accounts, args.slots, args.seed, args.merkle_twin)
    if args.sync_chain is not None:
        return sync_chain(args.sync_accounts, args.sync_slots, args.sync_chain)
    if args.drills is not None:
        return drills_child(args.drills)
    from reth_tpu_torch.device import resolve
    from reth_tpu_torch.ops import _build
    from reth_tpu_torch.trie import turbo

    t_start = time.perf_counter()
    resolve("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    srcs = [_build.CUDA_SRC_DIR / n for n in _build.KERNEL_SOURCES] + [
        turbo._SRC, _build.PKG_DIR / "csrc" / "secp256k1.cpp",
        _build.PKG_DIR / "csrc" / "evmexec.cpp", _build.PKG_DIR / "csrc" / "pagedkv.cpp"]
    t0 = time.perf_counter()
    paths = _build.build(srcs)
    log(f"built {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    twin = ChildProcess("merkle twin", "--merkle-twin",
                        ["--accounts", str(args.accounts), "--slots", str(args.slots),
                         "--seed", str(args.seed + 3)])
    chain = ChildProcess("sync chain", "--sync-chain",
                         ["--sync-accounts", str(args.sync_accounts),
                          "--sync-slots", str(args.sync_slots)])
    kids = {"twin": twin, "chain": chain}  # slice_phase adds the drills' child
    try:
        return smoke(args, t_start, srcs, paths, kids)
    finally:
        for kid in kids.values():
            kid.stop()


def smoke(args, t_start: float, srcs, paths, kids: dict) -> int:
    """Everything after the build: the checks, the main paths, the timings
    and the drills (``kids["twin"]``: the MerkleStage cell's twin, running;
    ``kids["chain"]``: the "sync" path's chain, being sealed; slice_phase
    starts ``kids["drills"]``)."""
    import torch

    libs = {s.name: str(p) for s, p in zip(srcs, paths)}
    ptxas = {}
    for s, p in zip(srcs[:2], paths[:2]):
        log_path = p.with_name(p.name + ".log")
        ptxas.update(check_ptxas(s.name, log_path.read_text() if log_path.exists() else ""))
    check_coherent_digest_loads(libs["fused_level.cu"], "subtrie_levels_kernel")
    bound = make_bound(libs)
    # the warm-up's children run beside the paths below (their launches are
    # their own processes'); joined before the kernel timings
    warm = Background("warm-up", warmup_phase)
    try:
        if args.accounts != 1_000_000 or args.slots != 400_000:
            log(f"size cut: the MerkleStage cell at {args.accounts} accounts / {args.slots} "
                f"slots (the slice's size is 1,000,000 / 400,000)")
        log(f"the rebuild paths at {args.rebuild_accounts} accounts / {args.rebuild_slots} "
            f"slots (cut from 1,000,000 / 400,000, which the MerkleStage cell keeps)")
        t0 = time.perf_counter()
        storage_jobs, account_jobs = build_state(args.rebuild_accounts, args.rebuild_slots,
                                                 args.seed)
        log(f"state generated in {time.perf_counter() - t0:.1f} s")

        sup = supervisor_startup()
        probe, check1 = kernel_checks(args, account_jobs, bound)
        launches, recorder, hot = slice_phase(args, storage_jobs, account_jobs, sup, kids)
    finally:
        warm.thread.join()  # its child processes end before the smoke does
    warm.result()
    # the drills' child ends before the kernel timings, which it would share
    # the card with
    res = kids["drills"].result()
    log(f"drills: {json.dumps(res['drills'])}")
    log(f"hot drills (the drills' child): {json.dumps(res['hot'])}")
    log(f"control drills: {json.dumps(res['control'])}")
    rows = kernel_timings(recorder, launches, bound, np.random.default_rng(args.seed + 2))
    rows.append(exchange_row(recorder, launches, np.random.default_rng(args.seed + 4),
                             {n: r for n, r in ptxas.items()
                              if n.startswith("exchange_slots_kernel<")}))
    for r in rows:
        if r["name"] == "subtrie_levels":
            r.update(probe)
        elif r["name"] == "keccak256_absorb":
            r.update(check1)
    log(f"hot drills: {json.dumps(hot_drills(hot, which='c'))}")
    join_supervised()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
