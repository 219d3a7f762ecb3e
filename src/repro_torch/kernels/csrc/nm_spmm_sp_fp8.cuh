// nm_spmm_fp8 on Hopper's sparse tensor cores: the e4m3 single at n in
// {1, 2}, every out_kind (bf16, fp32, the raw accumulator, and the
// requantizing flush of nm_spmm_fp8_requant), and with the activation-
// sparsity skip (MASKED) the same single as nm_spmm_masked_fp8; in its s8
// form (the element class S8: the same bytes, an int32 accumulator)
// nm_spmm_int8 and nm_spmm_int8_requant at n in {1, 2}, tile_gemm_int8 and
// tile_gemm_int8_requant (N = 4), K8 int8 (nm_spmm_gather_bk_int8 and
// _requant, G = n in {1, 2}), in DUAL form the compressed gate-up
// nm_spmm_dual_int8 and _requant (n in {1, 2}), the dense gate-up
// tile_gemm_dual_int8 and _requant (N = 4) and K9 int8
// (nm_spmm_gather_dual_bk_int8 and _requant, G = n in {1, 2}), and with the
// K-major X K11 int8 (nm_spmm_gather_int8), and with MASKED the masked
// int8 singles nm_spmm_masked_int8 (n in {1, 2}), tile_gemm_masked_int8
// (N = 4) and the masked int8 gather nm_spmm_gather_bk_masked_int8 (G = n
// in {1, 2}); in DUAL
// form (two weights, two accumulators, one silu(g) * u flush) the
// compressed gate-up nm_spmm_dual_fp8 and its requantizing form; and the
// same streaming body
// over a dense e4m3 weight (N = 4): tile_gemm_fp8's few-row body, with
// MASKED tile_gemm_masked_fp8's, in DUAL
// form the dense gate-up tile_gemm_dual_fp8's (and _requant's) and, with
// the X side gathered (G = n in {1, 2}), the fp8 lane-aligned gather K8's
// (nm_spmm_gather_bk_fp8 and _requant) few-row body over its dense values,
// with MASKED the masked fp8 gather nm_spmm_gather_bk_masked_fp8's, and in
// DUAL form K9 fp8's (nm_spmm_gather_dual_bk_fp8 and _requant);
// with the X side gathered from K-major x_t (KM), K11 fp8's
// (nm_spmm_gather_fp8).  Included by gemm_fp8.cu, whose vg_nm_spmm_fp8,
// vg_nm_spmm_masked_fp8, vg_tile_gemm_fp8, vg_tile_gemm_masked_fp8,
// vg_nm_spmm_dual_fp8, vg_tile_gemm_dual_fp8, vg_nm_spmm_gather_bk_fp8,
// vg_nm_spmm_gather_bk_masked_fp8, vg_nm_spmm_gather_dual_bk_fp8 and
// vg_nm_spmm_gather_fp8 launch it with their flush where
// nm_spmm/kernel.py::fp8_plan (for both singles), tile_gemm/kernel.py::
// fp8_plan, ::masked_fp8_plan, nm_spmm/kernel.py::fp8_dual_plan,
// tile_gemm/kernel.py::fp8_dual_plan, nm_spmm_gather/kernel.py::fp8_plan,
// ::masked_fp8_plan, ::fp8_dual_plan and ::kmajor_fp8_plan pick it, and by
// gemm_int8.cu, whose vg_nm_spmm_int8, vg_tile_gemm_int8,
// vg_nm_spmm_gather_bk_int8, vg_nm_spmm_dual_int8, vg_tile_gemm_dual_int8,
// vg_nm_spmm_gather_dual_bk_int8, vg_nm_spmm_gather_int8,
// vg_nm_spmm_masked_int8, vg_tile_gemm_masked_int8 and
// vg_nm_spmm_gather_bk_masked_int8 launch the s8 form where
// nm_spmm/kernel.py::int8_plan (for both compressed singles),
// tile_gemm/kernel.py::int8_plan, ::masked_int8_plan,
// nm_spmm_gather/kernel.py::int8_plan, ::masked_int8_plan,
// nm_spmm/kernel.py::int8_dual_plan, tile_gemm/kernel.py::int8_dual_plan,
// nm_spmm_gather/kernel.py::int8_dual_plan and ::kmajor_int8_plan pick it.
// One body serves both 8-bit classes: the header is not copied per class.
// n = 4 of the compressed and gathered kernels and wider launches keep
// gemm_fp8.cu's / gemm_int8.cu's shared bodies, and the many-row bodies of
// tile_gemm_fp8 (of K8, after gemm_fp8.cu's gather pass) and of
// tile_gemm_dual_fp8 are tile_gemm_sm90_fp8.cuh's.
//
// Replaces (JAX package, Pallas on the TPU):
//   nm_spmm_fp8    repro/kernels/nm_spmm/kernel.py::nm_spmm_fp8
//                  (_nm_spmm_quantized, _spmm_q_raw_kernel, _spmm_kernel), n in {1, 2}
//   tile_gemm_fp8  repro/kernels/tile_gemm/kernel.py::tile_gemm_fp8
//                  (_tile_gemm_quantized, _gemm_q_raw_kernel, _gemm_kernel), below
//                  the many-row body's rows (tile_gemm/kernel.py::fp8_plan)
//   nm_spmm_dual_fp8  repro/kernels/nm_spmm/kernel.py::nm_spmm_dual, fp8 branch
//                  (_spmm_dual_kernel), n in {1, 2}, with the requant:float8_e4m3fn
//                  flush of repro/kernels/epilogue.py::flush_tile in its _requant form
//   nm_spmm_gather_bk_fp8  repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_bk,
//                  fp8 (_gather_bk_kernel), n in {1, 2}, below the many-row rows
//                  (nm_spmm_gather/kernel.py::fp8_plan)
//   tile_gemm_dual_fp8  repro/kernels/tile_gemm/kernel.py::tile_gemm_dual, fp8 branch
//                  (_gemm_dual_kernel), with the requant:float8_e4m3fn flush of
//                  repro/kernels/epilogue.py::flush_tile in its _requant form, where
//                  tile_gemm/kernel.py::fp8_dual_plan streams
//   nm_spmm_gather_fp8  repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_fp8
//                  (_nm_spmm_gather_quantized, _gather_q_kernel, _gather_q_raw_kernel),
//                  n in {1, 2}
//   nm_spmm_masked_fp8  repro/kernels/nm_spmm/kernel.py::nm_spmm_masked
//                  (_spmm_masked_kernel), scaled-quantized fp8, n in {1, 2}, where
//                  nm_spmm/kernel.py::fp8_plan streams
//   nm_spmm_gather_dual_bk_fp8  repro/kernels/nm_spmm_gather/kernel.py::
//                  nm_spmm_gather_dual_bk, fp8 branch (_gather_dual_kernel), n in
//                  {1, 2}, with the requant:float8_e4m3fn flush of
//                  repro/kernels/epilogue.py::flush_tile in its _requant form, where
//                  nm_spmm_gather/kernel.py::fp8_dual_plan streams
//   tile_gemm_masked_fp8  repro/kernels/tile_gemm/kernel.py::tile_gemm_masked
//                  (_gemm_masked_kernel), scaled-quantized fp8, where
//                  tile_gemm/kernel.py::masked_fp8_plan streams
//   nm_spmm_int8   repro/kernels/nm_spmm/kernel.py::nm_spmm_int8
//                  (_nm_spmm_quantized, _spmm_q_raw_kernel, _spmm_kernel), n in
//                  {1, 2}, with the requant:int8 flush in its _requant form, where
//                  nm_spmm/kernel.py::int8_plan streams
//   tile_gemm_int8 repro/kernels/tile_gemm/kernel.py::tile_gemm_int8
//                  (_tile_gemm_quantized, _gemm_q_raw_kernel, _gemm_kernel), with the
//                  requant:int8 flush in its _requant form, where
//                  tile_gemm/kernel.py::int8_plan streams
//   nm_spmm_gather_bk_int8  repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_bk,
//                  quantized (_gather_bk_kernel), n in {1, 2}, with the requant:int8
//                  flush in its _requant form, where nm_spmm_gather/kernel.py::
//                  int8_plan streams
//   nm_spmm_dual_int8  repro/kernels/nm_spmm/kernel.py::nm_spmm_dual, int8 branch
//                  (_spmm_dual_kernel), n in {1, 2}, with the requant:int8 flush in
//                  its _requant form, where nm_spmm/kernel.py::int8_dual_plan streams
//   nm_spmm_gather_int8  repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_int8
//                  (_nm_spmm_gather_quantized, _gather_q_kernel, _gather_q_raw_kernel),
//                  n in {1, 2}, where nm_spmm_gather/kernel.py::kmajor_int8_plan streams
//   tile_gemm_dual_int8  repro/kernels/tile_gemm/kernel.py::tile_gemm_dual, int8 branch
//                  (_gemm_dual_kernel), with the requant:int8 flush in its _requant
//                  form, where tile_gemm/kernel.py::int8_dual_plan streams
//   nm_spmm_gather_dual_bk_int8  repro/kernels/nm_spmm_gather/kernel.py::
//                  nm_spmm_gather_dual_bk, int8 (_gather_dual_kernel), n in {1, 2}, with
//                  the requant:int8 flush in its _requant form, where
//                  nm_spmm_gather/kernel.py::int8_dual_plan streams
//   nm_spmm_masked_int8  repro/kernels/nm_spmm/kernel.py::nm_spmm_masked
//                  (_spmm_masked_kernel), scaled-quantized int8, n in {1, 2}, where
//                  nm_spmm/kernel.py::int8_plan streams
//   tile_gemm_masked_int8  repro/kernels/tile_gemm/kernel.py::tile_gemm_masked
//                  (_gemm_masked_kernel), scaled-quantized int8, where
//                  tile_gemm/kernel.py::masked_int8_plan streams
//   nm_spmm_gather_bk_masked_fp8, nm_spmm_gather_bk_masked_int8
//                  repro/kernels/nm_spmm_gather/kernel.py::nm_spmm_gather_bk_masked
//                  (_gather_bk_masked_kernel), scaled-quantized fp8 / int8, n in {1, 2},
//                  where nm_spmm_gather/kernel.py::masked_fp8_plan / ::masked_int8_plan
//                  stream
//
// Y (B, O) = flush(Xq (B, K) @ dec(values (K*n/4, O), meta_packed (K*n/16,
// O))), e4m3 x e4m3 into fp32.  The compressed tile goes to the tensor core
// as it is: mma.sp.sync.aligned.m16n8k64.row.col.f32.e4m3.e4m3.f32 (sm_89
// and later) takes A 2:4 sparse along K, 16 rows x 64 K held as 32 kept
// bytes a row with a 2-bit index each.  The weight is A (16 output
// channels), X is B (64 K x 8 batch rows), so a decode batch of 8 fills
// the instruction's N = 8.  The dense weight (N = 4) is A of
// mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 the same way: two
// per 64-deep step, the same B registers (K bytes 0-31, then 32-63).
//
// Operand layout (pinned on the card by kernels/mma_sp_probe.py).  A
// register r of lane 4g + t: channel g + 8 (r & 1), kept bytes 4t .. 4t + 3
// (+ 16 for r >= 2); B register r: K bytes 4t + 16r .. + 3 of batch row g,
// which ldmatrix (b16, not transposed) reads from the X tile as it lands.
// The metadata word differs from the bf16 form's: lane 4g + t holds the
// nibbles of K groups 8 (t >> 1) .. + 7 of ONE channel, g + 8 (t & 1).  At
// 2:4 that is four consecutive meta_packed bytes of that channel (two
// groups a byte, low nibble first), four byte loads; at 1:4 two bytes,
// spread to 2:4 pairs (expand_1of4).
//
// The transpose.  values is (K_c, O) with O contiguous, and the A operand
// wants each channel's kept bytes consecutive along K; sm_90 has no 8-bit
// ldmatrix transpose, and a second, transposed copy of the weight would
// double its memory.  So each warp transposes the part of the landed stage
// it multiplies (its 16 channels x 32 kept bytes) into a private [channel]
// [byte] tile with gemm_fp8.cu's __byte_perm transpose (gather_byte:
// each lane turns a 4 x 4 byte block, four 32-bit loads, into four words)
// and reads A from it with ldmatrix.  1:4 runs as 2:4 (as in nm_spmm_sp.cuh):
// the transpose writes each group's kept byte into the slot of its index
// and a +0 into the other, the pair (0, 1) for index 0, else (0, index);
// the 1:4 bytes in device memory stay 1:4's.  The dense weight (N = 4)
// needs no private tile: ldmatrix .trans on b16 hands each lane a channel
// pair at two K rows, so with the eight row addresses of each matrix chosen
// as K rows {4i, 4i + 1} (and {4i + 2, 4i + 3} for its partner) one
// __byte_perm makes a lane's A register of channel 2g at K bytes 4t .. 4t +
// 3, another channel 2g + 1's: two ldmatrix .x4 .trans and eight
// __byte_perm a warp tile and weight a step, in the mma's own K order, the
// channels landing permuted (A row g is channel 2g), which the partial
// store maps back.  The dense values tile is stored unpadded with its
// 16-byte chunks swizzled by the K row's 4-row block (vslot), so the eight
// rows of each matrix are read in one pass.  On an H100 it was faster than
// the per-warp transpose it replaced at every timed shape of the dense
// single, the dense dual, K8's and K11's streams, with the same bits.
//
// Numerics: the fp8 class's (gemm_fp8.cu).  Every 64-deep instruction
// starts from zero and is added into a separate fp32 register accumulator
// (__fadd_rn), so the tensor cores never carry a running sum past 64
// products (the dense weight: both k32 instructions of a step into one
// partial from zero, then the add).  The K loop is split over the `split` blocks of a cluster
// (nm_spmm/kernel.py::split_k) and the partials summed in rank order
// (splitk.cuh); the flush then runs once from the summed fp32 accumulator
// in the JAX order (the caller's Flush: acc * xs[row] * ws[col] with
// __fmul_rn, + bias, act, then the store of its out_kind).  The same inputs
// give the same bits on every launch.
//
// What bounds it on an H100.  At decode every kept byte is read once for 2
// operations per batch row: the bytes over 3.35 TB/s (w_out at K = 8192, O
// = 2048, 2:4: values 8.4 MB + meta 2.1 MB, about 3.1 us).  What the
// design does about it: the ring keeps STAGES - 1 steps of values, meta
// and X in flight per block (6 stages at decode), the split puts two or
// three blocks on every SM, and the sparse instruction halves the
// tensor-core work the first body spent expanding and multiplying zeros.  At 64-row
// tiles it is slower than the shared body once that body has 64 or more
// blocks (256 rows, gemma3-1b's w_in at 64 rows, on an H100), for reasons
// not found yet (a 64-deep stage costs ~1-3 us there): fp8_plan keeps those
// launches on the shared body.
//
// The gate-up dual (DUAL; nm_spmm_dual_fp8 and _requant).  A stage carries
// the step's values and meta tiles of both weights beside ONE X tile; each
// warp transposes its 16-channel part of each weight into its own private
// tile (two a warp), reads the B registers once and issues one mma.sp per
// weight into two accumulator sets.  The split's inbox holds both
// partials, summed in rank order plane by plane (splitk::finish_planes)
// before one flush in gemm_fp8.cu's order (DualFlush): t_g = acc_g * xs *
// wsg, t_u = acc_u * xs * wsu (__fmul_rn), silu(t_g) * t_u, then bf16,
// fp32 or the e4m3 codes against *rq.  At internlm2-1.8b's gate-up (2048,
// 8192) at decode that is 128 tiles split 2 over a cluster, two blocks an
// SM (~58 KB each at 16 rows, ~88 KB at 64).  Bound: both weights' kept
// bytes and meta + X once, over 3.35 TB/s.
//
// The masked single (MASKED, nm_spmm_masked_fp8), as nm_spmm_sp.cuh's
// bf16 one.  The block folds its row block's kmask row into kmask.cuh's
// bitmask before the ring, keeps the span splitk::span gives the unmasked
// kernel and walks only its live steps: a dead step is neither loaded,
// prefetched, transposed nor multiplied.  A dead tile of the masked X
// would add an exact +0 partial, so the partition and the order of the
// sums are nm_spmm_fp8's: bitwise nm_spmm_fp8 (and nm_spmm_fp8_requant's
// codes) on the same masked X at the same split.  A rank with no live step
// in its span walks none and still stores its zero partial into the
// owners' inboxes and meets the cluster barrier.  A row block with no live
// step at all (about 0.6 of qwen3-moe's spgemm w_out launches at decode)
// skips the ring, the partial store and the split's exchange
// (splitk::finish_zero): every rank folds the same whole map row, so all
// of them see it, none writes into a peer's inbox and none waits at the
// barrier; each flushes the Flush of a zero sum (bias and activation of
// zero, or their codes) over the slice finish_planes makes it the owner
// of, the same bits as the exchange of zero partials.  Every MASKED form
// of this header takes that end.  Bound: the live steps' kept bytes, meta
// and X bytes.
//
// Row tiles.  Past decode rows the plans (fp8_dual_plan, the gather
// fp8_plan) keep 16-row tiles over several row tiles (up to 2-3 blocks an
// SM) where the 64-row tile lost to them on an H100: a 64-deep step of the
// 64-row tile costs about as much as four of the 16-row one, for reasons not
// found yet (no profiler sees inside a kernel here).
//
// The dense gate-up dual (DUAL at N = 4; tile_gemm_dual_fp8 and _requant).
// Both dense weights' values tiles beside one X tile a stage, each warp's A
// registers of both read from them, two accumulator sets, the split's
// planes summed in rank order and flushed by DualFlush, as the compressed
// dual.  A 16-row block is ~45 KB (a 4-deep ring: 6 stages timed the same
// at decode and slower at three blocks an SM), three blocks an SM; at
// internlm2-1.8b's gate-up (2048, 8192) at decode, 128 tiles split 2.
// Bound: both weights' bytes and X once, over 3.35 TB/s (10.1 us there).
//
// The K-major X (KM, K11 fp8: x_t (K_eff, B) -> Y_t (O, B)).  The block's
// indices for its split span land in shared memory once, before the ring;
// each stage then loads, with cp.async, the step's 64 selected x_t rows,
// row (c / G) * 4 + idx[c] for compressed row c, BM batch bytes from column
// m0 (an index outside [0, 4), or columns at or past B, land as zeros),
// into 16-byte slots swizzled by the row's 4-row block (kslot): a quarter
// of the span K8's stream lands at 1:4.  A transpose pass turns the landed
// [64][BM] tile into the [BM][64] X tile the B operand's ldmatrix reads
// (4 x 4 byte blocks with gather_byte, a warp's 32 loads on 32 banks, one
// block barrier); the products are the dense stream's.  The flush is K11's
// order, acc * ws * xs (SingleFlushT<true, true>), stored at col * B + row
// with the split's finish in column-major order, so that consecutive
// threads store consecutive batch rows of a channel.  Bound: the kept x_t
// rows, values, index and output bytes over 3.35 TB/s.
//
// The gathered X (G = n, K8 fp8).  values (K_c, O) is a dense e4m3 weight,
// so the body is the N = 4 stream over it with only the X side changed: a
// stage carries the step's 64 int32 indices and the span of 256 / n X bytes
// a row that its compressed columns read (cp.async, rows at or past B
// zero-filled); after the stage lands, a select pass builds the compact
// [rows][64 B] X tile that ldmatrix reads for the m16n8k32 B operand
// (column c of the step is span byte (c / n) * 4 + idx[c], picked with
// __byte_perm, select16; an index outside [0, 4) selects +0, as the TPU
// kernel's compare-and-select does), one more block barrier, then the same
// products.  Its flush is the gather kernels' order, acc * ws * xs
// (SingleFlushT<true>).  Bound: values + index + X bytes over 3.35 TB/s.
//
// The gathered dual (G = n with DUAL, K9 fp8).  A stage carries both dense
// e4m3 values tiles, both int32 index slices and ONE span of 256 / G X
// bytes a row; the select pass reads each unit's span words once and
// selects them twice (select16 through each weight's indices) into two
// compact tiles, one more block barrier, then the dense dual's products:
// each warp's B registers of both tiles, each weight's A registers from its
// own landed values tile, two accumulator sets, the split's planes summed
// in rank order, and the flush DualFlushT<true>: the gather kernels' ws-first
// order on each accumulator, t = acc * ws * xs, then silu(t_g) * t_u and
// bf16, fp32 or the e4m3 codes.  16-row tiles only (fp8_dual_plan's), a
// 4-deep ring: ~54 KB a block at 2:4, ~62 KB at 1:4, three blocks an SM.
// Bound: both weights' bytes and indices + X once, over 3.35 TB/s.
//
// The masked dense single (MASKED at N = 4, tile_gemm_masked_fp8).  The
// walk of the masked compressed single over the dense stream: the row
// block's bitmask, the span tile_gemm_fp8's split gives the rank, only its
// live steps loaded and multiplied; a dead step would add an exact +0
// partial, so bitwise tile_gemm_fp8 (and tile_gemm_fp8_requant's codes) on
// the same masked X at the same tile and split.  Bound: the live steps'
// weight rows and X bytes.
//
// The masked gather (MASKED with G = n, nm_spmm_gather_bk_masked_fp8).  A
// kmask column is one step of 64 compressed rows, the stage's span of 256 /
// G X bytes a row (the maps are block_maps' at 256 / n columns): a dead
// step's index slice and X span are neither loaded nor selected, the stage,
// the select pass and the prefetch take the walked step at(i), and the
// block keeps the span K8 fp8's split gives it.  A dead step would add an
// exact +0 partial, so bitwise K8 fp8 (and its requantized codes) on the
// same masked X at the same split: where the plan's tile is K8 fp8's, and
// at 64-row tiles where K8 fp8 takes 16-row ones, since the split's spans
// and the per-step order of each output's sums are the tile's rows'
// either way.  Bound: the live steps' values, index and X span bytes.
//
// The s8 form (element class S8): the singles nm_spmm_int8 and _requant (n
// in {1, 2}, X contiguous), tile_gemm_int8 and _requant (the dense stream, N
// = 4, X contiguous), K8 int8, nm_spmm_gather_bk_int8 and _requant (the
// dense stream with the gathered X, G = n in {1, 2}) and K11 int8,
// nm_spmm_gather_int8 (the dense stream with the K-major X, G = n in {1,
// 2}); and the three gate-up duals, each with its _requant: the compressed
// nm_spmm_dual_int8 (DUAL at n in {1, 2}), the dense tile_gemm_dual_int8
// (DUAL at N = 4) and the gathered K9 int8 nm_spmm_gather_dual_bk_int8
// (DUAL with G = n in {1, 2}, one span selected twice): two int32
// accumulator sets, both planes through the split; and with MASKED the
// masked int8 singles nm_spmm_masked_int8 (n in {1, 2}) and
// tile_gemm_masked_int8 (N = 4), and the masked int8 gather
// nm_spmm_gather_bk_masked_int8 (G = n in {1, 2}, SingleFlushI8<true>): the
// e4m3 masked walk unchanged (block_live and SpanWalk do not look at the
// element class).  A dead step would add an exact int32 zero, so skipping
// it leaves the sums bitwise the unmasked s8 stream's at any tile and
// split; a rank with no live step still stores its zero int32 partial into
// the owners' inboxes and meets the cluster barrier, and a row block with
// no live step takes the zero finish (splitk::finish_zero, no exchange):
// SingleFlushI8 of an int32 0 (bias and activation of zero, or their
// codes).  int8 is one byte like
// e4m3 and its zero is the byte 0x00 as e4m3's +0 is, so the stage, the
// per-warp transpose, the 1:4-as-2:4 +0 slots, the metadata word, the dense
// A operand (ldmatrix .trans + __byte_perm), select16's +0 for an index
// outside [0, 4) and the operand registers are the e4m3 form's; the
// instructions are mma.sp.sync.aligned.m16n8k64.row.col.s32.s8.s8.s32 and,
// for the dense weight, two mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// a step (mma_s8; the maps of both pinned by kernels/mma_sp_probe.py),
// summed in place into int32 registers: integer sums are exact in any
// order, so no per-64 promotion, and the partial tile, the split's inbox
// and the rank-order sum hold int32 (splitk's finish on int), never a
// float.  No sum can overflow: the widest K of any config is mistral-large's
// d_ff, 28,672, and 28,672 x 127^2 ~ 4.6e8 < 2^31 (the codes are clipped to
// +-127).  The flush (gemm_int8.cu's SingleFlushI8) receives the summed
// int32: acc raw, or float(acc) * xs * ws (the gather kernels' ws first),
// + bias, act, the store (K11's at col * B + row into (O, B)); the duals'
// (DualFlushI8T) both sums: t_g = float(acc_g) * xs * wsg, t_u likewise
// (K9's ws first: float(acc) * ws * xs), silu(t_g) * t_u, the store.  The
// output is bitwise gemm_int8.cu's first body and (the singles) the plain
// version: raw, scaled and requantized.

#pragma once

#include <type_traits>

#include "kmask.cuh"
#include "splitk.cuh"

namespace spf8 {

// The stream's 8-bit element classes: e4m3 sums into fp32 (each 64-deep
// instruction from zero, then promoted), s8 into int32 in place (exact).
struct E4M3 {
  using Acc = float;
};
struct S8 {
  using Acc = int;
};

using splitk::cp_async16;
using splitk::ldsm_x4;
using splitk::ldsm_x4_trans;

constexpr int BO = 64;              // output channels per block (4 warps x 16)
constexpr int BKS = 64;             // dense K per pipeline stage: one k64 instruction
constexpr int NT = 128;
constexpr int VLD = BO + 16;        // byte pitch of the values tile (16-byte aligned rows)
constexpr int XLD = BKS + 16;       // byte pitch of the X tile: ldmatrix rows on distinct banks
constexpr int PLD = BO + 4;         // fp32 pitch of the partial tile

// Byte j of each of four words, as one word (w0's byte lowest).
__device__ __forceinline__ uint32_t gather_byte(uint32_t w0, uint32_t w1, uint32_t w2,
                                                uint32_t w3, int j) {
  const uint32_t sel = j | ((j + 4) << 4);
  const uint32_t lo = __byte_perm(w0, w1, sel);   // bytes 0, 1 = w0.j, w1.j
  const uint32_t hi = __byte_perm(w2, w3, sel);   // bytes 0, 1 = w2.j, w3.j
  return __byte_perm(lo, hi, 0x5410);
}

// The kept bytes of 16 compressed columns of one X row (gather, M = 4):
// column q reads byte e[q] of M-block q / G, held in word wd[q / G] (2:4:
// 8 words, 1:4: 16); an index outside [0, 4) gives +0.  The stream's select
// pass and gemm_fp8.cu's gather pass both build their tiles with it.
template <int G>
__device__ __forceinline__ uint4 select16(const uint32_t (&wd)[16 / G], const int (&e)[16]) {
  uint32_t out[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t keep = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      keep |= static_cast<unsigned>(e[4 * w + j]) < 4u ? 0xffu << (8 * j) : 0u;
    const uint32_t s0 = e[4 * w] & 3, s1 = e[4 * w + 1] & 3, s2 = e[4 * w + 2] & 3,
                   s3 = e[4 * w + 3] & 3;
    if constexpr (G == 2) {   // bytes 0, 1 from block 2w, bytes 2, 3 from block 2w + 1
      out[w] = __byte_perm(wd[2 * w], wd[2 * w + 1],
                           s0 | s1 << 4 | (4 + s2) << 8 | (4 + s3) << 12) & keep;
    } else {                  // byte j from block 4w + j
      const uint32_t lo = __byte_perm(wd[4 * w], wd[4 * w + 1], s0 | (4 + s1) << 4);
      const uint32_t hi = __byte_perm(wd[4 * w + 2], wd[4 * w + 3], s2 | (4 + s3) << 4);
      out[w] = __byte_perm(lo, hi, 0x5410) & keep;
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// A stage is [values (gate)][values (up)][meta (gate)][meta (up)][indices
// (gate)][indices (up)][X], the up tiles for a DUAL only, the indices for a
// gathered X only (whose X is the step's span of 256 / G bytes a row, one
// span for both weights of a dual).  KM, the K-major
// gathered X (K11): no indices a stage (the block's span of them sits
// after the compact X tile, loaded once), X is the step's 64 selected x_t
// rows of BM batch bytes, [64][BM] in 16-byte slots (kslot).
template <int N, int BM, int G = 0, bool DUAL = false, bool KM = false>
struct Layout {
  static_assert(N == 1 || N == 2 || N == 4, "the streaming body takes 1:4, 2:4 and dense");
  static_assert(G == 0 || (N == 4 && (G == 1 || G == 2)),
                "the gathered X (1:4 | 2:4) streams against dense values tiles");
  static_assert(!KM || (G != 0 && !DUAL), "the K-major X is a single's gathered X");
  static constexpr int NW = DUAL ? 2 : 1;        // weights a stage (gate, up)
  // the dense weight (N = 4) gives its A operand straight from the landed
  // tile (ldmatrix .trans + __byte_perm): the tile unpadded, its 16-byte
  // chunks swizzled (vslot), no private transposed tiles
  static constexpr int VP = N == 4 ? BO : VLD;   // byte pitch of the values tile
  // the dense dual's 16-row ring is 4 deep (~45 KB a block; 6 stages timed
  // the same at decode and slower at three blocks an SM on an H100), and so
  // is the gathered dual's (~54 KB at 2:4, ~62 KB at 1:4: three blocks an
  // SM; 6 stages at 1:4 would leave two), in both classes (e4m3, s8: the
  // same bytes)
  static constexpr int STAGES = BM == 16 ? (N == 4 && DUAL ? 4 : 6) : 4;
  static constexpr int WN = BM == 16 ? 1 : 2;    // warps along the batch rows
  static constexpr int WM = 4 / WN;              // warps along the channels
  static constexpr int MT = BO / (16 * WM);      // m16 channel tiles a warp (1 | 2)
  static constexpr int NJ = BM / (8 * WN);       // n8 batch-row tiles a warp (2 | 4)
  static constexpr int VROWS = BKS * N / 4;      // kept rows a stage (16 | 32 | 64)
  static constexpr int MROWS = N == 4 ? 0 : VROWS / 4;   // meta_packed rows a stage (4 | 8)
  static constexpr int TLD = 48;   // byte pitch of a warp's transposed A tile: 32 kept bytes + 16
  static constexpr int V_BYTES = VROWS * VP;                   // one weight's values tile
  static constexpr int M_BYTES = MROWS * BO;                   // one weight's meta tile
  static constexpr int I_BYTES = G && !KM ? NW * BKS * 4 : 0;  // the step's int32 indices
  static constexpr int SPAN = G ? 256 / G : BKS;               // X bytes a row a stage
  static constexpr int SLD = SPAN + 16;                        // byte pitch of the X rows
  static constexpr int X_BYTES = KM ? BKS * BM : BM * SLD;
  static constexpr int M_AT = NW * V_BYTES;                    // the meta tiles in a stage
  static constexpr int I_AT = M_AT + NW * M_BYTES;             // the indices
  static constexpr int X_AT = I_AT + I_BYTES;                  // the X tile (or span)
  static constexpr int STAGE = X_AT + X_BYTES;                 // a multiple of 16
  static constexpr int PART = NW * BM * PLD * 4;               // the partial tiles
  static constexpr int RING = STAGES * STAGE > PART ? STAGES * STAGE : PART;
  static constexpr int T_WARP = N == 4 ? 0 : NW * MT * 16 * TLD;   // a warp's transposed A tiles
  static constexpr int T_BYTES = 4 * T_WARP;
  static constexpr int COMPACT = G ? NW * BM * XLD : 0;        // the selected X tiles (gather)
  static constexpr int INBOX = NW * BM * BO * 4;  // the peers' partial slices (split > 1 only)
  // the K-major X's indices of a block's span: its most steps (split blocks
  // over nk steps) x 64 int32
  __host__ __device__ static constexpr int idx_bytes(int nk, int split) {
    return KM ? (nk + split - 1) / split * BKS * 4 : 0;
  }
};

// The byte offset of chunk j (channels 16 j .. + 15) of K row r in the
// dense values tile (64 bytes a row): the chunk XORed with r's 4-row
// block mod 4, so that the eight K rows an ldmatrix matrix reads ({4i, 4i
// + 1} or {4i + 2, 4i + 3}, i = 0 .. 3) sit in eight distinct 16-byte bank
// groups.
__device__ __forceinline__ int vslot(int r, int j) {
  return r * BO + 16 * (j ^ ((r >> 2) & 3));
}

// The 16-byte slot of chunk ch (batch bytes 16 ch .. + 15) of compressed row
// r in the K-major X tile (CPR chunks a row): the slot index's low three
// bits XORed with r's 4-row block, so that the transpose pass's eight
// K blocks a warp read eight distinct slots mod 8 (32 distinct banks).
template <int CPR>
__device__ __forceinline__ int kslot(int r, int ch) {
  return (r * CPR + ch) ^ ((r >> 2) & 7);
}

// D = A (16 x 64, 2:4, compressed) x B (64 x 8) + C, e4m3 in, fp32 out
__device__ __forceinline__ void mma_sp_e4m3(float (&d)[4], const uint32_t (&a)[4],
                                            const uint32_t (&b)[4], uint32_t e) {
  asm volatile(
      "mma.sp.sync.aligned.m16n8k64.row.col.f32.e4m3.e4m3.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, %12, 0x0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(b[2]),
        "r"(b[3]), "r"(e));
}

// D = A (16 x 64, 2:4, compressed) x B (64 x 8) + D, s8 in, s32 out (exact)
__device__ __forceinline__ void mma_sp_s8(int (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[4], uint32_t e) {
  asm volatile(
      "mma.sp.sync.aligned.m16n8k64.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, %12, 0x0;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(b[2]),
        "r"(b[3]), "r"(e));
}

// D = A (16 x 32, dense) x B (32 x 8) + C, e4m3 in, fp32 out.  A registers
// of lane 4g + t: channels g, g + 8 at K bytes 4t .. + 3, then 16 + 4t ..;
// B registers: K bytes 4t .. + 3 and 16 + 4t .. of batch row g.
__device__ __forceinline__ void mma_e4m3(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A (16 x 32, dense) x B (32 x 8) + D, s8 in, s32 out (exact): the
// fragment maps of mma_e4m3 (pinned on the card by kernels/mma_sp_probe.py)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The kept byte v of a 1:4 group as its 2:4 pair of slots (16 bits).
__device__ __forceinline__ uint32_t pair8_1of4(uint32_t v, uint32_t i) {
  return i == 0u ? v : v << 8;
}

// k: the contraction (K, or K_c for the gathered X, whose `meta` is the
// int32 index and whose X rows are K_eff = k * 4 / G bytes wide; KM: x is
// x_t (K_eff, b), b a multiple of 16, and flush(row, col, sum) gets the
// batch row and channel in column-major order).  DUAL: v2 and meta2 are
// the up weight's (v, meta the gate's) and flush(row, col, sums) takes both
// sums; else flush(row, col, sum).  MASKED (a single, X contiguous or
// gathered): kmask is block_maps' (row blocks, k / 64) map; the block walks
// the live steps of its span only, and a row block with no live step
// flushes zero sums without the split's exchange.  Elem: E4M3, or S8 (every form; the sums, and
// what flush receives, are int32).
template <int N, int BM, int G, bool DUAL, bool KM, bool MASKED, class Elem, class Flush>
__global__ void __launch_bounds__(NT)
nm_spmm_sp_fp8_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ v,
                      const uint8_t* __restrict__ meta, const uint8_t* __restrict__ v2,
                      const uint8_t* __restrict__ meta2, const int* __restrict__ kmask,
                      Flush flush, int b, int k, int o, int split) {
  using L = Layout<N, BM, G, DUAL, KM>;
  using Acc = typename Elem::Acc;
  constexpr bool IS_S8 = std::is_same_v<Elem, S8>;
  static_assert(!MASKED || (!DUAL && !KM),
                "the masked stream is a single, X contiguous or gathered (G = n)");
  constexpr int NW = L::NW, MT = L::MT, NJ = L::NJ, TLD = L::TLD;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ch0 = (warp % L::WM) * MT * 16;    // the warp's first channel in the tile
  const int r0 = (warp / L::WM) * NJ * 8;      // the warp's first batch row in the tile
  const int n0 = blockIdx.x * BO;
  const int m0 = blockIdx.y * BM;
  const int rank = blockIdx.z;                 // the cluster is (1, 1, split): rank = z
  int s0, ns;
  splitk::span(rank, split, k / BKS, s0, ns);
  const int rows = min(BM, b - m0);            // live batch rows of this tile
  uint8_t* tw = smem + L::RING + warp * L::T_WARP;   // this warp's transposed A tiles
  uint8_t* compact = smem + L::RING + L::T_BYTES;    // the selected X tile (gather)
  int* kidx = reinterpret_cast<int*>(compact + L::COMPACT);   // KM: the span's indices
  Acc* inbox = reinterpret_cast<Acc*>(compact + L::COMPACT + L::idx_bytes(k / BKS, split));

  auto store = [&](int r, int c, const Acc (&sum)[NW]) {
    if constexpr (DUAL) flush(m0 + r, n0 + c, sum);
    else flush(m0 + r, n0 + c, sum[0]);
  };

  // The walk: the span's steps, or (MASKED) its live steps only
  // (kmask.cuh's block_live and SpanWalk).  A kmask column is one step of
  // 64 compressed rows: with the gathered X, the stage's 256 / G span.
  const auto* live = block_live<MASKED, NT>(kmask, blockIdx.y, k / BKS, tid);
  if constexpr (MASKED) {
    // A row block with no live step at all: every rank folds the same whole
    // map row, so every rank ends here alike, none stores a partial into a
    // peer's inbox and none waits at the cluster barrier.
    if (live->next(0, k / BKS) == k / BKS) {
      splitk::finish_zero<BM, BO, NT, NW, KM, Acc>(rank, split, rows, store);
      return;
    }
  }
  SpanWalk<MASKED, NT> at(live, s0, ns);
  ns = at.steps();

  auto load_stage = [&](int st, int s) {
    uint8_t* base = smem + st * L::STAGE;
    const int kc0 = s * L::VROWS;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint8_t* vs = base + w * L::V_BYTES;
      const uint8_t* src = w ? v2 : v;
      if constexpr (N == 4) {
#pragma unroll
        for (int c = tid; c < L::VROWS * 4; c += NT) {
          const int r = c >> 2, col = (c & 3) * 16;
          cp_async16(vs + vslot(r, c & 3), src + static_cast<size_t>(kc0 + r) * o + n0 + col, 16);
        }
      } else if (tid < L::VROWS * 4) {
        const int r = tid >> 2, col = (tid & 3) * 16;
        cp_async16(vs + r * VLD + col, src + static_cast<size_t>(kc0 + r) * o + n0 + col, 16);
      }
    }
    if constexpr (N != 4) {
      if (tid < NW * L::MROWS * 4) {   // both weights' meta rows, one chunk a thread
        const int w = tid / (L::MROWS * 4), q = tid % (L::MROWS * 4);
        const int r = q >> 2, col = (q & 3) * 16;
        cp_async16(base + L::M_AT + w * L::M_BYTES + r * BO + col,
                   (w ? meta2 : meta) + static_cast<size_t>(s * L::MROWS + r) * o + n0 + col,
                   16);
      }
    }
    uint8_t* xs = base + L::X_AT;
    if constexpr (KM) {
      // the step's 64 selected x_t rows, (c / G) * 4 + idx[c] for compressed
      // row c, BM batch bytes each from column m0 (16-byte chunks; an index
      // outside [0, 4) and columns at or past b land as zeros)
      constexpr int CPR = BM / 16;
      const int* is = kidx + (s - s0) * BKS;
#pragma unroll
      for (int c = tid; c < BKS * CPR; c += NT) {
        const int r = c / CPR, ch = c % CPR;
        const int e = is[r], col = m0 + 16 * ch, kc = s * BKS + r;
        const bool live = static_cast<unsigned>(e) < 4u && col < b;
        cp_async16(xs + 16 * kslot<CPR>(r, ch),
                   x + (live ? static_cast<size_t>(kc / G * 4 + e) * b + col : 0),
                   live ? 16 : 0);
      }
    } else if constexpr (G != 0) {
      // the step's indices (each weight's), and the X span they select from
      // (ke = k * 4 / G): one span for both weights of a dual
      if (tid < NW * BKS / 4) {
        const int w = tid / (BKS / 4), q = tid % (BKS / 4);
        cp_async16(base + L::I_AT + w * BKS * 4 + 16 * q,
                   reinterpret_cast<const int*>(w ? meta2 : meta) + s * BKS + 4 * q, 16);
      }
      constexpr int CPR = L::SPAN / 16;            // 16-byte chunks of a span row
#pragma unroll
      for (int c = tid; c < BM * CPR; c += NT) {
        const int r = c / CPR, col = (c % CPR) * 16;
        const bool live = r < rows;
        cp_async16(xs + r * L::SLD + col,
                   x + static_cast<size_t>(live ? m0 + r : 0) * (k / G * 4) + s * L::SPAN + col,
                   live ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int c = tid; c < BM * 4; c += NT) {
        const int r = c >> 2, col = (c & 3) * 16;
        const bool live = r < rows;
        cp_async16(xs + r * XLD + col,
                   x + static_cast<size_t>(live ? m0 + r : 0) * k + s * BKS + col, live ? 16 : 0);
      }
    }
  };

  Acc acc[NW][MT][NJ][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[w][mt][j][0] = acc[w][mt][j][1] = acc[w][mt][j][2] = acc[w][mt][j][3] = Acc(0);

  // X tiles the products read: a gathered dual's two compact tiles, else one
  constexpr int NXT = (DUAL && G != 0) ? 2 : 1;
  auto compute = [&](int st) {
    const uint8_t* base = smem + st * L::STAGE;
    const uint8_t* xt[NXT];
    xt[0] = base + L::X_AT;
    if constexpr (KM) {
      // the transpose pass: unit u = (chunk u / 64, K block q = (u / 4) % 16,
      // word w = u % 4) turns the 4 x 4 byte block (compressed rows 4q .. + 3,
      // batch bytes 16 chunk + 4w .. + 3) into four batch rows' words of the
      // compact [BM][XLD] tile
      constexpr int CPR = BM / 16;
#pragma unroll
      for (int u = tid; u < BKS * CPR; u += NT) {
        const int w = u & 3, q = (u >> 2) & 15, ch = u >> 6;
        uint32_t wd[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wd[r] = lds32(xt[0] + 16 * kslot<CPR>(4 * q + r, ch) + 4 * w);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(compact + (16 * ch + 4 * w + j) * XLD + 4 * q) =
              gather_byte(wd[0], wd[1], wd[2], wd[3], j);
      }
      __syncthreads();
      xt[0] = compact;
    } else if constexpr (G != 0) {
      // the select pass: unit u = (row u / 4, compressed columns 16 (u % 4)
      // .. + 15) of the compact tile, one 16-byte store from the words of
      // its M-blocks (2:4: 32 span bytes, 1:4: 64).  A dual reads the unit's
      // span words once and selects twice, through each weight's indices,
      // into two compact tiles.
      const int* is = reinterpret_cast<const int*>(base + L::I_AT);
#pragma unroll
      for (int u = tid; u < BM * 4; u += NT) {
        const int r = u >> 2, j0 = (u & 3) * 16;
        const uint4* row = reinterpret_cast<const uint4*>(xt[0] + r * L::SLD + j0 / G * 4);
        uint32_t wd[16 / G];
#pragma unroll
        for (int c = 0; c < 4 / G; ++c) {
          const uint4 q = row[c];
          wd[4 * c] = q.x;
          wd[4 * c + 1] = q.y;
          wd[4 * c + 2] = q.z;
          wd[4 * c + 3] = q.w;
        }
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          int e[16];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int4 q = reinterpret_cast<const int4*>(is + w * BKS + j0)[c];
            e[4 * c] = q.x;
            e[4 * c + 1] = q.y;
            e[4 * c + 2] = q.z;
            e[4 * c + 3] = q.w;
          }
          *reinterpret_cast<uint4*>(compact + w * BM * XLD + r * XLD + j0) = select16<G>(wd, e);
        }
      }
      __syncthreads();
#pragma unroll
      for (int ti = 0; ti < NXT; ++ti) xt[ti] = compact + ti * BM * XLD;
    }
    uint32_t bf[NXT][NJ][4];    // X rows r0 + 8j .. + 7 at K bytes 0 .. 63, each X tile
#pragma unroll
    for (int ti = 0; ti < NXT; ++ti)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (r0 + j * 8 < rows)   // warp-uniform: n8 tiles wholly past B are skipped
          ldsm_x4(bf[ti][j], xt[ti] + (r0 + j * 8 + (lane & 7)) * XLD + (lane >> 3) * 16);
    if constexpr (N == 4) {
      // The dense A operand from the landed tile.  ldmatrix .trans on b16
      // gives lane 4g + t, from a matrix of eight K rows (row i's address
      // from lane 8m + i), the channel pair 2g, 2g + 1 at rows 2t and 2t +
      // 1; matrix 0 takes K rows 4i, 4i + 1 (i = 0 .. 3), matrix 1 rows 4i +
      // 2, 4i + 3, matrices 2, 3 the same 16 rows on.  __byte_perm then
      // forms channel 2g's K bytes 4t .. 4t + 3 (A row g) and channel 2g +
      // 1's (A row g + 8): the K order is the mma's own, the channels land
      // permuted (A row g is channel 2g, row g + 8 channel 2g + 1), which
      // the partial store maps back.
      const int m = lane >> 3, i = lane & 7;
      const int krow = 16 * (m >> 1) + 4 * (i >> 1) + 2 * (m & 1) + (i & 1);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint8_t* vs = base + w * L::V_BYTES;
        // a gathered dual's up weight reads its own compact X
        const uint32_t(&bx)[NJ][4] = bf[NXT == 2 ? w : 0];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int jc = (ch0 + mt * 16) >> 4;   // the warp tile's 16-channel chunk
          uint32_t a[2][4];                      // K bytes 0 .. 31, 32 .. 63
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t q[4];
            ldsm_x4_trans(q, vs + vslot(32 * h + krow, jc));
            a[h][0] = __byte_perm(q[0], q[1], 0x6420);
            a[h][1] = __byte_perm(q[0], q[1], 0x7531);
            a[h][2] = __byte_perm(q[2], q[3], 0x6420);
            a[h][3] = __byte_perm(q[2], q[3], 0x7531);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            if (r0 + j * 8 < rows) {
              if constexpr (IS_S8) {   // int32: exact in place
                mma_s8(acc[w][mt][j], a[0], bx[j][0], bx[j][1]);
                mma_s8(acc[w][mt][j], a[1], bx[j][2], bx[j][3]);
              } else {
                // the 64-deep partial sum (two k32 instructions), promoted into fp32
                float part[4] = {0.f, 0.f, 0.f, 0.f};
                mma_e4m3(part, a[0], bx[j][0], bx[j][1]);
                mma_e4m3(part, a[1], bx[j][2], bx[j][3]);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[w][mt][j][e] = __fadd_rn(acc[w][mt][j][e], part[e]);
              }
            }
        }
      }
    } else {
      // the compressed weight (N = 1, 2): each warp transposes its part of the
      // landed values tile into its private tile, then mma.sp
      __syncwarp();            // every lane is done reading the previous step's tiles
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint8_t* vs = base + w * L::V_BYTES;
        const uint8_t* ms = base + L::M_AT + w * L::M_BYTES;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int c = ch0 + mt * 16;    // channels c .. c + 15: A's rows
          uint8_t* ta = tw + (w * MT + mt) * 16 * TLD;
          const int p = lane & 3, q = lane >> 2;
          if constexpr (N == 2) {
            // lane (p, q): kept rows 4q .. + 3 x channels c + 4p .. + 3 -> four
            // channel rows of 4 consecutive kept bytes
            const uint8_t* src = vs + 4 * q * VLD + c + 4 * p;
            const uint32_t w0 = lds32(src), w1 = lds32(src + VLD), w2 = lds32(src + 2 * VLD),
                           w3 = lds32(src + 3 * VLD);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              *reinterpret_cast<uint32_t*>(ta + (4 * p + j) * TLD + 4 * q) =
                  gather_byte(w0, w1, w2, w3, j);
          } else {
            // lane (p, q): kept rows 4 (q & 3) .. + 3 (groups 4 (q & 3) .. + 3) x
            // channels c + 4p + 2 (q >> 2) .. + 1, their indices in meta row q &
            // 3 -> 8 bytes a channel (two channels a lane: all 32 lanes work)
            const int qq = q & 3, j0 = 2 * (q >> 2);
            const uint8_t* src = vs + 4 * qq * VLD + c + 4 * p;
            const uint32_t wv[4] = {lds32(src), lds32(src + VLD), lds32(src + 2 * VLD),
                                    lds32(src + 3 * VLD)};
            const uint32_t mw = lds32(ms + qq * BO + c + 4 * p);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int j = j0 + jj;
              const uint32_t mb = (mw >> (8 * j)) & 0xffu;
              uint32_t pr[4];
#pragma unroll
              for (int r = 0; r < 4; ++r)
                pr[r] = pair8_1of4((wv[r] >> (8 * j)) & 0xffu, (mb >> (2 * r)) & 3u);
              uint32_t* dst = reinterpret_cast<uint32_t*>(ta + (4 * p + j) * TLD + 8 * qq);
              dst[0] = pr[0] | pr[1] << 16;
              dst[1] = pr[2] | pr[3] << 16;
            }
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint8_t* ms = base + L::M_AT + w * L::M_BYTES;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int c = ch0 + mt * 16;
          uint32_t a[4];
          const uint8_t* ta = tw + (w * MT + mt) * 16 * TLD +
                              ((lane & 7) + ((lane >> 3) & 1) * 8) * TLD + (lane >> 4) * 16;
          ldsm_x4(a, ta);
          // lane 4g + t: groups 8 (t >> 1) .. + 7 of channel c + g + 8 (t & 1)
          const int ch = c + g + 8 * (t & 1), h = t >> 1;
          uint32_t e;
          if constexpr (N == 2) {
            const uint8_t* mp = ms + 4 * h * BO + ch;
            e = static_cast<uint32_t>(mp[0]) | static_cast<uint32_t>(mp[BO]) << 8 |
                static_cast<uint32_t>(mp[2 * BO]) << 16 |
                static_cast<uint32_t>(mp[3 * BO]) << 24;
          } else {
            const uint8_t* mp = ms + 2 * h * BO + ch;
            e = splitk::expand_1of4(static_cast<uint32_t>(mp[0]) |
                                    static_cast<uint32_t>(mp[BO]) << 8);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            if (r0 + j * 8 < rows) {
              if constexpr (IS_S8) {
                mma_sp_s8(acc[w][mt][j], a, bf[0][j], e);   // int32: exact in place
              } else {
                // the 64-deep partial sum on the tensor cores, promoted into fp32
                float part[4] = {0.f, 0.f, 0.f, 0.f};
                mma_sp_e4m3(part, a, bf[0][j], e);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  acc[w][mt][j][i] = __fadd_rn(acc[w][mt][j][i], part[i]);
              }
            }
        }
      }
    }
  };
  if constexpr (KM) {
    // the span's indices, once, before the ring (the X loads address by them)
    const int* gi = reinterpret_cast<const int*>(meta) + s0 * BKS;
    for (int c = tid; c < ns * BKS / 4; c += NT) cp_async16(kidx + 4 * c, gi + 4 * c, 16);
    splitk::cp_async_commit();
    splitk::cp_async_wait<0>();
    __syncthreads();
  }
  splitk::run_ring<L::STAGES>(ns, at, load_stage, compute);

  // partial tiles [weight][batch row][channel], fp32 (s8: int32)
  Acc* part = reinterpret_cast<Acc*>(smem);
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        Acc* pw = part + w * BM * PLD;
        const int r = r0 + j * 8 + 2 * t;
        // A row g (g + 8) is channel g (g + 8); the dense A's channel 2g (2g + 1)
        const int c = ch0 + mt * 16 + (N == 4 ? 2 * g : g), c8 = N == 4 ? 1 : 8;
        pw[r * PLD + c] = acc[w][mt][j][0];
        pw[(r + 1) * PLD + c] = acc[w][mt][j][1];
        pw[r * PLD + c + c8] = acc[w][mt][j][2];
        pw[(r + 1) * PLD + c + c8] = acc[w][mt][j][3];
      }
  __syncthreads();

  splitk::finish_planes<BM, BO, PLD, NT, NW, KM>(part, inbox, rank, split, rows, store);
}

template <int N, int BM, int G, bool DUAL, bool KM, bool MASKED = false, class Elem = E4M3,
          class Flush>
int launch(const void* x, const void* v, const void* meta, const void* v2, const void* meta2,
           const void* kmask, const Flush& flush, int b, int k, int o, int split,
           cudaStream_t stream) {
  using L = Layout<N, BM, G, DUAL, KM>;
  static int opted = 0;
  return splitk::launch(nm_spmm_sp_fp8_kernel<N, BM, G, DUAL, KM, MASKED, Elem, Flush>, opted,
                        dim3(o / BO, (b + BM - 1) / BM), NT,
                        L::RING + L::T_BYTES + L::COMPACT + L::idx_bytes(k / BKS, split),
                        L::INBOX, split, stream, static_cast<const uint8_t*>(x),
                        static_cast<const uint8_t*>(v), static_cast<const uint8_t*>(meta),
                        static_cast<const uint8_t*>(v2), static_cast<const uint8_t*>(meta2),
                        static_cast<const int*>(kmask), flush, b, k, o, split);
}

// The launches the C entries take: b rows in tiles of bm (16 | 64), at most
// 65535 of them, k the contraction and o multiples of 64, split a power of
// two up to min(8, k / 64)
inline bool launch_ok(int b, int k, int o, int bm, int split) {
  return b > 0 && k > 0 && o > 0 && k % BKS == 0 && o % BO == 0 && (bm == 16 || bm == 64) &&
         splitk::split_ok(split, k / BKS) && (b + bm - 1) / bm <= 65535;
}

// n in {1, 2} (values + meta_packed) or 4 (a dense (K, O) e4m3 weight, meta
// unused), bm in {16, 64}, split a power of two up to min(8, k / 64);
// flush(row, col, acc) stores one output from its summed fp32 accumulator;
// kmask: the masked single (nm_spmm_masked_fp8 at n in {1, 2},
// tile_gemm_masked_fp8 at n = 4) with block_maps' (ceil(b / bm), k / 64)
// map, else nullptr
template <class Flush>
int launch_nm(int n, int bm, const void* x, const void* v, const void* meta, const void* kmask,
              const Flush& flush, int b, int k, int o, int split, void* stream) {
  if (!launch_ok(b, k, o, bm, split) || (kmask != nullptr && k / BKS > MAX_K_STEPS))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VG_SPF8_LAUNCH(NN, BB, MM)                                                            \
  return launch<NN, BB, 0, false, false, MM>(x, v, meta, nullptr, nullptr, kmask, flush, b, k, \
                                             o, split, s)
  if (kmask != nullptr) {
    if (n == 2 && bm == 16) VG_SPF8_LAUNCH(2, 16, true);
    if (n == 2 && bm == 64) VG_SPF8_LAUNCH(2, 64, true);
    if (n == 1 && bm == 16) VG_SPF8_LAUNCH(1, 16, true);
    if (n == 1 && bm == 64) VG_SPF8_LAUNCH(1, 64, true);
    if (n == 4 && bm == 16) VG_SPF8_LAUNCH(4, 16, true);
    if (n == 4 && bm == 64) VG_SPF8_LAUNCH(4, 64, true);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 2 && bm == 16) VG_SPF8_LAUNCH(2, 16, false);
  if (n == 2 && bm == 64) VG_SPF8_LAUNCH(2, 64, false);
  if (n == 1 && bm == 16) VG_SPF8_LAUNCH(1, 16, false);
  if (n == 1 && bm == 64) VG_SPF8_LAUNCH(1, 64, false);
  if (n == 4 && bm == 16) VG_SPF8_LAUNCH(4, 16, false);
  if (n == 4 && bm == 64) VG_SPF8_LAUNCH(4, 64, false);
#undef VG_SPF8_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The s8 form over a contiguous X (b, k) int8: nm_spmm_int8's body (values +
// meta_packed int8 at n in {1, 2}) and tile_gemm_int8's (a dense (K, O) int8
// weight at n = 4, meta unused); bm in {16, 64}, split a power of two up to
// min(8, k / 64); flush(row, col, acc) stores one output from its summed
// int32 accumulator; kmask: the masked single (nm_spmm_masked_int8 at n in
// {1, 2}, tile_gemm_masked_int8 at n = 4) with block_maps' (ceil(b / bm),
// k / 64) map, else nullptr
template <class Flush>
int launch_s8(int n, int bm, const void* x, const void* v, const void* meta, const void* kmask,
              const Flush& flush, int b, int k, int o, int split, void* stream) {
  if (!launch_ok(b, k, o, bm, split) || (kmask != nullptr && k / BKS > MAX_K_STEPS))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VG_SPF8_S8(NN, BB, MM)                                                              \
  return launch<NN, BB, 0, false, false, MM, S8>(x, v, meta, nullptr, nullptr, kmask, flush, \
                                                 b, k, o, split, s)
  if (kmask != nullptr) {
    if (n == 2 && bm == 16) VG_SPF8_S8(2, 16, true);
    if (n == 2 && bm == 64) VG_SPF8_S8(2, 64, true);
    if (n == 1 && bm == 16) VG_SPF8_S8(1, 16, true);
    if (n == 1 && bm == 64) VG_SPF8_S8(1, 64, true);
    if (n == 4 && bm == 16) VG_SPF8_S8(4, 16, true);
    if (n == 4 && bm == 64) VG_SPF8_S8(4, 64, true);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 2 && bm == 16) VG_SPF8_S8(2, 16, false);
  if (n == 2 && bm == 64) VG_SPF8_S8(2, 64, false);
  if (n == 1 && bm == 16) VG_SPF8_S8(1, 16, false);
  if (n == 1 && bm == 64) VG_SPF8_S8(1, 64, false);
  if (n == 4 && bm == 16) VG_SPF8_S8(4, 16, false);
  if (n == 4 && bm == 64) VG_SPF8_S8(4, 64, false);
#undef VG_SPF8_S8
  return static_cast<int>(cudaErrorInvalidValue);
}

// nm_spmm_dual_fp8's few-row body: both compressed weights (values_g /
// meta_g, values_u / meta_u) at n in {1, 2}, and tile_gemm_dual_fp8's: both
// dense (K, O) e4m3 weights at n = 4 (meta unused); with Elem S8,
// nm_spmm_dual_int8's (n in {1, 2}) and tile_gemm_dual_int8's (n = 4); bm
// in {16, 64}; flush(row, col, sums) stores one output from its two summed
// fp32 (s8: int32) accumulators
template <class Elem = E4M3, class Flush>
int launch_dual(int n, int bm, const void* x, const void* vg, const void* mg, const void* vu,
                const void* mu, const Flush& flush, int b, int k, int o, int split,
                void* stream) {
  if (!launch_ok(b, k, o, bm, split)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VG_SPF8_DUAL(NN, BB)                                                                 \
  return launch<NN, BB, 0, true, false, false, Elem>(x, vg, mg, vu, mu, nullptr, flush, b, k, \
                                                     o, split, s)
  if (n == 2 && bm == 16) VG_SPF8_DUAL(2, 16);
  if (n == 2 && bm == 64) VG_SPF8_DUAL(2, 64);
  if (n == 1 && bm == 16) VG_SPF8_DUAL(1, 16);
  if (n == 1 && bm == 64) VG_SPF8_DUAL(1, 64);
  if (n == 4 && bm == 16) VG_SPF8_DUAL(4, 16);
  if (n == 4 && bm == 64) VG_SPF8_DUAL(4, 64);
#undef VG_SPF8_DUAL
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8's few-row body, e4m3 (Elem E4M3, K8 fp8) or int8 (S8, K8 int8): X (b,
// ke) gathered at n in {1, 2} through idx (K_c = ke * n / 4 int32) against
// values (K_c, O) as a dense weight of the class; bm in {16, 64}, split a
// power of two up to min(8, K_c / 64); flush(row, col, acc) stores one output
// from its summed fp32 (s8: int32) accumulator; kmask: the masked gather
// (nm_spmm_gather_bk_masked_fp8 / _int8) with block_maps' (ceil(b / bm),
// K_c / 64) map, else nullptr
template <class Elem = E4M3, class Flush>
int launch_gather(int n, int bm, const void* x, const void* values, const void* idx,
                  const void* kmask, const Flush& flush, int b, int ke, int o, int split,
                  void* stream) {
  if (ke <= 0 || (ke * n) % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int kc = ke * n / 4;
  if (!launch_ok(b, kc, o, bm, split) || (kmask != nullptr && kc / BKS > MAX_K_STEPS))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VG_SPF8_GATHER(GG, BB, MM)                                                         \
  return launch<4, BB, GG, false, false, MM, Elem>(x, values, idx, nullptr, nullptr, kmask, \
                                                   flush, b, kc, o, split, s)
  if (kmask != nullptr) {
    if (n == 2 && bm == 16) VG_SPF8_GATHER(2, 16, true);
    if (n == 2 && bm == 64) VG_SPF8_GATHER(2, 64, true);
    if (n == 1 && bm == 16) VG_SPF8_GATHER(1, 16, true);
    if (n == 1 && bm == 64) VG_SPF8_GATHER(1, 64, true);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 2 && bm == 16) VG_SPF8_GATHER(2, 16, false);
  if (n == 2 && bm == 64) VG_SPF8_GATHER(2, 64, false);
  if (n == 1 && bm == 16) VG_SPF8_GATHER(1, 16, false);
  if (n == 1 && bm == 64) VG_SPF8_GATHER(1, 64, false);
#undef VG_SPF8_GATHER
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9's few-row body, e4m3 (Elem E4M3, nm_spmm_gather_dual_bk_fp8 and
// _requant) or int8 (S8, nm_spmm_gather_dual_bk_int8 and _requant): X (b,
// ke) of the class gathered at n in {1, 2} through idx_g and idx_u (K_c = ke
// * n / 4 int32 each) against values_g and values_u (K_c, O) as dense weights
// of the class, one span a step selected twice; bm 16 (the plans' tile:
// nm_spmm_gather/kernel.py::fp8_dual_plan, ::int8_dual_plan), split a power
// of two up to min(8, K_c / 64); flush(row, col, sums) stores one output
// from its two summed fp32 (s8: int32) accumulators
template <class Elem = E4M3, class Flush>
int launch_gather_dual(int n, int bm, const void* x, const void* vg, const void* ig,
                       const void* vu, const void* iu, const Flush& flush, int b, int ke, int o,
                       int split, void* stream) {
  if (ke <= 0 || (ke * n) % 4 != 0 || bm != 16) return static_cast<int>(cudaErrorInvalidValue);
  const int kc = ke * n / 4;
  if (!launch_ok(b, kc, o, bm, split)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 2)
    return launch<4, 16, 2, true, false, false, Elem>(x, vg, ig, vu, iu, nullptr, flush, b, kc,
                                                      o, split, s);
  if (n == 1)
    return launch<4, 16, 1, true, false, false, Elem>(x, vg, ig, vu, iu, nullptr, flush, b, kc,
                                                      o, split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K11's body, e4m3 (Elem E4M3, K11 fp8) or int8 (S8, K11 int8): x_t (ke, b)
// of the class, b a multiple of 16, gathered at n in {1, 2} through idx (K_c =
// ke * n / 4 int32) against values (K_c, O) as a dense weight of the class;
// bm in {16, 64}, split a power of two up to min(8, K_c / 64); flush(row,
// col, acc) stores the (O, B) output of batch row `row`, channel `col`, from
// its summed fp32 (s8: int32) accumulator
template <class Elem = E4M3, class Flush>
int launch_kmajor(int n, int bm, const void* x_t, const void* values, const void* idx,
                  const Flush& flush, int b, int ke, int o, int split, void* stream) {
  if (ke <= 0 || (ke * n) % 4 != 0 || b % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int kc = ke * n / 4;
  if (!launch_ok(b, kc, o, bm, split)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VG_SPF8_KMAJOR(GG, BB)                                                              \
  return launch<4, BB, GG, false, true, false, Elem>(x_t, values, idx, nullptr, nullptr,   \
                                                     nullptr, flush, b, kc, o, split, s)
  if (n == 2 && bm == 16) VG_SPF8_KMAJOR(2, 16);
  if (n == 2 && bm == 64) VG_SPF8_KMAJOR(2, 64);
  if (n == 1 && bm == 16) VG_SPF8_KMAJOR(1, 16);
  if (n == 1 && bm == 64) VG_SPF8_KMAJOR(1, 64);
#undef VG_SPF8_KMAJOR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace spf8
