// Cosine scan with streaming top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bodies `_vdb_sharded_kernel` and
// `_vdb_kernel` of repro/kernels/vdb_topk.py, behind their three entry
// points:
//   vdb_topk_pernode_launch -> vdb_topk_pernode (K1: top-k of every node,
//                        per query), one clustered launch (below)
//   vdb_topk_launch    -> vdb_topk_sharded (K2: one top-k per plane across
//                        all nodes; mask_nodes restricts query q to the slab
//                        of node node_ids[q]); with per_node = 1 it is the
//                        two-pass per-node scan K1 used before the clustered
//                        one, kept for comparison (tools/kernel_diag.py)
//   vdb_topk_single_launch -> vdb_topk (K3, one slab, one index): the
//                        two-pass per-node scan of one plane and one node,
//                        whose global slot ids are then the db's row ids
//
// Inputs: queries (Q, D) f32; slabs (P, N, cap, D) f32; valid (N, cap)
// bool; node_ids (Q,) int32.  Outputs: scores and GLOBAL slot ids
// (node * cap + col), (P, N, Q, k) per node or (P, Q, k) global.
//
// Order: every candidate (masked ones included) is ranked by score
// descending, then by global slot ascending.  That is a strict total
// order, so the result is exactly what a stable descending sort of all
// candidates gives (the plain version's rule, and jax.lax.top_k's), and
// it does not depend on the order in which lists are merged.  Masked
// candidates carry the -1e30 sentinel and rank below every real score;
// the host drops them before they can become hits.
//
// A score is the same bits in both paths: lane l sums the products of the
// float4 columns l, l + 32, .. in order (fmaf, x y z w), then a fixed
// butterfly over the lanes (16, 8, 4, 2, 1).
//
// Bound on the card: the slab bytes (P*N*cap*D*4 read once per tile of
// queries), i.e. memory.  The dot products are 2*Q*P*N*cap*D operations,
// far below the f32 rate.
//
// Two-pass path (K2, K3).  The TPU kernel walks (plane, node, block) in
// order on one core and carries the running top-k in VMEM.  Blocks on the
// GPU run in no order, so the work is split in two launches:
//   1. scan_chunks: one block per (chunk of ROWS capacity rows, plane and
//      node, tile of QTILE queries).  Each warp streams whole slab rows
//      (float4 loads, each row read once per query tile) and forms the dot
//      products with the query tile held in shared memory; then one warp
//      per query selects the chunk's top-k (k rounds of a warp arg-max)
//      into a scratch list.
//   2. merge_lists: one warp per output list merges the chunk lists — of
//      one node (PER_NODE) or of every node of the plane (global) — with
//      k rounds of "best candidate strictly after the last one taken".
//
// Clustered per-node path (K1), one launch, no scratch in device memory:
//   * One thread-block cluster per (plane, node, tile of QT queries); QT is
//     the micro-batch rounded up to 1, 2, 4, 8 or 16, so no block loads or
//     multiplies query rows that do not exist.  The cluster's CL blocks
//     split the node's capacity rows into contiguous chunks (the
//     launcher's plan: at least 32 rows a block, at most 8 blocks, the
//     portable cluster size; an H100 holds 15 clusters of 8 at once, and
//     7 of 13 or 16, as tools/kernel_diag.py measures), so 4 nodes x 2
//     planes take 64 SMs where one block per
//     (plane, node) would take 8, and a larger capacity only lengthens
//     each block's loop.
//   * A block streams its chunk in tiles of 32 rows through a ring of up
//     to 4 stages of shared memory, every stage's 16-byte cp.async copies
//     in flight at once (the whole chunk at the serving shapes).  Each warp
//     forms the dot products of 4 rows with the QT queries, and a
//     transposed butterfly (lanes swap half their sums at each level) ends
//     with each lane holding whole scores: the same tree as the butterfly,
//     a fifth of its shuffles at QT = 8.
//   * One warp per query keeps that query's running top-32 in registers,
//     sorted (lane r holds rank r).  A tile's 32 candidates, one a lane,
//     are skipped unless one of them beats the current k-th; otherwise a
//     warp bitonic sort and a bitonic merge with the running list (21
//     compare-exchange steps; the first tile only sorts) take them in.
//   * At the end each block puts its top-k per query in shared memory;
//     after a cluster barrier, block (q mod CL) reads every block's list of
//     query q through distributed shared memory and its warps merge them
//     in a fixed binary tree (warp w merges ranks 2w and 2w + 1, then the
//     pairs' results, ..), and writes the output.  A second cluster barrier
//     keeps the lists alive until every reader is done.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ROWS = 64;       // capacity rows per block (one chunk)
constexpr int QTILE = 16;      // queries per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_K = 32;
constexpr float MASKED = -1e30f;         // masked-candidate sentinel
constexpr int EMPTY_SLOT = 0x7fffffff;   // past the end of a slab

// strict total order: higher score first, then lower global slot
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// warp-wide arg-best of (score, slot, owner); every lane gets the winner
__device__ __forceinline__ void warp_best(float& s, int& i, int& owner) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    int o2 = __shfl_xor_sync(0xffffffffu, owner, off);
    if (better(s2, i2, s, i) || (s2 == s && i2 == i && o2 < owner)) {
      s = s2;
      i = i2;
      owner = o2;
    }
  }
}

template <bool MASK_NODES>
__global__ void __launch_bounds__(THREADS)
scan_chunks(const float* __restrict__ q, const float* __restrict__ slabs,
            const uint8_t* __restrict__ valid,
            const int* __restrict__ node_ids, float* __restrict__ part_s,
            int* __restrict__ part_i, int n_nodes, int cap, int dim, int n_q,
            int k, int n_chunks) {
  extern __shared__ float4 q_s[];                 // (QTILE, dim/4)
  __shared__ float score_s[QTILE][ROWS];

  const int chunk = blockIdx.x;
  const int pn = blockIdx.y;                      // plane * n_nodes + node
  const int node = pn % n_nodes;
  const int q0 = blockIdx.z * QTILE;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d4 = dim / 4;

  // query tile -> shared memory (zero rows past the end)
  for (int e = threadIdx.x; e < QTILE * d4; e += THREADS) {
    int qi = e / d4, c = e % d4;
    q_s[e] = (q0 + qi < n_q)
        ? reinterpret_cast<const float4*>(q)[(size_t)(q0 + qi) * d4 + c]
        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // scores: each warp streams rows warp, warp + WARPS, ... of the chunk
  const float4* slab4 = reinterpret_cast<const float4*>(slabs) +
                        (size_t)pn * cap * d4;
  for (int r = warp; r < ROWS; r += WARPS) {
    const int col = chunk * ROWS + r;
    float acc[QTILE];
#pragma unroll
    for (int qi = 0; qi < QTILE; ++qi) acc[qi] = 0.f;
    if (col < cap) {
      const float4* row = slab4 + (size_t)col * d4;
      for (int c = lane; c < d4; c += 32) {
        float4 v = __ldg(row + c);
#pragma unroll
        for (int qi = 0; qi < QTILE; ++qi) {
          float4 x = q_s[qi * d4 + c];
          acc[qi] = fmaf(v.x, x.x, acc[qi]);
          acc[qi] = fmaf(v.y, x.y, acc[qi]);
          acc[qi] = fmaf(v.z, x.z, acc[qi]);
          acc[qi] = fmaf(v.w, x.w, acc[qi]);
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QTILE; ++qi) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[qi] += __shfl_xor_sync(0xffffffffu, acc[qi], off);
    }
    if (lane < QTILE) {
      float s = 0.f;
#pragma unroll
      for (int qi = 0; qi < QTILE; ++qi)
        if (qi == lane) s = acc[qi];
      const int qg = q0 + lane;
      if (col >= cap) {
        s = -CUDART_INF_F;                        // empty: below masked
      } else {
        bool ok = valid[(size_t)node * cap + col] != 0;
        if (MASK_NODES) ok = ok && qg < n_q && node_ids[qg] == node;
        if (!ok) s = MASKED;
      }
      score_s[lane][r] = s;
    }
  }
  __syncthreads();

  // chunk top-k: one warp per query, two candidates per lane
  for (int qi = warp; qi < QTILE; qi += WARPS) {
    const int qg = q0 + qi;
    if (qg >= n_q) continue;
    float cs[2];
    int ci[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = lane + 32 * j;
      const int col = chunk * ROWS + r;
      cs[j] = score_s[qi][r];
      ci[j] = col < cap ? node * cap + col : EMPTY_SLOT;
    }
    const size_t base = (((size_t)pn * n_chunks + chunk) * n_q + qg) * k;
    for (int kk = 0; kk < k; ++kk) {
      const int pick = better(cs[0], ci[0], cs[1], ci[1]) ? 0 : 1;
      float s = cs[pick];
      int i = ci[pick];
      int owner = lane * 2 + pick;
      warp_best(s, i, owner);
      if (owner / 2 == lane) {                    // the winner drops out
        cs[owner % 2] = -CUDART_INF_F;
        ci[owner % 2] = EMPTY_SLOT;
      }
      if (lane == 0) {
        part_s[base + kk] = s;
        part_i[base + kk] = i;
      }
    }
  }
}

template <bool PER_NODE>
__global__ void __launch_bounds__(THREADS)
merge_lists(const float* __restrict__ part_s, const int* __restrict__ part_i,
            float* __restrict__ out_s, int* __restrict__ out_i, int n_planes,
            int n_nodes, int n_q, int k, int n_chunks) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int list = blockIdx.x * WARPS + warp;
  // PER_NODE: list = (plane * n_nodes + node) * n_q + q; else plane * n_q + q
  const int n_lists = (PER_NODE ? n_planes * n_nodes : n_planes) * n_q;
  if (list >= n_lists) return;
  const int q = list % n_q;
  const int group = list / n_q;                   // pn, or the plane
  const int first_pn = PER_NODE ? group : group * n_nodes;
  const int n_pn = PER_NODE ? 1 : n_nodes;
  const int per_pn = n_chunks * k;                // candidates of one (p, n)
  const int m = n_pn * per_pn;

  float last_s = CUDART_INF_F;                    // nothing taken yet
  int last_i = -1;
  for (int kk = 0; kk < k; ++kk) {
    float s = -CUDART_INF_F;
    int i = EMPTY_SLOT;
    for (int j = lane; j < m; j += 32) {
      const int pn = first_pn + j / per_pn;
      const int chunk = (j % per_pn) / k;
      const size_t at =
          (((size_t)pn * n_chunks + chunk) * n_q + q) * k + (j % k);
      const float cs = part_s[at];
      const int ci = part_i[at];
      if (better(last_s, last_i, cs, ci) && better(cs, ci, s, i)) {
        s = cs;
        i = ci;
      }
    }
    int owner = 0;
    warp_best(s, i, owner);
    if (lane == 0) {
      out_s[(size_t)list * k + kk] = s;
      out_i[(size_t)list * k + kk] = i;
    }
    last_s = s;
    last_i = i;
  }
}

template <bool PER_NODE, bool MASK_NODES>
int launch(const float* q, const float* slabs, const uint8_t* valid,
           const int* node_ids, float* part_s, int* part_i, float* out_s,
           int* out_i, int n_planes, int n_nodes, int cap, int dim, int n_q,
           int k, cudaStream_t stream) {
  const int n_chunks = (cap + ROWS - 1) / ROWS;
  const size_t smem = (size_t)QTILE * dim * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_chunks<MASK_NODES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid1(n_chunks, n_planes * n_nodes, (n_q + QTILE - 1) / QTILE);
  scan_chunks<MASK_NODES><<<grid1, THREADS, smem, stream>>>(
      q, slabs, valid, node_ids, part_s, part_i, n_nodes, cap, dim, n_q, k,
      n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_lists = (PER_NODE ? n_planes * n_nodes : n_planes) * n_q;
  merge_lists<PER_NODE><<<(n_lists + WARPS - 1) / WARPS, THREADS, 0,
                          stream>>>(part_s, part_i, out_s, out_i, n_planes,
                                    n_nodes, n_q, k, n_chunks);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Clustered per-node scan (K1)
// ---------------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;
constexpr int PN_WARPS = 8;
constexpr int PN_THREADS = PN_WARPS * 32;
constexpr int TILE = 32;                        // rows a tile: one a lane
constexpr int TILE_ROWS_PER_WARP = TILE / PN_WARPS;
constexpr int PN_MAX_CLUSTER = 8;            // the portable cluster size
constexpr int PN_MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;              // a block's shared memory

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n committed groups are still in flight (n <= 3)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// lanes l and l ^ stride swap (score, slot) so that the lane with
// keep_better holds the better of the two
__device__ __forceinline__ void cmpx(float& s, int& i, int stride,
                                     bool keep_better) {
  const float ps = __shfl_xor_sync(FULL, s, stride);
  const int pi = __shfl_xor_sync(FULL, i, stride);
  if (keep_better ? better(ps, pi, s, i) : better(s, i, ps, pi)) {
    s = ps;
    i = pi;
  }
}

// bitonic sort of the warp's 32 pairs: lane r ends with rank r
__device__ __forceinline__ void warp_sort(float& s, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      cmpx(s, i, stride, ((lane & stride) == 0) == ((lane & size) == 0));
  }
}

// (ls, li) and (cs, ci) each sorted across the warp (lane r rank r):
// (ls, li) becomes the best 32 of the two, sorted
__device__ __forceinline__ void warp_merge(float& ls, int& li, float cs,
                                           int ci, int lane) {
  const float rs = __shfl_sync(FULL, cs, 31 - lane);
  const int ri = __shfl_sync(FULL, ci, 31 - lane);
  if (better(rs, ri, ls, li)) {                 // bitonic split: top half
    ls = rs;
    li = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    cmpx(ls, li, stride, (lane & stride) == 0);
}

// Sum each of a lane's N values over the warp.  While a lane holds more
// than one value, lanes l and l ^ OFF each keep half and add the other's
// copy of it; then a plain butterfly.  Value v of the N0 ends in a[v % NL]
// of the lanes with lane >> (5 - M) == v / NL (M levels halve, NL = N0 >>
// M), summed in the butterfly's tree.
template <int N, int OFF, int N0>
struct XSum {
  static __device__ __forceinline__ void run(float (&a)[N0], int lane) {
    if constexpr (OFF > 0) {
      if constexpr (N > 1) {
        constexpr int H = N / 2;
        const bool upper = (lane & OFF) != 0;
#pragma unroll
        for (int j = 0; j < H; ++j) {
          const float send = upper ? a[j] : a[j + H];
          const float keep = upper ? a[j + H] : a[j];
          a[j] = keep + __shfl_xor_sync(FULL, send, OFF);
        }
        XSum<H, OFF / 2, N0>::run(a, lane);
      } else {
        a[0] += __shfl_xor_sync(FULL, a[0], OFF);
        XSum<1, OFF / 2, N0>::run(a, lane);
      }
    }
  }
};

__host__ __device__ constexpr int log2_floor(int v) {
  return v <= 1 ? 0 : 1 + log2_floor(v / 2);
}

template <int QT>
__global__ void __launch_bounds__(PN_THREADS)
pernode_fused(const float* __restrict__ q, const float* __restrict__ slabs,
              const uint8_t* __restrict__ valid, float* __restrict__ out_s,
              int* __restrict__ out_i, int n_nodes, int cap, int dim,
              int n_q, int k, int chunk, int stages) {
  constexpr int V = TILE_ROWS_PER_WARP * QT;    // sums a lane forms a tile
  constexpr int M = log2_floor(V) < 5 ? log2_floor(V) : 5;
  constexpr int NL = V >> M;                    // sums a lane ends with
  constexpr int JQ = (QT + PN_WARPS - 1) / PN_WARPS;   // lists a warp keeps

  extern __shared__ float4 smem4[];
  const int d4 = dim >> 2;
  float4* q_s = smem4;                                     // (QT, d4)
  float4* ring = q_s + QT * d4;                            // (stages, TILE, d4)
  float* sc_s = reinterpret_cast<float*>(ring + (size_t)stages * TILE * d4);
  float* lst_s = sc_s + QT * TILE;                         // (QT, MAX_K)
  int* lst_i = reinterpret_cast<int*>(lst_s + QT * MAX_K);
  float* tr_s = reinterpret_cast<float*>(lst_i + QT * MAX_K);  // (8, 32)
  int* tr_i = reinterpret_cast<int*>(tr_s + PN_WARPS * 32);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int pn = blockIdx.y;                     // plane * n_nodes + node
  const int node = pn % n_nodes;
  const int q0 = blockIdx.z * QT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = min(rank * chunk, cap);
  const int r1 = min(r0 + chunk, cap);
  const int n_tiles = (r1 - r0 + TILE - 1) / TILE;
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* slab4 = reinterpret_cast<const float4*>(slabs) +
                        (size_t)pn * cap * d4;

  // group 0: the query tile (zeros past n_q) and tile 0; group s: tile s
  for (int e = threadIdx.x; e < QT * d4; e += PN_THREADS) {
    const int qi = e / d4;
    if (q0 + qi < n_q)
      cp_async16(q_s + e, q4 + (size_t)q0 * d4 + e);
    else
      q_s[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int st = 0; st < stages; ++st) {
    if (st < n_tiles) {
      const int a = r0 + st * TILE;
      const int n = (min(a + TILE, r1) - a) * d4;
      float4* dst = ring + (size_t)st * TILE * d4;
      for (int e = threadIdx.x; e < n; e += PN_THREADS)
        cp_async16(dst + e, slab4 + (size_t)a * d4 + e);
    }
    cp_async_commit();
  }

  float ls[JQ];                          // running top-32, lane r rank r
  int li[JQ];
#pragma unroll
  for (int j = 0; j < JQ; ++j) {
    ls[j] = -CUDART_INF_F;
    li[j] = EMPTY_SLOT;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int a = r0 + t * TILE;
    // row a + lane: 0 masked, 1 valid, 2 not this block's
    const int flag = a + lane < r1
                         ? (valid[(size_t)node * cap + a + lane] ? 1 : 0)
                         : 2;
    cp_async_wait(stages - 1);
    __syncthreads();

    // scores of rows a + 4*warp .. +3 against the QT queries
    const float4* tile = ring + (size_t)(t % stages) * TILE * d4;
    const float4* rows = tile + (size_t)warp * TILE_ROWS_PER_WARP * d4;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int c = lane; c < d4; c += 32) {
      float4 rv[TILE_ROWS_PER_WARP];
#pragma unroll
      for (int r = 0; r < TILE_ROWS_PER_WARP; ++r) rv[r] = rows[r * d4 + c];
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
        const float4 x = q_s[qi * d4 + c];
#pragma unroll
        for (int r = 0; r < TILE_ROWS_PER_WARP; ++r) {
          float& s = acc[r * QT + qi];
          s = fmaf(rv[r].x, x.x, s);
          s = fmaf(rv[r].y, x.y, s);
          s = fmaf(rv[r].z, x.z, s);
          s = fmaf(rv[r].w, x.w, s);
        }
      }
    }
    XSum<V, 16, V>::run(acc, lane);
    const bool writer = (lane & ((1 << (5 - M)) - 1)) == 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int v = (lane >> (5 - M)) * NL + j;
      const int r = warp * TILE_ROWS_PER_WARP + v / QT;
      const int f = __shfl_sync(FULL, flag, r);
      if (writer)
        sc_s[(v % QT) * TILE + r] =
            f == 2 ? -CUDART_INF_F : (f == 0 ? MASKED : acc[j]);
    }
    __syncthreads();

    // the stage is free: copy tile t + stages into it
    if (t + stages < n_tiles) {
      const int b = r0 + (t + stages) * TILE;
      const int n = (min(b + TILE, r1) - b) * d4;
      float4* dst = ring + (size_t)(t % stages) * TILE * d4;
      for (int e = threadIdx.x; e < n; e += PN_THREADS)
        cp_async16(dst + e, slab4 + (size_t)b * d4 + e);
    }
    cp_async_commit();

    // each warp takes the tile's candidates into its queries' lists
#pragma unroll
    for (int j = 0; j < JQ; ++j) {
      const int qi = warp + PN_WARPS * j;
      if (qi < QT && q0 + qi < n_q) {
        float cs = sc_s[qi * TILE + lane];
        int ci = a + lane < r1 ? node * cap + a + lane : EMPTY_SLOT;
        const float ws = __shfl_sync(FULL, ls[j], k - 1);
        const int wi = __shfl_sync(FULL, li[j], k - 1);
        if (__any_sync(FULL, better(cs, ci, ws, wi))) {
          warp_sort(cs, ci, lane);
          if (t == 0) {                   // the list is empty
            ls[j] = cs;
            li[j] = ci;
          } else {
            warp_merge(ls[j], li[j], cs, ci, lane);
          }
        }
      }
    }
  }

  cp_async_wait(0);               // a block without rows still has copies
  // the block's top-k of each query -> shared memory, for the cluster
#pragma unroll
  for (int j = 0; j < JQ; ++j) {
    const int qi = warp + PN_WARPS * j;
    if (qi < QT && lane < k) {
      lst_s[qi * MAX_K + lane] = ls[j];
      lst_i[qi * MAX_K + lane] = li[j];
    }
  }
  cluster.sync();

  // block (qi mod cl) takes query qi: its warps merge the cl lists in a
  // binary tree (warp w of the first level merges ranks 2w and 2w + 1,
  // read through distributed shared memory), level by level in tr_s
  for (int qi = rank; qi < QT && q0 + qi < n_q; qi += cl) {
    int m = cl;                                   // lists at this level
    for (int level = 0; m > 1 || level == 0; ++level) {
      const int w = warp;
      const bool busy = w < (m + 1) / 2;
      float s = -CUDART_INF_F, cs = -CUDART_INF_F;
      int i = EMPTY_SLOT, ci = EMPTY_SLOT;
      if (busy) {
        if (level == 0) {
          if (lane < k) {
            const int at = qi * MAX_K + lane;
            s = cluster.map_shared_rank(lst_s, 2 * w)[at];
            i = cluster.map_shared_rank(lst_i, 2 * w)[at];
            if (2 * w + 1 < m) {
              cs = cluster.map_shared_rank(lst_s, 2 * w + 1)[at];
              ci = cluster.map_shared_rank(lst_i, 2 * w + 1)[at];
            }
          }
        } else {
          s = tr_s[2 * w * 32 + lane];
          i = tr_i[2 * w * 32 + lane];
          if (2 * w + 1 < m) {
            cs = tr_s[(2 * w + 1) * 32 + lane];
            ci = tr_i[(2 * w + 1) * 32 + lane];
          }
        }
        if (2 * w + 1 < m) warp_merge(s, i, cs, ci, lane);
      }
      __syncthreads();                            // level read, then written
      if (busy) {
        tr_s[w * 32 + lane] = s;
        tr_i[w * 32 + lane] = i;
      }
      __syncthreads();
      m = (m + 1) / 2;
    }
    if (warp == 0 && lane < k) {
      const size_t at = ((size_t)pn * n_q + q0 + qi) * k + lane;
      out_s[at] = tr_s[lane];
      out_i[at] = tr_i[lane];
    }
    __syncthreads();                              // tr_s free again
  }
  cluster.sync();                 // keep the lists alive for the readers
}

size_t pernode_smem(int qt, int dim, int stages) {
  return (size_t)4 * (qt * dim + (size_t)stages * TILE * dim + qt * TILE +
                      2 * qt * MAX_K + 2 * PN_WARPS * 32);
}

cudaLaunchConfig_t pernode_config(int cl, int pn, int n_qtiles, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, pn, n_qtiles);
  cfg.blockDim = dim3(PN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicySpread;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

// `smem` bytes of dynamic shared memory for pernode_fused<QT> (the
// attribute only ever grows)
template <int QT>
cudaError_t pernode_allow(size_t smem) {
  static size_t allowed = 0;
  cudaError_t e = cudaSuccess;
  if (smem > allowed) {
    e = cudaFuncSetAttribute(pernode_fused<QT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) allowed = smem;
  }
  return e;
}

template <int QT>
int pernode_launch(const float* q, const float* slabs, const uint8_t* valid,
                   float* out_s, int* out_i, int n_planes, int n_nodes,
                   int cap, int dim, int n_q, int k, int cl, int chunk,
                   int stages, cudaStream_t stream) {
  const size_t smem = pernode_smem(QT, dim, stages);
  cudaError_t e = pernode_allow<QT>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = pernode_config(
      cl, n_planes * n_nodes, (n_q + QT - 1) / QT, smem, stream, attr);
  e = cudaLaunchKernelEx(&cfg, pernode_fused<QT>, q, slabs, valid, out_s,
                         out_i, n_nodes, cap, dim, n_q, k, chunk, stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch lists: part_s / part_i of n_planes * n_nodes * vdb_topk_chunks(cap)
// * n_q * k elements each.  Returns cudaGetLastError() after the launches.
int vdb_topk_chunks(int cap) { return (cap + ROWS - 1) / ROWS; }

int vdb_topk_max_k() { return MAX_K; }

int vdb_topk_launch(const float* q, const float* slabs, const uint8_t* valid,
                    const int* node_ids, float* part_s, int* part_i,
                    float* out_s, int* out_i, int n_planes, int n_nodes,
                    int cap, int dim, int n_q, int k, int per_node,
                    int mask_nodes, cudaStream_t stream) {
  if (per_node)
    return launch<true, false>(q, slabs, valid, node_ids, part_s, part_i,
                               out_s, out_i, n_planes, n_nodes, cap, dim, n_q,
                               k, stream);
  if (mask_nodes)
    return launch<false, true>(q, slabs, valid, node_ids, part_s, part_i,
                               out_s, out_i, n_planes, n_nodes, cap, dim, n_q,
                               k, stream);
  return launch<false, false>(q, slabs, valid, node_ids, part_s, part_i,
                              out_s, out_i, n_planes, n_nodes, cap, dim, n_q,
                              k, stream);
}

// Single-slab scan (K3): db (n, dim) and valid (n,) are one plane of one
// node, so the scratch lists hold vdb_topk_chunks(n) * n_q * k entries and
// the outputs are (n_q, k) with row ids in [0, n).  No node mask.
int vdb_topk_single_launch(const float* q, const float* db,
                           const uint8_t* valid, float* part_s, int* part_i,
                           float* out_s, int* out_i, int n, int dim, int n_q,
                           int k, cudaStream_t stream) {
  return launch<true, false>(q, db, valid, nullptr, part_s, part_i, out_s,
                             out_i, 1, 1, n, dim, n_q, k, stream);
}

// Clustered per-node scan (K1): outputs (n_planes, n_nodes, n_q, k).  The
// plan comes from the caller (kernels/vdb_topk.py::pernode_plan): qt
// queries a tile (1, 2, 4, 8 or 16), cl blocks a cluster (1-8), chunk
// capacity rows a block (cl * chunk >= cap), stages tiles of 32 rows in
// flight (1-4).  One launch; returns its cudaGetLastError(), or
// cudaErrorInvalidValue for a plan or shape it does not take.
int vdb_topk_pernode_launch(const float* q, const float* slabs,
                            const uint8_t* valid, float* out_s, int* out_i,
                            int n_planes, int n_nodes, int cap, int dim,
                            int n_q, int k, int qt, int cl, int chunk,
                            int stages, cudaStream_t stream) {
  if (dim <= 0 || dim % 4 || k < 1 || k > MAX_K || k > cap || n_q < 1 ||
      cl < 1 || cl > PN_MAX_CLUSTER || (long long)cl * chunk < cap ||
      stages < 1 || stages > PN_MAX_STAGES || n_planes * n_nodes > 65535 ||
      pernode_smem(qt, dim, stages) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  switch (qt) {
#define QT_CASE(N)                                                          \
  case N:                                                                   \
    return pernode_launch<N>(q, slabs, valid, out_s, out_i, n_planes,       \
                             n_nodes, cap, dim, n_q, k, cl, chunk, stages, \
                             stream);
    QT_CASE(1) QT_CASE(2) QT_CASE(4) QT_CASE(8) QT_CASE(16)
#undef QT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
