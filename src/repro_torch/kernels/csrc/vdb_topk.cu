// Cosine scan with streaming top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bodies `_vdb_sharded_kernel` and
// `_vdb_kernel` of repro/kernels/vdb_topk.py, behind their three entry
// points:
//   PER_NODE = true   -> vdb_topk_pernode  (top-k of every node, per query)
//   PER_NODE = false  -> vdb_topk_sharded  (one top-k per plane across all
//                        nodes; MASK_NODES restricts query q to the slab of
//                        node node_ids[q])
//   vdb_topk_single_launch -> vdb_topk (one slab, one index): the per-node
//                        scan of one plane and one node, whose global slot
//                        ids are then the db's row ids
//
// Inputs: queries (Q, D) f32; slabs (P, N, cap, D) f32; valid (N, cap)
// bool; node_ids (Q,) int32.  Outputs: scores and GLOBAL slot ids
// (node * cap + col), (P, N, Q, k) per node or (P, Q, k) global.
//
// Order: every candidate (masked ones included) is ranked by score
// descending, then by global slot ascending.  That is a strict total
// order, so the result is exactly what a stable descending sort of all
// candidates gives (the plain version's rule, and jax.lax.top_k's).
// Masked candidates carry the -1e30 sentinel and rank below every real
// score; the host drops them before they can become hits.
//
// The TPU kernel walks (plane, node, block) in order on one core and
// carries the running top-k in VMEM.  Blocks on the GPU run in no order,
// so the work is split in two passes:
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
// Bound on the card: the slab bytes (P*N*cap*D*4 read once), i.e. memory.
// The dot products are 2*Q*P*N*cap*D operations, far below the f32 rate.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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

}  // extern "C"
