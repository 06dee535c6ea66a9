// Cosine scan with streaming top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bodies `_vdb_sharded_kernel` and
// `_vdb_kernel` of repro/kernels/vdb_topk.py.  One clustered scan,
// `scan_fused`, stands behind the three entry points:
//   vdb_topk_pernode_launch -> vdb_topk_pernode (K1): the top-k of every
//                        node, per query (mode PER_NODE)
//   vdb_topk_sharded_launch -> vdb_topk_sharded (K2): one top-k per plane.
//                        mask_nodes: query q sees only the slab of node
//                        node_ids[q] (mode MASKED_NODES); else every
//                        node (mode GLOBAL)
//   vdb_topk_single_launch  -> vdb_topk (K3): one slab of one index, i.e.
//                        PER_NODE with one plane and one node, whose global
//                        slot ids are then the db's row ids; a db of more
//                        rows than one cluster streams fast (the caller's
//                        plan: 512) is cut into nodes of that many rows
//                        and merged as GLOBAL merges nodes
// Each call is one launch and keeps no candidate list in device memory,
// except the node lists of a GLOBAL merge (below).
//
// Inputs: queries (Q, D) f32; slabs (P, N, cap, D) f32; valid (N, cap)
// bool; node_ids (Q,) int32.  Outputs: scores and GLOBAL slot ids
// (node * cap + col), (P, N, Q, k) per node or (P, Q, k) per plane.
//
// Order: every candidate (masked ones included) is ranked by score
// descending, then by global slot ascending.  That is a strict total
// order, so the result is exactly what a stable descending sort of all
// candidates gives (the plain version's rule, and jax.lax.top_k's), and
// it does not depend on the order in which lists are merged.  Masked
// candidates carry the -1e30 sentinel and rank below every real score;
// the host drops them before they can become hits.
//
// A score is the same bits in every mode: lane l sums the products of the
// float4 columns l, l + 32, .. in order (fmaf, x y z w), then a fixed
// butterfly over the lanes (16, 8, 4, 2, 1).
//
// Bound on the card: the slab bytes (P*N*cap*D*4, read once per tile of
// queries), i.e. memory; MASKED_NODES needs only the slabs of the nodes
// its queries name.  The dot products are 2*Q*P*N*cap*D operations, far
// below the f32 rate.  At the serving shapes a call is latency bound: a
// few microseconds of copies, barriers and merges against a 2 us (K1, K2)
// or 0.25 us (K3) bound.
//
// The scan (`scan_fused`):
//   * One thread-block cluster per (plane, node, tile of QT queries); QT is
//     the micro-batch rounded up to 1, 2, 4, 8 or 16.  The cluster's CL
//     blocks split the node's capacity rows into contiguous chunks (the
//     launcher's plan: at least 32 rows a block, at most 8 blocks, the
//     portable cluster size; an H100 holds 15 clusters of 8 at once), so
//     4 nodes x 2 planes take 64 SMs where one block per (plane, node)
//     would take 8, and a larger capacity only lengthens each block's loop.
//   * MASKED_NODES: the blocks read node_ids of their tile and keep the
//     queries of their node, compacted; a cluster whose node no query
//     names exits before it copies a byte, so a call reads only the named
//     nodes' slabs.
//   * A block streams its chunk in tiles of 32 rows through a ring of up
//     to 4 stages of shared memory, every stage's 16-byte cp.async copies
//     in flight at once (the whole chunk at the serving shapes).  Each warp
//     forms the dot products of 4 rows with the tile's queries, and a
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
//     pairs' results, ..).  A second cluster barrier keeps the lists alive
//     until every reader is done.
//   * MASKED_NODES fill: the plain version ranks a query's masked
//     candidates by global slot across the whole plane, other nodes' slots
//     included.  The node's own masked rows come through the scan; the
//     other nodes' first k slots in ascending order (0, 1, .. below the
//     node, then past it) are a list the block writes without reading a
//     row, merged into the node's list before the output.  A query whose
//     node id lies outside [0, N) has no candidate but masked ones: slots
//     0..k-1, which node 0's cluster writes.  Every output list has
//     exactly one writer.
//   * GLOBAL: the per-(plane, node) clusters write their node lists to a
//     (P, N, Q, k) buffer; block r of every node's cluster then takes a
//     ticket (an atomic counter per plane, query tile and rank, after a
//     __threadfence), and the last of the N merges the N lists of its
//     queries from L2 in the same tree and writes the output.  The last
//     one resets the counter, so every launch starts from zero.  The order
//     is strict, so which cluster comes last does not change a bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_K = 32;
constexpr float MASKED = -1e30f;         // masked-candidate sentinel
constexpr int EMPTY_SLOT = 0x7fffffff;   // past the end of a slab
constexpr int TILE = 32;                 // rows a tile: one a lane
constexpr int TILE_ROWS_PER_WARP = TILE / WARPS;
constexpr int MAX_CLUSTER = 8;           // the portable cluster size
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;       // a block's shared memory
constexpr int MAX_TREE = 2 * WARPS;      // lists the tree's first level takes
constexpr int MAX_DEVICES = 64;          // cards whose settings are kept

enum Mode { PER_NODE = 0, MASKED_NODES = 1, GLOBAL = 2 };

// strict total order: higher score first, then lower global slot
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

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

// position of the n-th (from 0) set bit of m
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int j = 0; j < n; ++j) m &= m - 1;
  return __ffs(m) - 1;
}

// The block's warps merge m <= MAX_TREE sorted lists into tr_s[0..32) /
// tr_i in a binary tree: at the first level warp w merges lists 2w and
// 2w + 1, which load(j, s, i) gives it (lane r rank r), then the pairs'
// results, level by level in tr_s / tr_i (WARPS rows of 32).  Every
// thread of the block calls it.
template <typename Load>
__device__ __forceinline__ void tree_merge(int m, float* tr_s, int* tr_i,
                                           int warp, int lane, Load load) {
  for (int level = 0; m > 1 || level == 0; ++level) {
    const bool busy = warp < (m + 1) / 2;
    float s = -CUDART_INF_F, cs = -CUDART_INF_F;
    int i = EMPTY_SLOT, ci = EMPTY_SLOT;
    if (busy) {
      if (level == 0) {
        load(2 * warp, s, i);
        if (2 * warp + 1 < m) load(2 * warp + 1, cs, ci);
      } else {
        s = tr_s[2 * warp * 32 + lane];
        i = tr_i[2 * warp * 32 + lane];
        if (2 * warp + 1 < m) {
          cs = tr_s[(2 * warp + 1) * 32 + lane];
          ci = tr_i[(2 * warp + 1) * 32 + lane];
        }
      }
      if (2 * warp + 1 < m) warp_merge(s, i, cs, ci, lane);
    }
    __syncthreads();                              // level read, then written
    if (busy) {
      tr_s[warp * 32 + lane] = s;
      tr_i[warp * 32 + lane] = i;
    }
    __syncthreads();
    m = (m + 1) / 2;
  }
}

template <int QT, int MODE>
__global__ void __launch_bounds__(THREADS)
scan_fused(const float* __restrict__ q, const float* __restrict__ slabs,
           const uint8_t* __restrict__ valid,
           const int* __restrict__ node_ids, float* __restrict__ out_s,
           int* __restrict__ out_i, float* __restrict__ lists_s,
           int* __restrict__ lists_i, unsigned* __restrict__ tickets,
           int n_nodes, int cap, int n_rows, int dim, int n_q, int k,
           int chunk, int stages) {
  constexpr int V = TILE_ROWS_PER_WARP * QT;    // sums a lane forms a tile
  constexpr int M = log2_floor(V) < 5 ? log2_floor(V) : 5;
  constexpr int NL = V >> M;                    // sums a lane ends with
  constexpr int JQ = (QT + WARPS - 1) / WARPS;  // lists a warp keeps

  extern __shared__ float4 smem4[];
  const int d4 = dim >> 2;
  float4* q_s = smem4;                                     // (QT, d4)
  float4* ring = q_s + QT * d4;                            // (stages, TILE, d4)
  float* sc_s = reinterpret_cast<float*>(ring + (size_t)stages * TILE * d4);
  float* lst_s = sc_s + QT * TILE;                         // (QT, MAX_K)
  int* lst_i = reinterpret_cast<int*>(lst_s + QT * MAX_K);
  float* tr_s = reinterpret_cast<float*>(lst_i + QT * MAX_K);  // (8, 32)
  int* tr_i = reinterpret_cast<int*>(tr_s + WARPS * 32);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int pn = blockIdx.y;                     // plane * n_nodes + node
  const int node = pn % n_nodes;
  const int plane = pn / n_nodes;
  const int q0 = blockIdx.z * QT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the tile's queries this cluster scans for: bit j = query q0 + j
  const int nq = min(QT, n_q - q0);
  unsigned mine = (1u << nq) - 1u;
  if constexpr (MODE == MASKED_NODES) {
    const int nid = lane < nq ? node_ids[q0 + lane] : 0;
    mine = __ballot_sync(FULL, lane < nq && nid == node);
    const unsigned stray =
        __ballot_sync(FULL, lane < nq && (nid < 0 || nid >= n_nodes));
    // a node id outside [0, N): every candidate is masked, so the list is
    // slots 0..k-1; node 0's cluster writes it
    if (node == 0 && rank == 0) {
      for (int j = warp; j < __popc(stray); j += WARPS) {
        const size_t at =
            ((size_t)plane * n_q + q0 + nth_bit(stray, j)) * k + lane;
        if (lane < k) {
          out_s[at] = MASKED;
          out_i[at] = lane;
        }
      }
    }
  }
  const int m = __popc(mine);                    // queries, compacted
  if (m == 0) return;                            // before any copy
  // rows of this node (the last node of a split K3 db may be short)
  const int node_rows = max(0, min(cap, n_rows - node * cap));
  const int r0 = min(rank * chunk, node_rows);
  const int r1 = min(r0 + chunk, node_rows);
  const int n_tiles = (r1 - r0 + TILE - 1) / TILE;
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* slab4 = reinterpret_cast<const float4*>(slabs) +
                        (size_t)pn * cap * d4;

  // group 0: the query tile (zeros past m) and tile 0; group s: tile s
  for (int e = threadIdx.x; e < QT * d4; e += THREADS) {
    const int qi = e / d4;
    if (qi >= m)
      q_s[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    else if constexpr (MODE == MASKED_NODES)
      cp_async16(q_s + e, q4 + (size_t)(q0 + nth_bit(mine, qi)) * d4 +
                              (e - qi * d4));
    else
      cp_async16(q_s + e, q4 + (size_t)q0 * d4 + e);
  }
  for (int st = 0; st < stages; ++st) {
    if (st < n_tiles) {
      const int a = r0 + st * TILE;
      const int n = (min(a + TILE, r1) - a) * d4;
      float4* dst = ring + (size_t)st * TILE * d4;
      for (int e = threadIdx.x; e < n; e += THREADS)
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

    // scores of rows a + 4*warp .. +3 against the QT queries; rows of q_s
    // past m are zeros.  Only MASKED_NODES, whose clusters mostly hold a
    // few of the tile's queries, skips them: the branch costs K1 a fifth
    // at QT = 8 (fewer loads in flight), and saves the masked scan as much
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
        if (MODE == MASKED_NODES && qi >= m) continue;
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
      for (int e = threadIdx.x; e < n; e += THREADS)
        cp_async16(dst + e, slab4 + (size_t)b * d4 + e);
    }
    cp_async_commit();

    // each warp takes the tile's candidates into its queries' lists
#pragma unroll
    for (int j = 0; j < JQ; ++j) {
      const int qi = warp + WARPS * j;
      if (qi < m) {
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
    const int qi = warp + WARPS * j;
    if (qi < QT && lane < k) {
      lst_s[qi * MAX_K + lane] = ls[j];
      lst_i[qi * MAX_K + lane] = li[j];
    }
  }
  cluster.sync();

  // block (qi mod cl) takes query qi: the tree over the cl blocks' lists,
  // read through distributed shared memory
  // (GLOBAL: the node list goes to the buffer, in PER_NODE's layout)
  float* dst_s = MODE == GLOBAL ? lists_s : out_s;
  int* dst_i = MODE == GLOBAL ? lists_i : out_i;
  for (int qi = rank; qi < m; qi += cl) {
    const int qg = q0 + (MODE == MASKED_NODES ? nth_bit(mine, qi) : qi);
    tree_merge(cl, tr_s, tr_i, warp, lane, [&](int b, float& s, int& i) {
      if (lane < k) {
        const int at = qi * MAX_K + lane;
        s = cluster.map_shared_rank(lst_s, b)[at];
        i = cluster.map_shared_rank(lst_i, b)[at];
      }
    });
    if (warp == 0) {
      float s = tr_s[lane];
      int i = tr_i[lane];
      size_t at = ((size_t)pn * n_q + qg) * k + lane;
      if constexpr (MODE == MASKED_NODES) {
        // the other nodes' slots in ascending order: lane r holds the
        // r-th of 0 .. node*cap - 1, (node+1)*cap .. N*cap - 1
        const int slot = lane < node * cap ? lane : lane + cap;
        const bool real = slot < n_rows;
        warp_merge(s, i, real ? MASKED : -CUDART_INF_F,
                   real ? slot : EMPTY_SLOT, lane);
        at = ((size_t)plane * n_q + qg) * k + lane;
      }
      if (lane < k) {
        dst_s[at] = s;
        dst_i[at] = i;
      }
    }
    __syncthreads();                              // tr_s free again
  }
  cluster.sync();                 // keep the lists alive for the readers

  if constexpr (MODE == GLOBAL) {
    // the last of the N node clusters' rank-`rank` blocks merges the N
    // lists of queries rank, rank + cl, ..
    __shared__ int last_s;
    if (rank >= m) return;
    __threadfence();              // this block's node lists, device-wide
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned* ticket =
          tickets + ((size_t)plane * gridDim.z + blockIdx.z) * cl + rank;
      const bool last = atomicAdd(ticket, 1u) == (unsigned)n_nodes - 1;
      if (last) atomicExch(ticket, 0u);          // the next launch's zero
      last_s = last;
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    for (int qi = rank; qi < m; qi += cl) {
      const int qg = q0 + qi;
      // list j of the tree: node j's list, then nodes j + 16, j + 32, ..
      tree_merge(min(n_nodes, MAX_TREE), tr_s, tr_i, warp, lane,
                 [&](int j, float& s, int& i) {
                   for (int nd = j; nd < n_nodes; nd += MAX_TREE) {
                     const size_t at =
                         (((size_t)plane * n_nodes + nd) * n_q + qg) * k +
                         lane;
                     const float cs =
                         lane < k ? __ldcg(lists_s + at) : -CUDART_INF_F;
                     const int ci = lane < k ? __ldcg(lists_i + at)
                                             : EMPTY_SLOT;
                     if (nd == j) {
                       s = cs;
                       i = ci;
                     } else {
                       warp_merge(s, i, cs, ci, lane);
                     }
                   }
                 });
      if (warp == 0 && lane < k) {
        const size_t at = ((size_t)plane * n_q + qg) * k + lane;
        out_s[at] = tr_s[lane];
        out_i[at] = tr_i[lane];
      }
      __syncthreads();
    }
  }
}

size_t scan_smem(int qt, int dim, int stages) {
  return (size_t)4 * (qt * dim + (size_t)stages * TILE * dim + qt * TILE +
                      2 * qt * MAX_K + 2 * WARPS * 32);
}

cudaLaunchConfig_t scan_config(int cl, int pn, int n_qtiles, size_t smem,
                               cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, pn, n_qtiles);
  cfg.blockDim = dim3(THREADS);
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

std::mutex allow_lock;

// `smem` bytes of dynamic shared memory for scan_fused<QT, MODE> on the
// current device.  A kernel attribute holds for one device only, so what
// was allowed is kept per device.  The attribute only ever grows; the
// lock keeps two threads from setting it in turn and shrinking it.
template <int QT, int MODE>
cudaError_t scan_allow(size_t smem) {
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(allow_lock);
  if (smem > allowed[dev]) {
    e = cudaFuncSetAttribute(scan_fused<QT, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) allowed[dev] = smem;
  }
  return e;
}

struct Args {
  const float* q;
  const float* slabs;
  const uint8_t* valid;
  const int* node_ids;
  float* out_s;
  int* out_i;
  float* lists_s;
  int* lists_i;
  unsigned* tickets;
  int n_planes, n_nodes, cap, n_rows, dim, n_q, k, cl, chunk, stages;
};

template <int QT, int MODE>
int scan_launch(const Args& a, cudaStream_t stream) {
  const size_t smem = scan_smem(QT, a.dim, a.stages);
  cudaError_t e = scan_allow<QT, MODE>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      scan_config(a.cl, a.n_planes * a.n_nodes, (a.n_q + QT - 1) / QT, smem,
                  stream, attr);
  e = cudaLaunchKernelEx(&cfg, scan_fused<QT, MODE>, a.q, a.slabs, a.valid,
                         a.node_ids, a.out_s, a.out_i, a.lists_s, a.lists_i,
                         a.tickets, a.n_nodes, a.cap, a.n_rows, a.dim, a.n_q,
                         a.k,
                         a.chunk, a.stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan (qt queries a tile: 1, 2, 4, 8 or 16; cl blocks a cluster,
// 1-8; chunk capacity rows a block, cl * chunk >= cap; stages tiles of 32
// rows in flight, 1-4) comes from the caller
// (kernels/vdb_topk.py::pernode_plan).
template <int MODE>
int scan(const Args& a, int qt, cudaStream_t stream) {
  if (a.dim <= 0 || a.dim % 4 || a.k < 1 || a.k > MAX_K || a.n_q < 1 ||
      a.k > (MODE == PER_NODE ? a.cap : a.n_rows) || a.n_rows < 1 ||
      a.n_rows > (long long)a.n_nodes * a.cap || a.cl < 1 ||
      a.cl > MAX_CLUSTER || (long long)a.cl * a.chunk < a.cap ||
      a.stages < 1 || a.stages > MAX_STAGES ||
      a.n_planes * a.n_nodes > 65535 || (a.n_q + qt - 1) / qt > 65535 ||
      scan_smem(qt, a.dim, a.stages) > (size_t)SMEM_LIMIT ||
      (MODE == GLOBAL && !a.tickets))
    return (int)cudaErrorInvalidValue;
  switch (qt) {
    case 1: return scan_launch<1, MODE>(a, stream);
    case 2: return scan_launch<2, MODE>(a, stream);
    case 4: return scan_launch<4, MODE>(a, stream);
    case 8: return scan_launch<8, MODE>(a, stream);
    case 16: return scan_launch<16, MODE>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int vdb_topk_max_k() { return MAX_K; }

// K1: outputs (n_planes, n_nodes, n_q, k).  One launch; returns its
// cudaGetLastError(), or cudaErrorInvalidValue for a plan or shape it does
// not take.
int vdb_topk_pernode_launch(const float* q, const float* slabs,
                            const uint8_t* valid, float* out_s, int* out_i,
                            int n_planes, int n_nodes, int cap, int dim,
                            int n_q, int k, int qt, int cl, int chunk,
                            int stages, cudaStream_t stream) {
  const Args a{q,        slabs,   valid,   nullptr,       out_s, out_i,
               nullptr,  nullptr, nullptr,                   // no lists
               n_planes, n_nodes, cap,     n_nodes * cap,    // rows
               dim,      n_q,     k,       cl,            chunk, stages};
  return scan<PER_NODE>(a, qt, stream);
}

// K2: outputs (n_planes, n_q, k).  mask_nodes: query q's list holds node
// node_ids[q]'s candidates (and the masked fill); else every node's.  The
// global mode needs lists_s / lists_i of n_planes * n_nodes * n_q * k
// elements and tickets of n_planes * ceil(n_q / qt) * cl zeros (left at
// zero by every launch); the masked mode reads none of them.
int vdb_topk_sharded_launch(const float* q, const float* slabs,
                            const uint8_t* valid, const int* node_ids,
                            float* out_s, int* out_i, float* lists_s,
                            int* lists_i, unsigned* tickets, int n_planes,
                            int n_nodes, int cap, int dim, int n_q, int k,
                            int mask_nodes, int qt, int cl, int chunk,
                            int stages, cudaStream_t stream) {
  const Args a{q,        slabs,   valid,   node_ids,      out_s, out_i,
               lists_s,  lists_i, tickets,
               n_planes, n_nodes, cap,     n_nodes * cap,    // rows
               dim,      n_q,     k,       cl,            chunk, stages};
  return mask_nodes ? scan<MASKED_NODES>(a, qt, stream)
                    : scan<GLOBAL>(a, qt, stream);
}

// K3: db (n, dim) and valid (n,) are one plane; outputs (n_q, k) with row
// ids in [0, n).  split = 1: one node of n rows (the per-node scan, no
// buffer); split = G > 1: G nodes of `seg` rows (the last one short),
// merged as the global scan merges nodes, with lists_s / lists_i of
// G * n_q * k elements and tickets of ceil(n_q / qt) * cl zeros.
int vdb_topk_single_launch(const float* q, const float* db,
                           const uint8_t* valid, float* out_s, int* out_i,
                           float* lists_s, int* lists_i, unsigned* tickets,
                           int n, int dim, int n_q, int k, int split,
                           int seg, int qt, int cl, int chunk, int stages,
                           cudaStream_t stream) {
  if (split == 1)
    return vdb_topk_pernode_launch(q, db, valid, out_s, out_i, 1, 1, n, dim,
                                   n_q, k, qt, cl, chunk, stages, stream);
  if (split < 1 || seg < 1 || (long long)(split - 1) * seg >= n ||
      (long long)split * seg < n)
    return (int)cudaErrorInvalidValue;
  const Args a{q,       db,      valid,   nullptr,       out_s, out_i,
               lists_s, lists_i, tickets,
               1,       split,   seg,     n,                 // rows
               dim,     n_q,     k,       cl,            chunk, stages};
  return scan<GLOBAL>(a, qt, stream);
}

}  // extern "C"
