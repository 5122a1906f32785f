// CPU data-plane collectives over the TCP full mesh.
//
// Capability parity with the reference's CPU op backends (MPI/Gloo ops,
// ops/mpi_operations.cc, ops/gloo_operations.cc): ring allreduce
// (reduce-scatter + allgather, the bandwidth-optimal schedule NCCL uses),
// chain broadcast, ring allgatherv, pairwise alltoallv; dtype-dispatched
// reduction kernels incl. fp16/bf16 with fp32 accumulation
// (reference half.cc), Adasum (gather + coefficient tree, ops/adasum/).
#pragma once

#include <cstdint>
#include <functional>
#include <vector>

#include "common.h"
#include "net.h"

namespace hvdtpu {

// In-place allreduce of buf (count elements of dtype) across all ranks.
// ``restore`` (optional): rewinds buf to its pre-collective contents for
// a renegotiated retry — when the caller can re-pack from still-intact
// inputs (the runtime's fusion path), the resilient wrapper skips its
// internal pre-collective snapshot copy entirely.
Status RingAllreduce(Network& net, void* buf, int64_t count, DataType dtype,
                     ReduceOp op,
                     const std::function<void()>* restore = nullptr);

// Ring allreduce restricted to `members` (sorted rank list containing the
// caller) — building block for hierarchical schedules.
Status RingAllreduceGroup(Network& net, void* buf, int64_t count,
                          DataType dtype, ReduceOp op,
                          const std::vector<int>& members);

// Hierarchical allreduce (reference NCCLHierarchicalAllreduce,
// nccl_operations.cc:186-260 / MPIHierarchicalAllgather shape): ranks are
// grouped into nodes of `local_size` consecutive ranks; phase 1 reduces
// within the node, phase 2 ring-reduces across node leaders, phase 3
// broadcasts within the node.  On TPU pods the analogous grouping is
// intra-slice (ICI) vs inter-slice (DCN).  Falls back to the flat ring when
// the topology doesn't divide evenly.
Status HierarchicalAllreduce(Network& net, void* buf, int64_t count,
                             DataType dtype, ReduceOp op, int local_size);

// buf holds this rank's my_bytes at offset offsets[rank]; fills the rest.
// offsets/bytes per rank; buf has total size sum(bytes).
Status RingAllgatherv(Network& net, uint8_t* buf,
                      const std::vector<int64_t>& bytes,
                      const std::vector<int64_t>& offsets);

// Hierarchical allgather (reference MPIHierarchicalAllgather,
// mpi_operations.cc:186-341: node-leader gather staged through shared
// memory, cross-node exchange, intra-node fan-out): phase 1 gathers node
// members' blocks to the node leader over intra-node hops (shm/CMA when
// available), phase 2 ring-allgathervs node-level blocks across leaders,
// phase 3 fans the full result down the intra-node chain, chunk-pipelined.
// Falls back to the flat ring when the topology doesn't divide evenly.
Status HierarchicalAllgatherv(Network& net, uint8_t* buf,
                              const std::vector<int64_t>& bytes,
                              const std::vector<int64_t>& offsets,
                              int local_size);

// Test/observability hook: schedule used by the most recent allgather on
// this process (0 = flat ring, 1 = hierarchical with chain
// fan-out, 2 = hierarchical with CMA star fan-out).
int LastAllgatherSchedule();
// Schedule of the most recent allreduce/Adasum on this process (0 =
// flat ring / flat VHDD, 1 = hierarchical) — the allreduce analog of
// the allgather hook above; stored only for schedules that COMPLETED.
int LastAllreduceSchedule();
// Most recent hierarchical allreduce/Adasum fan-out and most recent
// broadcast schedule (0 = flat/none, 1 = chain, 2 = zero-copy CMA star).
int LastAllreduceFanout();
int LastBroadcastSchedule();

// In-place broadcast of buf from root (chain schedule).
Status ChainBroadcast(Network& net, void* buf, int64_t nbytes, int root);

// Cross-rank status agreement: *ok in/out (1 = this rank OK); after the
// call *ok is the AND over all ranks and *first_bad_rank the lowest rank
// that reported failure (-1 when unanimous OK).  Star exchange over the
// mesh sockets; callers must invoke it at the same point of the same
// response schedule on every rank (the runtime does, in coordinator
// response order).  The TPU-side analog of the reference's NCCL
// async-error agreement (nccl_operations.cc:96-109).
Status AgreeAllRanks(Network& net, int32_t* ok, int32_t* first_bad_rank);

// send: concatenated segments for each destination (send_bytes[d] each);
// recv: filled with segments from each source (recv_bytes[s] each).
Status PairwiseAlltoallv(Network& net, const uint8_t* send,
                         const std::vector<int64_t>& send_bytes,
                         uint8_t* recv,
                         const std::vector<int64_t>& recv_bytes);

// Adasum allreduce: chunked pairwise vector-halving distance-doubling with
// grouped scalar reductions for the adaptive coefficients (reference
// adasum.h:168-395, adasum_mpi.cc:107-110; same numerics as ops/adasum.py).
// O(|t|) scratch on power-of-two worlds; gather + coefficient tree fallback
// otherwise.  fp16/bf16 accepted with fp32 accumulation.
Status AdasumAllreduce(Network& net, void* buf, int64_t count,
                       DataType dtype);

// Hierarchical Adasum (reference adasum_gpu_operations.cc:38-…): intra-node
// sum, cross-node VHDD between node leaders, local-average fold-in,
// intra-node fan-out.  Falls back to flat Adasum when the topology doesn't
// divide evenly or the node count is not a power of two.
Status HierarchicalAdasum(Network& net, void* buf, int64_t count,
                          DataType dtype, int local_size);

// Test/observability hooks: peak scratch bytes allocated by the VHDD path
// since the last reset (proves the O(|t|) memory bound).
int64_t AdasumScratchPeak();
void ResetAdasumScratchPeak();

// Elementwise scale in place (used for prescale/postscale/average).
// Integer dtypes truncate toward zero (double multiply + C cast).
void ScaleBuffer(void* buf, int64_t count, DataType dtype, double factor);

// Integer Average: exact floor-divide in the integer domain, matching the
// compiled path's contract (ops/collective.py _compiled_allreduce — float
// widening cannot promise exactness, and truncation disagrees with floor
// for negative sums).  No-op for non-integer dtypes.  Returns true if it
// handled the dtype.
bool FloorAverageInt(void* buf, int64_t count, DataType dtype,
                     int64_t divisor);

}  // namespace hvdtpu
