// Lease-plane window kernels for Hopper (sm_90a): T ticks of the vectorized
// PaxosLease plane in one launch, one thread per cell.
//
// Replaces the TPU kernels of src/repro/lease_array/kernel.py:
//   lease_window_delayed_pallas (pallas_call at kernel.py:536; body
//     _delayed_window_kernel :313, quiescence test _quiescent :268)
//     -> lease_window_delayed below;
//   lease_window_sync_pallas (pallas_call at kernel.py:447; body
//     _sync_window_kernel :237) -> lease_window_sync below.
// Their per-tick bodies are netplane.delayed_tick_math and
// ref.sync_tick_math; the plain PyTorch versions of both live beside the
// wrappers (kernel.py in this package) and every result here is held
// bit-exact against them.
//
// What bounds it on this card. Cells are independent and the tick math
// never reduces across N, so there is no data reuse between cells to win:
// per cell-tick the kernel must read the attempts/releases(/extends)
// streams and write the owner and count rows (20 B with extends) — at
// 3.35 TB/s that is ~6 ps per cell-tick. The tick itself is a few hundred
// int32 selects, compares and shifts per cell (the A-loops below, times a
// handful of phases), which at the H100's int32 issue rate costs more than
// the bytes whenever every window really ticks. So a window that ticks is
// bound by integer operations, a quiescent window by bytes.
//
// What the design does about it:
//   * one thread per cell, the cell's 8 [A, N] columns and 8 [1, N] rows
//     held in registers (A is a compile-time constant, so every A-loop
//     unrolls) for all T ticks; state touches device memory once at the
//     start and once at the end;
//   * neighbouring threads own neighbouring cells, so every [A, N] and
//     [T, N] access is coalesced; the ragged edge is masked here, the host
//     pads nothing;
//   * per window of `tw` ticks the block stages the cell-independent
//     columns (acc_up, clocks, the [P, A] link matrices, fault columns) in
//     shared memory; a proposer-indexed read is a bounds-checked shared
//     load, which gives 0 for ids outside [0, P) exactly like the plain
//     version's select loop;
//   * quiescence skip (delayed kernel): a block-wide vote
//     (__syncthreads_and) proves that no cell of the block can change in the
//     window — no traffic, no open round, no scheduled event or fault, every
//     lease live through the window's last local-clock reading — and then
//     writes the owner/count rows without running the tick math;
//   * packed (deadline << 15 | ballot) words are built with unsigned shifts
//     (no signed-shift UB); the host checks the pack budget first.
// No TMA, no warp specialisation: the kernel streams a few int32 rows per
// tick, which plain coalesced loads serve.
//
// The batched entries (lease_window_{delayed,sync}_batched) are the
// counterpart of both Pallas kernels under jax.vmap in the reference's
// sweep (_sweep_fn, src/repro/lease_array/engine.py:270-327). Their
// planes ([B, T, ...], contiguous) are read at a stride of one scenario; the
// start state is the engine's, shared by every scenario (stride 0); no
// final state is written. In summary mode no [B, T, N] row is written: each
// cell keeps its max owner count, its owned-tick count and its final owner
// in registers and writes three [B, N] words at the end.
//   * delayed: its own kernel, delayed_batched_kernel (the unbatched entry
//     keeps delayed_window_kernel, kSingle, as it was). A sweep's scenarios
//     are small (the reference bench's: 32 cells x 16 ticks, 32,768 cells
//     in all), and one thread a cell left the card mostly idle (two warps a
//     scheduler, each waiting out a chain of ~340 dependent operations a
//     tick). So a cell is spread over G lanes (G a compile-time power of
//     two, 1..kMaxLanes): lane r holds the [A, N] columns of the acceptors
//     a = r, r + G, ... and every lane holds the cell's scalars and updates
//     them alike. Most of the tick is per-acceptor work; the lanes of a
//     cell meet only at the two vote counts (an OR butterfly of the open
//     and accept bits), in the quiescence vote and in the writes, which the
//     group's lane 0 alone makes. Where a scenario's N * G lanes, rounded up
//     to a warp, fill less than a block, a tile is a warp (32 / G cells of
//     one scenario, four tiles of any scenarios a block), staging its own
//     window and voting alone with __syncwarp() and __all_sync(), no block
//     barrier; a larger scenario takes whole blocks of kBlock lanes, one
//     staging area and one vote a block, as the unbatched kernel. A window
//     is at most kSub ticks: the vote reads its att/rel/ext rows at once,
//     and each tick's rows are in registers before it runs, loaded while the
//     tick before it ran: no global load sits on the tick chain.
//   * sync: its own kernel, sync_batched_kernel (the unbatched entry keeps
//     sync_window_kernel as it was): a warp a scenario (a 32-cell tile of
//     one where N > 32), four a block, each staging its own window with
//     __syncwarp() and no block barrier, with its att/rel rows in registers
//     before the ticks that read them.

#include <cuda_runtime.h>

// The acceptor count is a compile-time constant (every A-loop unrolls and
// the cell's columns stay in registers): the library is built once per A,
// 1..15 (netplane.MAX_VOTE_ACCEPTORS), with -DLEASE_ACCEPTORS=A.
#ifndef LEASE_ACCEPTORS
#error "build with -DLEASE_ACCEPTORS=<acceptor count, 1..15>"
#endif
static_assert(LEASE_ACCEPTORS >= 1 && LEASE_ACCEPTORS <= 15,
              "vote bitmasks hold at most 15 acceptors");

namespace {

constexpr int kA = LEASE_ACCEPTORS;

constexpr int kBlock = 128;
// the batched sync kernel's warps (32-cell tiles) a block; the most ticks a
// batched kernel stages at once (the sync one's att/rel rows of a stretch
// sit in registers; the delayed one's vote reads a window's at once)
constexpr int kBatchWarps = 4, kSub = 16;
// most scenarios one batched launch takes
constexpr int kMaxBatch = 65535;
// most lanes a cell of the batched delayed kernel (1, 2, 4, ... up to it)
constexpr int kMaxLanes = 8;
// what a launch writes (the OUT template parameter): the owner and count
// rows and the final state of one scenario (the unbatched kernels); the
// rows of each of B scenarios; or each of B scenarios' per-cell summary
constexpr int kSingle = 0, kRows = 1, kSummary = 2;
constexpr int kPackShift = 15;
constexpr int kPackMask = (1 << kPackShift) - 1;
constexpr int kNoProposer = -1;
constexpr int kRestartShift = 2;
constexpr int kIdle = 0, kPreparing = 1, kProposing = 2;

__device__ __forceinline__ int shl15(int x) {
  return static_cast<int>(static_cast<unsigned>(x) << kPackShift);
}

__device__ __forceinline__ int pack(int q4, int ballot) {
  return static_cast<int>((static_cast<unsigned>(q4) << kPackShift) |
                          static_cast<unsigned>(ballot));
}

// ballot % P with Python's sign convention (ballots are >= 0 in every legal
// state, where C's % agrees); a mask when P is a power of two.
__device__ __forceinline__ int ballot_proposer(int b, int P) {
  if ((P & (P - 1)) == 0) return b & (P - 1);
  int r = b % P;
  return r < 0 ? r + P : r;
}

// row[id] for id in [0, P), else 0 (state.clock_select / legs_select).
__device__ __forceinline__ int pick(const int* row, int id, int P) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(P) ? row[id] : 0;
}

// the link entry of proposer `p` towards acceptor `a` (0 = delay 0, kept)
__device__ __forceinline__ int leg(const int* link, int p, int a, int A,
                                   int P) {
  return static_cast<unsigned>(p) < static_cast<unsigned>(P) ? link[p * A + a]
                                                             : 0;
}

__device__ __forceinline__ bool due(int slot, int live_min) {
  return slot > 0 && slot < live_min;
}

template <int A>
__device__ __forceinline__ int votes(int bits) {
  return __popc(static_cast<unsigned>(bits) & ((1u << A) - 1u));
}

struct Params {
  int N, T, P, t0, tw;
  int majority, lease_q4, round_q4, guard_q4;
  int skip_stable;
};

// ---------------------------------------------------------------- delayed
struct DelayedArgs {
  const int* in[16];  // PackedLeaseState (4) then NetPlaneState (12) fields
  int* out[16];
  const int* att;     // [T, N]
  const int* rel;     // [T, N]
  const int* ext;     // [T, N] or null
  const int* up;      // [T, A]
  const int* pclk;    // [T, P]
  const int* aclk;    // [T, A]
  const int* link;    // [T, P, A]
  const int* stale;   // [T, A] or null (with equiv)
  const int* equiv;   // [T, A] or null
  const int* arst;    // [T, A] or null (the four restart columns together)
  const int* deaf;    // [T, A]
  const int* prst;    // [T, P]
  const int* prc;     // [T, P]
  int* owners;        // [T, N] ([B, T, N] batched), or null in summary mode
  int* counts;        // [T, N]
  unsigned long long* ticked;  // cell-ticks that ran the tick math, or null
  int* max_count;     // summary mode: [B, N] max owner count over the ticks
  int* owned;         // summary mode: [B, N] ticks with an owner
  int* final_owner;   // summary mode: [B, N] owner row after the last tick
};

template <int A>
struct Cell {
  int promised[A], acc_lease[A];
  int preq[A], presp[A], presp_pay[A], poreq[A], poresp[A], rel[A];
  int own_id, ownp;
  int rnd_ballot, rnd_phase, rnd_expiry, rnd_deadline, open_bits, acc_bits;
};

// Shared-memory columns of one tick (null where the plane is absent).
struct TickCols {
  const int *up, *pclk, *aclk, *link, *stale, *equiv, *arst, *deaf, *prst,
      *prc;
};

// One tick of netplane.delayed_tick_math for one cell, phase for phase.
// Returns the §4 owner count; the owner row is s.own_id afterwards.
template <int A, bool EXT, bool CORRUPT, bool RESTART>
__device__ __forceinline__ int delayed_tick(Cell<A>& s, int t, int att,
                                            int rel, int ext,
                                            const TickCols& k,
                                            const Params& p) {
  const int P = p.P;
  const int t4 = 4 * t;
  const int live_min = shl15(t4 + 1);
  bool up[A];
#pragma unroll
  for (int a = 0; a < A; ++a) up[a] = k.up[a] > 0;

  // 1. expiry, each node on its own local clock
#pragma unroll
  for (int a = 0; a < A; ++a)
    if (!(s.acc_lease[a] >= shl15(k.aclk[a] + 1))) s.acc_lease[a] = 0;
  {
    const int own_clk = pick(k.pclk, s.own_id, P);
    if (!(s.ownp >= shl15(own_clk + 1))) {
      s.ownp = 0;
      s.own_id = kNoProposer;
    }
  }

  // 1.5 crash/restart: a diskless acceptor comes back blank and deaf; a
  // restarted proposer drops its belief
  if (RESTART) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (k.arst[a] > 0) {
        s.promised[a] = 0;
        s.acc_lease[a] = 0;
        s.presp[a] = 0;
        s.presp_pay[a] = kNoProposer;
        s.poresp[a] = 0;
      }
      up[a] = up[a] && !(k.deaf[a] > 0);
    }
    if (pick(k.prst, s.own_id, P) > 0) {
      s.ownp = 0;
      s.own_id = kNoProposer;
    }
  }

  // 2. release (§7): stop believing now, then the discards ride the net
  const bool has_rel = rel >= 0;
  const bool rel_owner = has_rel && s.own_id == rel;
  const int rel_ballot = rel_owner ? (s.ownp & kPackMask) : 0;
  if (rel_owner) {
    s.ownp = 0;
    s.own_id = kNoProposer;
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int v = leg(k.link, rel, a, A, P);
    if (rel_ballot > 0 && !(v & 1)) s.rel[a] = pack(t4 + 4 * (v >> 1), rel_ballot);
    if (due(s.rel[a], live_min)) {
      if (up[a] && (s.acc_lease[a] & kPackMask) == (s.rel[a] & kPackMask))
        s.acc_lease[a] = 0;
      s.rel[a] = 0;
    }
  }

  // 3. round lifecycle: release / restart kills, abandon timer, new attempt
  int rnd_prop = ballot_proposer(s.rnd_ballot, P);
  bool rel_kills = s.rnd_ballot > 0 && has_rel && rnd_prop == rel;
  if (RESTART)
    rel_kills = rel_kills || (s.rnd_ballot > 0 && pick(k.prst, rnd_prop, P) > 0);
  int rnd_clk = pick(k.pclk, rnd_prop, P);
  const bool timed_out = s.rnd_ballot > 0 && rnd_clk >= s.rnd_deadline;
  int a_id = att;
  if (EXT && a_id < 0 && ext >= 0 && s.own_id == ext && s.ownp > 0)
    a_id = ext;  // §6 extend by the live owner; attempts take precedence
  const bool has_att = a_id >= 0;
  const int att_clk = pick(k.pclk, a_id, P);
  int new_ballot = 0;
  if (has_att) {
    if (RESTART) {
      const int upper = ((t + 1) << kRestartShift) | pick(k.prc, a_id, P);
      new_ballot = upper * P + a_id;
    } else {
      new_ballot = (t + 1) * P + a_id;
    }
  }
  const bool keep = s.rnd_ballot > 0 && !timed_out && !rel_kills && !has_att;
  s.rnd_ballot = has_att ? new_ballot : (keep ? s.rnd_ballot : 0);
  s.rnd_phase = has_att ? kPreparing : (keep ? s.rnd_phase : kIdle);
  s.rnd_expiry = keep ? s.rnd_expiry : 0;
  s.rnd_deadline = has_att ? att_clk + p.round_q4 : (keep ? s.rnd_deadline : 0);
  if (has_att || !keep) {
    s.open_bits = 0;
    s.acc_bits = 0;
  }

  // 4a/4b. prepare requests out, due ones delivered at acceptors (§3.2)
#pragma unroll
  for (int a = 0; a < A; ++a) {
    if (has_att) {
      const int v = leg(k.link, a_id, a, A, P);
      if (!(v & 1)) s.preq[a] = pack(t4 + 4 * (v >> 1), new_ballot);
    }
    const bool preq_due = due(s.preq[a], live_min);
    const int preq_b = s.preq[a] & kPackMask;
    const bool stale_a = CORRUPT && k.stale[a] > 0;
    const bool grant = preq_due && up[a] && (preq_b >= s.promised[a] || stale_a);
    if (grant) s.promised[a] = CORRUPT ? max(s.promised[a], preq_b) : preq_b;
    // the grant travels back on the requester's link
    const int v = leg(k.link, ballot_proposer(preq_b, P), a, A, P);
    if (grant && !(v & 1)) {
      const int acc_b = s.acc_lease[a] & kPackMask;
      int acc_prop = acc_b > 0 ? ballot_proposer(acc_b, P) : kNoProposer;
      if (CORRUPT && k.equiv[a] > 0) acc_prop = kNoProposer;
      s.presp[a] = pack(t4 + 4 * (v >> 1), preq_b);
      s.presp_pay[a] = acc_prop;
    }
    if (preq_due) s.preq[a] = 0;
  }

  // 4c. prepare responses at the proposer (§3.3): a majority of opens
  // starts OUR timer first, then broadcasts the proposal
  rnd_prop = ballot_proposer(s.rnd_ballot, P);
  rnd_clk = pick(k.pclk, rnd_prop, P);
  {
    const bool prop_owns = s.own_id == rnd_prop && s.ownp > 0;
    bool presp_due[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      presp_due[a] = due(s.presp[a], live_min);
      const bool match = presp_due[a] &&
                         (s.presp[a] & kPackMask) == s.rnd_ballot &&
                         s.rnd_phase == kPreparing;
      const bool open = match && (s.presp_pay[a] == kNoProposer ||
                                  (s.presp_pay[a] == rnd_prop && prop_owns));
      if (open) s.open_bits |= 1 << a;
    }
    const bool to_propose = s.rnd_ballot > 0 && s.rnd_phase == kPreparing &&
                            votes<A>(s.open_bits) >= p.majority;
    if (to_propose) {
      s.rnd_phase = kProposing;
      s.rnd_expiry = rnd_clk + p.guard_q4;
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (to_propose) {
        const int v = leg(k.link, rnd_prop, a, A, P);
        if (!(v & 1)) s.poreq[a] = pack(t4 + 4 * (v >> 1), s.rnd_ballot);
      }
      if (presp_due[a]) {
        s.presp[a] = 0;
        s.presp_pay[a] = kNoProposer;
      }
    }
  }

  // 4d. propose requests at acceptors (§3.4): accept restarts the
  // acceptor's full-length timer on ITS clock
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const bool poreq_due = due(s.poreq[a], live_min);
    const int poreq_b = s.poreq[a] & kPackMask;
    const bool stale_a = CORRUPT && k.stale[a] > 0;
    const bool accept = poreq_due && up[a] && (poreq_b >= s.promised[a] || stale_a);
    if (accept) s.acc_lease[a] = pack(k.aclk[a] + p.lease_q4, poreq_b);
    const int v = leg(k.link, ballot_proposer(poreq_b, P), a, A, P);
    if (accept && !(v & 1)) s.poresp[a] = pack(t4 + 4 * (v >> 1), poreq_b);
    if (poreq_due) s.poreq[a] = 0;
  }

  // 4e. propose responses at the proposer (§3.5): a majority of accepts
  // inside our own guarded timer wins
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const bool poresp_due = due(s.poresp[a], live_min);
    if (poresp_due && (s.poresp[a] & kPackMask) == s.rnd_ballot &&
        s.rnd_phase == kProposing)
      s.acc_bits |= 1 << a;
    if (poresp_due) s.poresp[a] = 0;
  }
  const bool win = s.rnd_ballot > 0 && s.rnd_phase == kProposing &&
                   votes<A>(s.acc_bits) >= p.majority &&
                   s.rnd_expiry > rnd_clk;
  // a win that would overwrite a live OTHER belief is the §4 alarm
  const bool viol = win && s.ownp > 0 && s.own_id != rnd_prop;
  if (win) {
    s.own_id = rnd_prop;
    s.ownp = pack(s.rnd_expiry, s.rnd_ballot);
    s.rnd_ballot = 0;
    s.rnd_phase = kIdle;
    s.rnd_expiry = 0;
    s.rnd_deadline = 0;
    s.open_bits = 0;
    s.acc_bits = 0;
  }
  return (s.ownp > 0 ? 1 : 0) + (viol ? 1 : 0);
}

// Can this cell change during the window? (the per-cell half of the
// quiescence vote; the block-uniform fault columns are checked while they
// are staged). Stricter than the reference's _quiescent: idle round rows
// must be all zero too, so the skip is exact on every input state.
template <int A, bool EXT>
__device__ __forceinline__ bool cell_quiet(const Cell<A>& s,
                                           const DelayedArgs& g, int n,
                                           int t_first, int nt,
                                           const int* pclk_end,
                                           const int* aclk_end,
                                           const Params& p) {
  const size_t N = static_cast<size_t>(p.N);
  for (int tau = 0; tau < nt; ++tau) {
    const size_t i = static_cast<size_t>(t_first + tau) * N + n;
    if (__ldg(g.att + i) >= 0 || __ldg(g.rel + i) >= 0) return false;
    if (EXT && __ldg(g.ext + i) >= 0) return false;
  }
  if (s.rnd_ballot | s.rnd_phase | s.rnd_expiry | s.rnd_deadline |
      s.open_bits | s.acc_bits)
    return false;
  bool quiet = true;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    quiet = quiet && !(s.preq[a] | s.presp[a] | s.poreq[a] | s.poresp[a] |
                       s.rel[a]);
    // clocks only advance: the window's last reading is its worst case
    quiet = quiet && (s.acc_lease[a] == 0 ||
                      s.acc_lease[a] >= shl15(aclk_end[a] + 1));
  }
  const int own_clk = pick(pclk_end, s.own_id, p.P);
  quiet = quiet && (s.ownp == 0 ? s.own_id < 0 : s.ownp >= shl15(own_clk + 1));
  return quiet;
}

// Copy `rows` ints per tick for ticks [w0, w0 + nt) into shared memory;
// returns whether this thread copied a nonzero entry.
__device__ __forceinline__ bool stage(int* dst, const int* src, int w0,
                                      int nt, int rows) {
  bool nonzero = false;
  const int count = nt * rows;
  const int* base = src + static_cast<size_t>(w0) * rows;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int v = __ldg(base + i);
    dst[i] = v;
    nonzero = nonzero || v != 0;
  }
  return nonzero;
}

// Moves the per-scenario planes of a batched launch's DelayedArgs to
// scenario b (the owner and count rows too, unless in summary mode).
template <int A, bool EXT, bool CORRUPT, bool RESTART>
__device__ __forceinline__ void to_scenario(DelayedArgs& g, const Params& p,
                                            size_t b) {
  const size_t T = static_cast<size_t>(p.T);
  const size_t P = static_cast<size_t>(p.P);
  const size_t tn = T * static_cast<size_t>(p.N);
  g.att += b * tn;
  g.rel += b * tn;
  if (EXT) g.ext += b * tn;
  g.up += b * T * A;
  g.pclk += b * T * P;
  g.aclk += b * T * A;
  g.link += b * T * P * A;
  if (CORRUPT) {
    g.stale += b * T * A;
    g.equiv += b * T * A;
  }
  if (RESTART) {
    g.arst += b * T * A;
    g.deaf += b * T * A;
    g.prst += b * T * P;
    g.prc += b * T * P;
  }
  if (g.owners != nullptr) {
    g.owners += b * tn;
    g.counts += b * tn;
  }
}

// The unbatched delayed kernel (lease_window_delayed): a thread a cell.
// OUT can only be kSingle; it stays a template parameter so that the
// kernel's mangled name (delayed_window_kernelILi3...ELi0E), which
// chip_smoke.py's SASS tick count looks up, does not change.
template <int A, bool EXT, bool CORRUPT, bool RESTART, int OUT>
__global__ void __launch_bounds__(kBlock)
    delayed_window_kernel(DelayedArgs args, Params p) {
  static_assert(OUT == kSingle, "the batched entry is delayed_batched_kernel");
  extern __shared__ int smem[];
  const DelayedArgs& g = args;
  const int P = p.P, tw = p.tw;
  const size_t N = static_cast<size_t>(p.N);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < p.N;

  // shared-memory columns for one window, tick-major inside each group
  int* s_up = smem;
  int* s_pclk = s_up + tw * A;
  int* s_aclk = s_pclk + tw * P;
  int* s_link = s_aclk + tw * A;
  int* s_stale = s_link + tw * P * A;
  int* s_equiv = s_stale + (CORRUPT ? tw * A : 0);
  int* s_arst = s_equiv + (CORRUPT ? tw * A : 0);
  int* s_deaf = s_arst + (RESTART ? tw * A : 0);
  int* s_prst = s_deaf + (RESTART ? tw * A : 0);
  int* s_prc = s_prst + (RESTART ? tw * P : 0);

  Cell<A> s = {};
  if (live) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const size_t i = static_cast<size_t>(a) * N + n;
      s.promised[a] = g.in[0][i];
      s.acc_lease[a] = g.in[1][i];
      s.preq[a] = g.in[4][i];
      s.presp[a] = g.in[5][i];
      s.presp_pay[a] = g.in[6][i];
      s.poreq[a] = g.in[7][i];
      s.poresp[a] = g.in[8][i];
      s.rel[a] = g.in[9][i];
    }
    s.own_id = g.in[2][n];
    s.ownp = g.in[3][n];
    s.rnd_ballot = g.in[10][n];
    s.rnd_phase = g.in[11][n];
    s.rnd_expiry = g.in[12][n];
    s.rnd_deadline = g.in[13][n];
    s.open_bits = g.in[14][n];
    s.acc_bits = g.in[15][n];
  }

  for (int w0 = 0; w0 < p.T; w0 += tw) {
    const int nt = min(tw, p.T - w0);
    __syncthreads();  // every thread is done with the previous window
    stage(s_up, g.up, w0, nt, A);
    stage(s_pclk, g.pclk, w0, nt, P);
    stage(s_aclk, g.aclk, w0, nt, A);
    stage(s_link, g.link, w0, nt, P * A);
    bool faulty = false;  // a fault scheduled in this window
    if (CORRUPT) {
      faulty = stage(s_stale, g.stale, w0, nt, A) || faulty;
      faulty = stage(s_equiv, g.equiv, w0, nt, A) || faulty;
    }
    if (RESTART) {
      faulty = stage(s_arst, g.arst, w0, nt, A) || faulty;
      stage(s_deaf, g.deaf, w0, nt, A);
      faulty = stage(s_prst, g.prst, w0, nt, P) || faulty;
      stage(s_prc, g.prc, w0, nt, P);
    }
    __syncthreads();

    bool skip = false;
    if (p.skip_stable) {
      const bool quiet =
          !faulty && (!live || cell_quiet<A, EXT>(s, g, n, w0, nt,
                                             s_pclk + (nt - 1) * P,
                                             s_aclk + (nt - 1) * A, p));
      skip = __syncthreads_and(quiet) != 0;
    }

    if (skip) {
      // the window is pure owner sampling: state untouched, every tick
      // reads the same row
      if (live) {
        const int cnt = s.ownp > 0 ? 1 : 0;
        for (int tau = 0; tau < nt; ++tau) {
          const size_t i = static_cast<size_t>(w0 + tau) * N + n;
          g.owners[i] = s.own_id;
          g.counts[i] = cnt;
        }
      }
      continue;
    }
    if (g.ticked != nullptr && threadIdx.x == 0) {
      const int first = blockIdx.x * blockDim.x;
      const int in_block = min(static_cast<int>(blockDim.x), p.N - first);
      atomicAdd(g.ticked, static_cast<unsigned long long>(in_block) * nt);
    }
    if (!live) continue;
    for (int tau = 0; tau < nt; ++tau) {
      const size_t i = static_cast<size_t>(w0 + tau) * N + n;
      TickCols k;
      k.up = s_up + tau * A;
      k.pclk = s_pclk + tau * P;
      k.aclk = s_aclk + tau * A;
      k.link = s_link + tau * P * A;
      k.stale = s_stale + tau * A;
      k.equiv = s_equiv + tau * A;
      k.arst = s_arst + tau * A;
      k.deaf = s_deaf + tau * A;
      k.prst = s_prst + tau * P;
      k.prc = s_prc + tau * P;
      const int ext = EXT ? __ldg(g.ext + i) : kNoProposer;
      const int cnt = delayed_tick<A, EXT, CORRUPT, RESTART>(
          s, p.t0 + w0 + tau, __ldg(g.att + i), __ldg(g.rel + i), ext, k, p);
      g.owners[i] = s.own_id;
      g.counts[i] = cnt;
    }
  }

  if (live) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const size_t i = static_cast<size_t>(a) * N + n;
      g.out[0][i] = s.promised[a];
      g.out[1][i] = s.acc_lease[a];
      g.out[4][i] = s.preq[a];
      g.out[5][i] = s.presp[a];
      g.out[6][i] = s.presp_pay[a];
      g.out[7][i] = s.poreq[a];
      g.out[8][i] = s.poresp[a];
      g.out[9][i] = s.rel[a];
    }
    g.out[2][n] = s.own_id;
    g.out[3][n] = s.ownp;
    g.out[10][n] = s.rnd_ballot;
    g.out[11][n] = s.rnd_phase;
    g.out[12][n] = s.rnd_expiry;
    g.out[13][n] = s.rnd_deadline;
    g.out[14][n] = s.open_bits;
    g.out[15][n] = s.acc_bits;
  }
}

// --------------------------------------------------------- batched delayed
// delayed_batched_kernel: lease_window_delayed_pallas under jax.vmap (the
// sweep), with a cell spread over G lanes (see the note at the top).

// A cell's state as lane r of its G lanes holds it: slot j is acceptor
// j * G + r, where that is below A. A slot past the last acceptor starts
// blank, is never up and reads the last acceptor's columns: its requests
// and releases then come and go with the last acceptor's (the same link
// entry, the same due tick), and it grants, accepts and votes nothing, so
// neither the results nor the quiescence vote see it. The scalars are the
// cell's, the same in every lane.
template <int A, int G>
struct LaneCell {
  static constexpr int S = (A + G - 1) / G;  // acceptor slots a lane
  int promised[S], acc_lease[S];
  int preq[S], presp[S], presp_pay[S], poreq[S], poresp[S], rel[S];
  int own_id, ownp;
  int rnd_ballot, rnd_phase, rnd_expiry, rnd_deadline, open_bits, acc_bits;
};

// The OR of `bits` over a cell's G lanes (aligned groups of a warp; every
// lane of the warp takes part).
template <int G>
__device__ __forceinline__ int group_or(int bits) {
#pragma unroll
  for (int m = 1; m < G; m <<= 1) bits |= __shfl_xor_sync(0xffffffffu, bits, m);
  return bits;
}

// Whether slot j of lane r holds an acceptor (a compile-time truth for the
// slots every lane fills), and the acceptor whose columns it reads: its
// own, or the last one for a blank slot.
template <int A, int G>
__device__ __forceinline__ bool slot_ok(int j, int r) {
  return (j + 1) * G <= A || j * G + r < A;
}

template <int A, int G>
__device__ __forceinline__ int slot_acc(int j, int r) {
  return slot_ok<A, G>(j, r) ? j * G + r : A - 1;
}

// One tick of netplane.delayed_tick_math for lane r of a cell's G lanes,
// phase for phase as delayed_tick (G = 1 computes what it computes): the
// per-acceptor work on the lane's slots, the vote counts on the bits of all
// G lanes. Returns the §4 owner count; the owner row is s.own_id afterwards.
template <int A, int G, bool EXT, bool CORRUPT, bool RESTART>
__device__ __forceinline__ int lane_tick(LaneCell<A, G>& s, int r, int t,
                                         int att, int rel, int ext,
                                         const TickCols& k, const Params& p) {
  constexpr int S = LaneCell<A, G>::S;
  const int P = p.P;
  const int t4 = 4 * t;
  const int live_min = shl15(t4 + 1);
  // the acceptor whose columns slot j reads
  const auto ac = [r](int j) { return slot_acc<A, G>(j, r); };
  bool up[S];  // the slot's acceptor is up (never for a blank slot)
#pragma unroll
  for (int j = 0; j < S; ++j) up[j] = slot_ok<A, G>(j, r) && k.up[ac(j)] > 0;

  // 1. expiry, each node on its own local clock
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (!(s.acc_lease[j] >= shl15(k.aclk[ac(j)] + 1))) s.acc_lease[j] = 0;
  {
    const int own_clk = pick(k.pclk, s.own_id, P);
    if (!(s.ownp >= shl15(own_clk + 1))) {
      s.ownp = 0;
      s.own_id = kNoProposer;
    }
  }

  // 1.5 crash/restart
  if (RESTART) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (k.arst[ac(j)] > 0) {
        s.promised[j] = 0;
        s.acc_lease[j] = 0;
        s.presp[j] = 0;
        s.presp_pay[j] = kNoProposer;
        s.poresp[j] = 0;
      }
      up[j] = up[j] && !(k.deaf[ac(j)] > 0);
    }
    if (pick(k.prst, s.own_id, P) > 0) {
      s.ownp = 0;
      s.own_id = kNoProposer;
    }
  }

  // 2. release (§7)
  const bool has_rel = rel >= 0;
  const bool rel_owner = has_rel && s.own_id == rel;
  const int rel_ballot = rel_owner ? (s.ownp & kPackMask) : 0;
  if (rel_owner) {
    s.ownp = 0;
    s.own_id = kNoProposer;
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int v = leg(k.link, rel, ac(j), A, P);
    if (rel_ballot > 0 && !(v & 1)) s.rel[j] = pack(t4 + 4 * (v >> 1), rel_ballot);
    if (due(s.rel[j], live_min)) {
      if (up[j] && (s.acc_lease[j] & kPackMask) == (s.rel[j] & kPackMask))
        s.acc_lease[j] = 0;
      s.rel[j] = 0;
    }
  }

  // 3. round lifecycle (the cell's scalars, alike in every lane)
  int rnd_prop = ballot_proposer(s.rnd_ballot, P);
  bool rel_kills = s.rnd_ballot > 0 && has_rel && rnd_prop == rel;
  if (RESTART)
    rel_kills = rel_kills || (s.rnd_ballot > 0 && pick(k.prst, rnd_prop, P) > 0);
  int rnd_clk = pick(k.pclk, rnd_prop, P);
  const bool timed_out = s.rnd_ballot > 0 && rnd_clk >= s.rnd_deadline;
  int a_id = att;
  if (EXT && a_id < 0 && ext >= 0 && s.own_id == ext && s.ownp > 0)
    a_id = ext;  // §6 extend by the live owner; attempts take precedence
  const bool has_att = a_id >= 0;
  const int att_clk = pick(k.pclk, a_id, P);
  int new_ballot = 0;
  if (has_att) {
    if (RESTART) {
      const int upper = ((t + 1) << kRestartShift) | pick(k.prc, a_id, P);
      new_ballot = upper * P + a_id;
    } else {
      new_ballot = (t + 1) * P + a_id;
    }
  }
  const bool keep = s.rnd_ballot > 0 && !timed_out && !rel_kills && !has_att;
  s.rnd_ballot = has_att ? new_ballot : (keep ? s.rnd_ballot : 0);
  s.rnd_phase = has_att ? kPreparing : (keep ? s.rnd_phase : kIdle);
  s.rnd_expiry = keep ? s.rnd_expiry : 0;
  s.rnd_deadline = has_att ? att_clk + p.round_q4 : (keep ? s.rnd_deadline : 0);
  if (has_att || !keep) {
    s.open_bits = 0;
    s.acc_bits = 0;
  }

  // 4a/4b. prepare requests out, due ones delivered at acceptors (§3.2)
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (has_att) {
      const int v = leg(k.link, a_id, ac(j), A, P);
      if (!(v & 1)) s.preq[j] = pack(t4 + 4 * (v >> 1), new_ballot);
    }
    const bool preq_due = due(s.preq[j], live_min);
    const int preq_b = s.preq[j] & kPackMask;
    const bool stale_a = CORRUPT && k.stale[ac(j)] > 0;
    const bool grant = preq_due && up[j] && (preq_b >= s.promised[j] || stale_a);
    if (grant) s.promised[j] = CORRUPT ? max(s.promised[j], preq_b) : preq_b;
    const int v = leg(k.link, ballot_proposer(preq_b, P), ac(j), A, P);
    if (grant && !(v & 1)) {
      const int acc_b = s.acc_lease[j] & kPackMask;
      int acc_prop = acc_b > 0 ? ballot_proposer(acc_b, P) : kNoProposer;
      if (CORRUPT && k.equiv[ac(j)] > 0) acc_prop = kNoProposer;
      s.presp[j] = pack(t4 + 4 * (v >> 1), preq_b);
      s.presp_pay[j] = acc_prop;
    }
    if (preq_due) s.preq[j] = 0;
  }

  // 4c. prepare responses at the proposer (§3.3): the lanes' opens meet here
  rnd_prop = ballot_proposer(s.rnd_ballot, P);
  rnd_clk = pick(k.pclk, rnd_prop, P);
  {
    const bool prop_owns = s.own_id == rnd_prop && s.ownp > 0;
    bool presp_due[S];
    int opened = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      presp_due[j] = due(s.presp[j], live_min);
      const bool match = presp_due[j] &&
                         (s.presp[j] & kPackMask) == s.rnd_ballot &&
                         s.rnd_phase == kPreparing;
      const bool open = match && (s.presp_pay[j] == kNoProposer ||
                                  (s.presp_pay[j] == rnd_prop && prop_owns));
      if (open) opened |= 1 << ac(j);
    }
    s.open_bits |= group_or<G>(opened);
    const bool to_propose = s.rnd_ballot > 0 && s.rnd_phase == kPreparing &&
                            votes<A>(s.open_bits) >= p.majority;
    if (to_propose) {
      s.rnd_phase = kProposing;
      s.rnd_expiry = rnd_clk + p.guard_q4;
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (to_propose) {
        const int v = leg(k.link, rnd_prop, ac(j), A, P);
        if (!(v & 1)) s.poreq[j] = pack(t4 + 4 * (v >> 1), s.rnd_ballot);
      }
      if (presp_due[j]) {
        s.presp[j] = 0;
        s.presp_pay[j] = kNoProposer;
      }
    }
  }

  // 4d. propose requests at acceptors (§3.4)
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const bool poreq_due = due(s.poreq[j], live_min);
    const int poreq_b = s.poreq[j] & kPackMask;
    const bool stale_a = CORRUPT && k.stale[ac(j)] > 0;
    const bool accept = poreq_due && up[j] && (poreq_b >= s.promised[j] || stale_a);
    if (accept) s.acc_lease[j] = pack(k.aclk[ac(j)] + p.lease_q4, poreq_b);
    const int v = leg(k.link, ballot_proposer(poreq_b, P), ac(j), A, P);
    if (accept && !(v & 1)) s.poresp[j] = pack(t4 + 4 * (v >> 1), poreq_b);
    if (poreq_due) s.poreq[j] = 0;
  }

  // 4e. propose responses at the proposer (§3.5): the lanes' accepts meet
  int accepted = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const bool poresp_due = due(s.poresp[j], live_min);
    if (poresp_due && (s.poresp[j] & kPackMask) == s.rnd_ballot &&
        s.rnd_phase == kProposing)
      accepted |= 1 << ac(j);
    if (poresp_due) s.poresp[j] = 0;
  }
  s.acc_bits |= group_or<G>(accepted);
  const bool win = s.rnd_ballot > 0 && s.rnd_phase == kProposing &&
                   votes<A>(s.acc_bits) >= p.majority &&
                   s.rnd_expiry > rnd_clk;
  const bool viol = win && s.ownp > 0 && s.own_id != rnd_prop;
  if (win) {
    s.own_id = rnd_prop;
    s.ownp = pack(s.rnd_expiry, s.rnd_ballot);
    s.rnd_ballot = 0;
    s.rnd_phase = kIdle;
    s.rnd_expiry = 0;
    s.rnd_deadline = 0;
    s.open_bits = 0;
    s.acc_bits = 0;
  }
  return (s.ownp > 0 ? 1 : 0) + (viol ? 1 : 0);
}

// cell_quiet's test of the cell's state on lane r's slots and the scalars
// (the rows' part is the caller's).
template <int A, int G>
__device__ __forceinline__ bool lane_quiet(const LaneCell<A, G>& s, int r,
                                           const int* pclk_end,
                                           const int* aclk_end,
                                           const Params& p) {
  if (s.rnd_ballot | s.rnd_phase | s.rnd_expiry | s.rnd_deadline |
      s.open_bits | s.acc_bits)
    return false;
  bool quiet = true;
#pragma unroll
  for (int j = 0; j < LaneCell<A, G>::S; ++j) {
    quiet = quiet && !(s.preq[j] | s.presp[j] | s.poreq[j] | s.poresp[j] |
                       s.rel[j]);
    quiet = quiet && (s.acc_lease[j] == 0 ||
                      s.acc_lease[j] >= shl15(aclk_end[slot_acc<A, G>(j, r)] + 1));
  }
  const int own_clk = pick(pclk_end, s.own_id, p.P);
  quiet = quiet && (s.ownp == 0 ? s.own_id < 0 : s.ownp >= shl15(own_clk + 1));
  return quiet;
}

// stage() for a tile's lanes: lane `lane` of `lanes` copies, four loads in
// flight before their stores (a window's columns are a few words a lane,
// so the copy is a few load latencies, not one a word).
__device__ __forceinline__ bool stage_tile(int* dst, const int* src, int w0,
                                           int nt, int rows, int lane,
                                           int lanes) {
  constexpr int kInFlight = 4;
  int nonzero = 0;
  const int count = nt * rows;
  const int* base = src + static_cast<size_t>(w0) * rows;
  for (int i = lane; i < count; i += kInFlight * lanes) {
    int v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      v[u] = i + u * lanes < count ? __ldg(base + i + u * lanes) : 0;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (i + u * lanes < count) dst[i + u * lanes] = v[u];
      nonzero |= v[u];
    }
  }
  return nonzero != 0;
}

// A tile is a warp (tile_warps 1) or the block (kBlock / 32): the lanes
// that stage one window together and take one quiescence vote.
__device__ __forceinline__ void tile_sync(int tile_warps) {
  if (tile_warps == 1)
    __syncwarp();
  else
    __syncthreads();
}

__device__ __forceinline__ bool tile_all(bool pred, int tile_warps) {
  return tile_warps == 1 ? __all_sync(0xffffffffu, pred) != 0
                         : __syncthreads_and(pred) != 0;
}

// The batched delayed kernel (lease_window_delayed_batched). Tile t of the
// launch (blockIdx.x * tiles a block + the tile's place in the block) holds
// cells [(t % tiles) * cells, + cells) of scenario t / tiles, G lanes a
// cell. `words` is what one tick of the tile's staging area holds; one
// instantiation serves both collect modes (summary where max_count is set).
// The launch bound's four blocks an SM (at most 128 registers) keep ptxas
// from spilling to reach an occupancy it picks itself: with no minimum, the
// instantiations with a blank slot spilled 4-8 bytes at 80 registers.
template <int A, int G, bool EXT, bool CORRUPT, bool RESTART>
__global__ void __launch_bounds__(kBlock, 4)
    delayed_batched_kernel(DelayedArgs args, Params p, int batch,
                           int tile_warps, int words) {
  static_assert(kBlock == 1 << 7 && (G & (G - 1)) == 0, "tiles and lane groups are powers of two");
  extern __shared__ int smem[];
  const int P = p.P, tw = p.tw;
  // a tile's lanes and cells as powers of two (shifts: no division here)
  const int tile_log2 = tile_warps == 1 ? 5 : 7;
  const int cells_log2 = tile_log2 - (G >= 8) - (G >= 4) - (G >= 2);
  const int cells = 1 << cells_log2;                       // cells a tile
  const int tiles = (p.N + cells - 1) >> cells_log2;       // tiles a scenario
  const int tile_lanes = 1 << tile_log2;
  const int lane = threadIdx.x & (tile_lanes - 1);         // the lane's place in its tile
  const int slot = threadIdx.x >> tile_log2;               // the tile's place in its block
  const long long tile = (static_cast<long long>(blockIdx.x) << (7 - tile_log2)) + slot;
  if (tile >= static_cast<long long>(batch) * tiles) return;  // the whole tile
  const long long scenario = tile / tiles;
  const size_t b = static_cast<size_t>(scenario), N = static_cast<size_t>(p.N);
  const int first = static_cast<int>(tile - scenario * tiles) << cells_log2;  // the tile's first cell
  const int n = first + (lane >> (tile_log2 - cells_log2)), r = lane & (G - 1);
  const bool live = n < p.N;
  const bool writes = live && r == 0;  // a cell's lane 0 writes its outputs
  const bool summary = args.max_count != nullptr;
  DelayedArgs g = args;
  to_scenario<A, EXT, CORRUPT, RESTART>(g, p, b);

  // the tile's shared-memory columns for one window, as delayed_window_kernel's
  int* s_up = smem + slot * words * tw;
  int* s_pclk = s_up + tw * A;
  int* s_aclk = s_pclk + tw * P;
  int* s_link = s_aclk + tw * A;
  int* s_stale = s_link + tw * P * A;
  int* s_equiv = s_stale + (CORRUPT ? tw * A : 0);
  int* s_arst = s_equiv + (CORRUPT ? tw * A : 0);
  int* s_deaf = s_arst + (RESTART ? tw * A : 0);
  int* s_prst = s_deaf + (RESTART ? tw * A : 0);
  int* s_prc = s_prst + (RESTART ? tw * P : 0);

  LaneCell<A, G> s = {};  // a lane past N runs the ticks blank and writes nothing
  if (live) {
#pragma unroll
    for (int j = 0; j < LaneCell<A, G>::S; ++j) {
      if (!slot_ok<A, G>(j, r)) continue;
      const size_t i = static_cast<size_t>(j * G + r) * N + n;
      s.promised[j] = g.in[0][i];
      s.acc_lease[j] = g.in[1][i];
      s.preq[j] = g.in[4][i];
      s.presp[j] = g.in[5][i];
      s.presp_pay[j] = g.in[6][i];
      s.poreq[j] = g.in[7][i];
      s.poresp[j] = g.in[8][i];
      s.rel[j] = g.in[9][i];
    }
    s.own_id = g.in[2][n];
    s.ownp = g.in[3][n];
    s.rnd_ballot = g.in[10][n];
    s.rnd_phase = g.in[11][n];
    s.rnd_expiry = g.in[12][n];
    s.rnd_deadline = g.in[13][n];
    s.open_bits = g.in[14][n];
    s.acc_bits = g.in[15][n];
  }
  int max_count = 0, owned = 0;  // summary mode

  for (int w0 = 0; w0 < p.T; w0 += tw) {
    const int nt = min(tw, p.T - w0);
    tile_sync(tile_warps);  // the tile is done with the previous window
    stage_tile(s_up, g.up, w0, nt, A, lane, tile_lanes);
    stage_tile(s_pclk, g.pclk, w0, nt, P, lane, tile_lanes);
    stage_tile(s_aclk, g.aclk, w0, nt, A, lane, tile_lanes);
    stage_tile(s_link, g.link, w0, nt, P * A, lane, tile_lanes);
    bool faulty = false;  // a fault scheduled in this window
    if (CORRUPT) {
      faulty = stage_tile(s_stale, g.stale, w0, nt, A, lane, tile_lanes) || faulty;
      faulty = stage_tile(s_equiv, g.equiv, w0, nt, A, lane, tile_lanes) || faulty;
    }
    if (RESTART) {
      faulty = stage_tile(s_arst, g.arst, w0, nt, A, lane, tile_lanes) || faulty;
      stage_tile(s_deaf, g.deaf, w0, nt, A, lane, tile_lanes);
      faulty = stage_tile(s_prst, g.prst, w0, nt, P, lane, tile_lanes) || faulty;
      stage_tile(s_prc, g.prc, w0, nt, P, lane, tile_lanes);
    }
    // the first tick's rows of the lane's cell (-1, no traffic, past N)
    size_t i = static_cast<size_t>(w0) * N + n;
    int at = live ? __ldg(g.att + i) : kNoProposer;
    int rl = live ? __ldg(g.rel + i) : kNoProposer;
    int ex = EXT && live ? __ldg(g.ext + i) : kNoProposer;
    tile_sync(tile_warps);

    bool skip = false;
    if (p.skip_stable) {
      // the tile's vote, cell_quiet's test in two steps: every lane's state
      // and the window's faults; then, where all are quiet, the window's
      // rows, read at once (a row is traffic where att, rel or ext is >= 0:
      // the AND of the three is then >= 0)
      skip = tile_all(!faulty && (!live || lane_quiet<A, G>(s, r, s_pclk + (nt - 1) * P,
                                                           s_aclk + (nt - 1) * A, p)),
                      tile_warps);
      if (skip) {
        int rows_and = at & rl & ex;
#pragma unroll
        for (int tau = 1; tau < kSub; ++tau) {
          const size_t j = static_cast<size_t>(w0 + tau) * N + n;
          if (live && tau < nt)
            rows_and &= __ldg(g.att + j) & __ldg(g.rel + j) &
                        (EXT ? __ldg(g.ext + j) : kNoProposer);
        }
        skip = tile_all(rows_and < 0, tile_warps);
      }
    }

    if (skip) {
      // the window is pure owner sampling: state untouched, every tick
      // reads the same row
      const int cnt = s.ownp > 0 ? 1 : 0;
      if (summary) {
        max_count = max(max_count, cnt);
        owned += s.own_id >= 0 ? nt : 0;
      } else if (writes) {
        for (int tau = 0; tau < nt; ++tau) {
          const size_t j = static_cast<size_t>(w0 + tau) * N + n;
          g.owners[j] = s.own_id;
          g.counts[j] = cnt;
        }
      }
      continue;
    }
    if (g.ticked != nullptr && lane == 0)
      atomicAdd(g.ticked, static_cast<unsigned long long>(min(cells, p.N - first)) * nt);
#pragma unroll 1
    for (int tau = 0; tau < nt; ++tau) {
      // the next tick's rows, in flight while this tick runs: no load sits
      // on the tick chain
      i += N;
      const bool next = live && tau + 1 < nt;
      const int at_next = next ? __ldg(g.att + i) : kNoProposer;
      const int rl_next = next ? __ldg(g.rel + i) : kNoProposer;
      const int ex_next = EXT && next ? __ldg(g.ext + i) : kNoProposer;
      TickCols k;
      k.up = s_up + tau * A;
      k.pclk = s_pclk + tau * P;
      k.aclk = s_aclk + tau * A;
      k.link = s_link + tau * P * A;
      k.stale = s_stale + tau * A;
      k.equiv = s_equiv + tau * A;
      k.arst = s_arst + tau * A;
      k.deaf = s_deaf + tau * A;
      k.prst = s_prst + tau * P;
      k.prc = s_prc + tau * P;
      const int cnt = lane_tick<A, G, EXT, CORRUPT, RESTART>(
          s, r, p.t0 + w0 + tau, at, rl, ex, k, p);
      if (summary) {
        max_count = max(max_count, cnt);
        owned += s.own_id >= 0 ? 1 : 0;
      } else if (writes) {
        const size_t j = static_cast<size_t>(w0 + tau) * N + n;
        g.owners[j] = s.own_id;
        g.counts[j] = cnt;
      }
      at = at_next;
      rl = rl_next;
      ex = ex_next;
    }
  }
  if (summary && writes) {
    const size_t j = b * N + n;
    g.max_count[j] = max_count;
    g.owned[j] = owned;
    g.final_owner[j] = s.own_id;
  }
}

// ------------------------------------------------------------------- sync
struct SyncArgs {
  const int* in[4];  // PackedLeaseState fields
  int* out[4];
  const int* att;    // [T, N]
  const int* rel;    // [T, N]
  const int* up;     // [T, A]
  const int* pclk;   // [T, P]
  const int* aclk;   // [T, A]
  int* owners;       // [T, N] ([B, T, N] batched), or null with kSummary
  int* counts;       // [T, N]
  int* max_count;    // kSummary: [B, N], as in DelayedArgs
  int* owned;        // kSummary: [B, N]
  int* final_owner;  // kSummary: [B, N]
};

// One tick of ref.sync_tick_math for one cell; returns the §4 owner count.
template <int A>
__device__ __forceinline__ int sync_tick(int (&promised)[A],
                                         int (&acc_lease)[A], int& own_id,
                                         int& ownp, int t, int att, int rel,
                                         const int* up, const int* pclk,
                                         const int* aclk, const Params& p) {
  const int P = p.P;
  // 1. expiry
#pragma unroll
  for (int a = 0; a < A; ++a)
    if (!(acc_lease[a] >= shl15(aclk[a] + 1))) acc_lease[a] = 0;
  if (!(ownp >= shl15(pick(pclk, own_id, P) + 1))) {
    ownp = 0;
    own_id = kNoProposer;
  }
  // 2. release (§7)
  const bool rel_owner = rel >= 0 && own_id == rel;
  const int rel_ballot = rel_owner ? (ownp & kPackMask) : 0;
  if (rel_owner) {
    ownp = 0;
    own_id = kNoProposer;
  }
  // 3. prepare (§3.2)
  const bool has_att = att >= 0;
  const int ballot = has_att ? (t + 1) * P + att : 0;
  const bool att_owns = has_att && own_id == att;
  bool grant[A];
  int opens = 0;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    int acc_b = acc_lease[a] & kPackMask;
    if (up[a] > 0 && rel_ballot > 0 && acc_b == rel_ballot) {
      acc_lease[a] = 0;
      acc_b = 0;
    }
    grant[a] = up[a] > 0 && has_att && ballot >= promised[a];
    opens += grant[a] && (acc_b == 0 ||
                          (ballot_proposer(acc_b, P) == att && att_owns));
  }
  const bool won = opens >= p.majority;
  // 4. propose (§3.4) + proposer update
#pragma unroll
  for (int a = 0; a < A; ++a) {
    if (grant[a]) promised[a] = ballot;
    if (grant[a] && won) acc_lease[a] = pack(aclk[a] + p.lease_q4, ballot);
  }
  const bool viol = won && ownp > 0 && own_id != att;
  if (won) {
    ownp = pack(pick(pclk, att, P) + p.guard_q4, ballot);
    own_id = att;
  }
  return (ownp > 0 ? 1 : 0) + (viol ? 1 : 0);
}

template <int A>
__global__ void __launch_bounds__(kBlock)
    sync_window_kernel(SyncArgs g, Params p) {
  extern __shared__ int smem[];
  const int P = p.P, tw = p.tw;
  const size_t N = static_cast<size_t>(p.N);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < p.N;
  int* s_up = smem;
  int* s_pclk = s_up + tw * A;
  int* s_aclk = s_pclk + tw * P;

  int promised[A] = {}, acc_lease[A] = {}, own_id = kNoProposer, ownp = 0;
  if (live) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      promised[a] = g.in[0][static_cast<size_t>(a) * N + n];
      acc_lease[a] = g.in[1][static_cast<size_t>(a) * N + n];
    }
    own_id = g.in[2][n];
    ownp = g.in[3][n];
  }
  for (int w0 = 0; w0 < p.T; w0 += tw) {
    const int nt = min(tw, p.T - w0);
    __syncthreads();
    stage(s_up, g.up, w0, nt, A);
    stage(s_pclk, g.pclk, w0, nt, P);
    stage(s_aclk, g.aclk, w0, nt, A);
    __syncthreads();
    if (!live) continue;
    for (int tau = 0; tau < nt; ++tau) {
      const size_t i = static_cast<size_t>(w0 + tau) * N + n;
      const int cnt = sync_tick<A>(promised, acc_lease, own_id, ownp,
                                   p.t0 + w0 + tau, __ldg(g.att + i),
                                   __ldg(g.rel + i), s_up + tau * A,
                                   s_pclk + tau * P, s_aclk + tau * A, p);
      g.owners[i] = own_id;
      g.counts[i] = cnt;
    }
  }
  if (live) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      g.out[0][static_cast<size_t>(a) * N + n] = promised[a];
      g.out[1][static_cast<size_t>(a) * N + n] = acc_lease[a];
    }
    g.out[2][n] = own_id;
    g.out[3][n] = ownp;
  }
}

// The batched sync kernel: a warp owns a tile of 32 cells of one scenario
// (a whole scenario where N <= 32), kBatchWarps tiles a block, so a block
// holds several scenarios and no block barrier is needed. Each warp stages
// its own scenario's up/pclk/aclk for kSub ticks at a time between two
// __syncwarp()s, and loads its cells' att/rel rows for those ticks into
// registers, coalesced, before the first of them (the start state's loads
// go out beside the first stretch's): no global load sits on the tick
// chain. The tick math is sync_tick, as in the unbatched kernel.
template <int A, int OUT>
__global__ void __launch_bounds__(32 * kBatchWarps)
    sync_batched_kernel(SyncArgs g, Params p, int batch) {
  static_assert(OUT == kRows || OUT == kSummary, "the unbatched entry is sync_window_kernel");
  extern __shared__ int smem[];
  const int P = p.P, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tiles = (p.N + 31) / 32;  // a scenario's 32-cell tiles
  const long long tile = static_cast<long long>(blockIdx.x) * kBatchWarps + warp;
  if (tile >= static_cast<long long>(batch) * tiles) return;  // the whole warp
  const size_t b = tile / tiles, N = static_cast<size_t>(p.N), T = static_cast<size_t>(p.T);
  const int n = static_cast<int>(tile % tiles) * 32 + lane;
  const bool live = n < p.N;
  const int* att = g.att + b * T * N;
  const int* rel = g.rel + b * T * N;
  const int* up = g.up + b * T * A;
  const int* pclk = g.pclk + b * T * static_cast<size_t>(P);
  const int* aclk = g.aclk + b * T * A;
  int* s_up = smem + warp * (2 * A + P) * kSub;
  int* s_pclk = s_up + kSub * A;
  int* s_aclk = s_pclk + kSub * P;

  int promised[A] = {}, acc_lease[A] = {}, own_id = kNoProposer, ownp = 0;
  int max_count = 0, owned = 0;  // kSummary only
  for (int w0 = 0; w0 < p.T; w0 += kSub) {
    const int nt = min(kSub, p.T - w0);
    int at[kSub], rl[kSub];  // this stretch's att/rel rows of the lane's cell
#pragma unroll
    for (int tau = 0; tau < kSub; ++tau) {
      const size_t i = static_cast<size_t>(w0 + tau) * N + n;
      at[tau] = live && tau < nt ? __ldg(att + i) : -1;
      rl[tau] = live && tau < nt ? __ldg(rel + i) : -1;
    }
    __syncwarp();  // the warp has read the stretch before
    const int n_up = nt * A, n_pclk = nt * P;
#pragma unroll 4
    for (int i = lane; i < n_up + n_pclk + n_up; i += 32) {
      if (i < n_up)
        s_up[i] = __ldg(up + static_cast<size_t>(w0) * A + i);
      else if (i < n_up + n_pclk)
        s_pclk[i - n_up] = __ldg(pclk + static_cast<size_t>(w0) * P + i - n_up);
      else
        s_aclk[i - n_up - n_pclk] = __ldg(aclk + static_cast<size_t>(w0) * A + i - n_up - n_pclk);
    }
    if (w0 == 0 && live) {  // the start state, its loads in flight with the ones above
#pragma unroll
      for (int a = 0; a < A; ++a) {
        promised[a] = g.in[0][static_cast<size_t>(a) * N + n];
        acc_lease[a] = g.in[1][static_cast<size_t>(a) * N + n];
      }
      own_id = g.in[2][n];
      ownp = g.in[3][n];
    }
    __syncwarp();
    if (!live) continue;
#pragma unroll
    for (int tau = 0; tau < kSub; ++tau) {
      if (tau >= nt) break;
      const int cnt = sync_tick<A>(promised, acc_lease, own_id, ownp, p.t0 + w0 + tau,
                                   at[tau], rl[tau], s_up + tau * A, s_pclk + tau * P,
                                   s_aclk + tau * A, p);
      if (OUT == kSummary) {
        max_count = max(max_count, cnt);
        owned += own_id >= 0 ? 1 : 0;
      } else {
        const size_t i = (b * T + w0 + tau) * N + n;
        g.owners[i] = own_id;
        g.counts[i] = cnt;
      }
    }
  }
  if (OUT == kSummary && live) {
    const size_t j = b * N + n;
    g.max_count[j] = max_count;
    g.owned[j] = owned;
    g.final_owner[j] = own_id;
  }
}

// ------------------------------------------------------------- launchers
// The geometry of a launch comes from the caller's launch plan
// (kernel.LaunchPlan in the Python wrapper, the one description of it): the
// launchers launch exactly that grid, block and shared memory, and refuse
// (cudaErrorInvalidValue) a plan that disagrees with the layout compiled
// here: the words a window stages a tick, kBlock, kBatchWarps and kSub, the
// lanes a cell, a grid that does not cover the cells or the scenarios.
struct Geometry {
  dim3 grid;
  int threads;
  size_t bytes;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A one-cell-a-thread block (delayed_window_kernel, sync_window_kernel):
// whole warps, at most kBlock threads, the grid covering the N cells, and
// `words` staged a tick for tw ticks.
bool cell_plan_ok(const Geometry& geo, const Params& p, size_t words) {
  return geo.threads >= 32 && geo.threads <= kBlock && geo.threads % 32 == 0 &&
         p.tw >= 1 && static_cast<long long>(geo.grid.x) * geo.threads >= p.N &&
         geo.grid.y == 1 && geo.grid.z == 1 &&
         geo.bytes == words * static_cast<size_t>(p.tw) * sizeof(int);
}

template <int A, bool EXT, bool CORRUPT, bool RESTART>
cudaError_t launch_delayed(const DelayedArgs& g, const Params& p,
                           const Geometry& geo, cudaStream_t stream) {
  // the shared-memory columns of delayed_window_kernel, a tick
  const size_t words = 2 * A + p.P + p.P * A + (CORRUPT ? 2 * A : 0) +
                       (RESTART ? 2 * A + 2 * p.P : 0);
  if (!cell_plan_ok(geo, p, words)) return cudaErrorInvalidValue;
  auto kernel = delayed_window_kernel<A, EXT, CORRUPT, RESTART, kSingle>;
  cudaError_t err = allow_smem(kernel, geo.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<geo.grid, geo.threads, geo.bytes, stream>>>(g, p);
  return cudaGetLastError();
}

// The lanes a cell of delayed_batched_kernel is built for at A acceptors:
// the powers of two up to the first at or above A (at most kMaxLanes).
constexpr int lane_cap(int a) {
  int lanes = 1;
  while (lanes < a && lanes < kMaxLanes) lanes *= 2;
  return lanes;
}

// A tile of delayed_batched_kernel is a warp where a scenario's N * G lanes,
// rounded up to a warp, fill less than a block, else the block: its warps.
int lane_tile_warps(int n_cells, int lanes) {
  const long long warps = (static_cast<long long>(n_cells) * lanes + 31) / 32;
  return warps < kBlock / 32 ? 1 : kBlock / 32;
}

template <int A, int G, bool EXT, bool CORRUPT, bool RESTART>
cudaError_t launch_delayed_batched(const DelayedArgs& g, const Params& p, int batch,
                                   const Geometry& geo, cudaStream_t stream) {
  // the shared-memory columns of a tile of delayed_batched_kernel, a tick
  // (delayed_window_kernel's); kBlock / tile lanes tiles a block, G lanes a
  // cell, at most kSub ticks a window; the grid covers the batch's tiles
  const size_t words = 2 * A + p.P + p.P * A + (CORRUPT ? 2 * A : 0) +
                       (RESTART ? 2 * A + 2 * p.P : 0);
  const int warps = lane_tile_warps(p.N, G), per_block = kBlock / (32 * warps);
  const long long tiles = static_cast<long long>(batch) * ((p.N + 32 * warps / G - 1) /
                                                           (32 * warps / G));
  if (geo.threads != kBlock || p.tw < 1 || p.tw > kSub ||
      static_cast<long long>(geo.grid.x) * per_block < tiles || geo.grid.y != 1 ||
      geo.grid.z != 1 ||
      geo.bytes != per_block * words * static_cast<size_t>(p.tw) * sizeof(int))
    return cudaErrorInvalidValue;
  auto kernel = delayed_batched_kernel<A, G, EXT, CORRUPT, RESTART>;
  cudaError_t err = allow_smem(kernel, geo.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<geo.grid, geo.threads, geo.bytes, stream>>>(g, p, batch, warps,
                                                       static_cast<int>(words));
  return cudaGetLastError();
}

// the optional plane groups a delayed launch carries (its EXT, CORRUPT and
// RESTART template flags: a launch without them runs no code for them)
int plane_variant(const DelayedArgs& g) {
  return (g.ext != nullptr ? 1 : 0) | (g.stale != nullptr ? 2 : 0) |
         (g.arst != nullptr ? 4 : 0);
}

template <int A>
cudaError_t launch_delayed(const DelayedArgs& g, const Params& p,
                           const Geometry& geo, cudaStream_t stream) {
  switch (plane_variant(g)) {
    case 0: return launch_delayed<A, false, false, false>(g, p, geo, stream);
    case 1: return launch_delayed<A, true, false, false>(g, p, geo, stream);
    case 2: return launch_delayed<A, false, true, false>(g, p, geo, stream);
    case 3: return launch_delayed<A, true, true, false>(g, p, geo, stream);
    case 4: return launch_delayed<A, false, false, true>(g, p, geo, stream);
    case 5: return launch_delayed<A, true, false, true>(g, p, geo, stream);
    case 6: return launch_delayed<A, false, true, true>(g, p, geo, stream);
    default: return launch_delayed<A, true, true, true>(g, p, geo, stream);
  }
}

template <int A, int G>
cudaError_t launch_delayed_batched(const DelayedArgs& g, const Params& p, int batch,
                                   const Geometry& geo, cudaStream_t stream) {
  switch (plane_variant(g)) {
    case 0: return launch_delayed_batched<A, G, false, false, false>(g, p, batch, geo, stream);
    case 1: return launch_delayed_batched<A, G, true, false, false>(g, p, batch, geo, stream);
    case 2: return launch_delayed_batched<A, G, false, true, false>(g, p, batch, geo, stream);
    case 3: return launch_delayed_batched<A, G, true, true, false>(g, p, batch, geo, stream);
    case 4: return launch_delayed_batched<A, G, false, false, true>(g, p, batch, geo, stream);
    case 5: return launch_delayed_batched<A, G, true, false, true>(g, p, batch, geo, stream);
    case 6: return launch_delayed_batched<A, G, false, true, true>(g, p, batch, geo, stream);
    default: return launch_delayed_batched<A, G, true, true, true>(g, p, batch, geo, stream);
  }
}

// G lanes a cell: 1, 2, 4 or 8, no more than lane_cap(A) (no other is built)
template <int A>
cudaError_t launch_delayed_batched(const DelayedArgs& g, const Params& p, int batch,
                                   const Geometry& geo, int lanes, cudaStream_t stream) {
  if (lanes == 1) return launch_delayed_batched<A, 1>(g, p, batch, geo, stream);
  if constexpr (lane_cap(A) >= 2)
    if (lanes == 2) return launch_delayed_batched<A, 2>(g, p, batch, geo, stream);
  if constexpr (lane_cap(A) >= 4)
    if (lanes == 4) return launch_delayed_batched<A, 4>(g, p, batch, geo, stream);
  if constexpr (lane_cap(A) >= 8)
    if (lanes == 8) return launch_delayed_batched<A, 8>(g, p, batch, geo, stream);
  return cudaErrorInvalidValue;
}

template <int A>
cudaError_t launch_sync(const SyncArgs& g, const Params& p, const Geometry& geo,
                        cudaStream_t stream) {
  // the shared-memory columns of sync_window_kernel, a tick
  const size_t words = 2 * A + p.P;
  if (!cell_plan_ok(geo, p, words)) return cudaErrorInvalidValue;
  auto kernel = sync_window_kernel<A>;
  cudaError_t err = allow_smem(kernel, geo.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<geo.grid, geo.threads, geo.bytes, stream>>>(g, p);
  return cudaGetLastError();
}

template <int A, int OUT>
cudaError_t launch_sync_batched(const SyncArgs& g, const Params& p, int batch,
                                const Geometry& geo, cudaStream_t stream) {
  // kBatchWarps warps a block, each a 32-cell tile staging its own kSub
  // ticks of these shared-memory columns; the grid covers the batch's tiles
  const size_t words = 2 * A + p.P;
  const long long tiles = static_cast<long long>(batch) * ((p.N + 31) / 32);
  if (geo.threads != 32 * kBatchWarps || p.tw != kSub ||
      static_cast<long long>(geo.grid.x) * kBatchWarps < tiles || geo.grid.y != 1 ||
      geo.grid.z != 1 ||
      geo.bytes != kBatchWarps * words * static_cast<size_t>(kSub) * sizeof(int))
    return cudaErrorInvalidValue;
  auto kernel = sync_batched_kernel<A, OUT>;
  cudaError_t err = allow_smem(kernel, geo.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<geo.grid, geo.threads, geo.bytes, stream>>>(g, p, batch);
  return cudaGetLastError();
}

Params params_from(const int* ints) {
  Params p;
  p.N = ints[0];
  p.T = ints[1];
  p.P = ints[3];
  p.t0 = ints[4];
  p.tw = ints[5];
  p.majority = ints[6];
  p.lease_q4 = ints[7];
  p.round_q4 = ints[8];
  p.guard_q4 = ints[9];
  p.skip_stable = ints[10];
  return p;
}

Geometry geometry_from(const int* ints) {
  Geometry geo;
  geo.grid = dim3(static_cast<unsigned>(ints[13]), static_cast<unsigned>(ints[14]));
  geo.threads = ints[15];
  geo.bytes = static_cast<size_t>(ints[16]);
  return geo;
}

DelayedArgs delayed_args(const void* const* ptrs) {
  DelayedArgs g;
  for (int i = 0; i < 16; ++i) {
    g.in[i] = static_cast<const int*>(ptrs[i]);
    g.out[i] = static_cast<int*>(const_cast<void*>(ptrs[16 + i]));
  }
  g.att = static_cast<const int*>(ptrs[32]);
  g.rel = static_cast<const int*>(ptrs[33]);
  g.ext = static_cast<const int*>(ptrs[34]);
  g.up = static_cast<const int*>(ptrs[35]);
  g.pclk = static_cast<const int*>(ptrs[36]);
  g.aclk = static_cast<const int*>(ptrs[37]);
  g.link = static_cast<const int*>(ptrs[38]);
  g.stale = static_cast<const int*>(ptrs[39]);
  g.equiv = static_cast<const int*>(ptrs[40]);
  g.arst = static_cast<const int*>(ptrs[41]);
  g.deaf = static_cast<const int*>(ptrs[42]);
  g.prst = static_cast<const int*>(ptrs[43]);
  g.prc = static_cast<const int*>(ptrs[44]);
  g.owners = static_cast<int*>(const_cast<void*>(ptrs[45]));
  g.counts = static_cast<int*>(const_cast<void*>(ptrs[46]));
  g.ticked = static_cast<unsigned long long*>(const_cast<void*>(ptrs[47]));
  g.max_count = g.owned = g.final_owner = nullptr;
  return g;
}

SyncArgs sync_args(const void* const* ptrs) {
  SyncArgs g;
  for (int i = 0; i < 4; ++i) {
    g.in[i] = static_cast<const int*>(ptrs[i]);
    g.out[i] = static_cast<int*>(const_cast<void*>(ptrs[4 + i]));
  }
  g.att = static_cast<const int*>(ptrs[8]);
  g.rel = static_cast<const int*>(ptrs[9]);
  g.up = static_cast<const int*>(ptrs[10]);
  g.pclk = static_cast<const int*>(ptrs[11]);
  g.aclk = static_cast<const int*>(ptrs[12]);
  g.owners = static_cast<int*>(const_cast<void*>(ptrs[13]));
  g.counts = static_cast<int*>(const_cast<void*>(ptrs[14]));
  g.max_count = g.owned = g.final_owner = nullptr;
  return g;
}

// A batched launch writes no final state; in summary mode no owner or
// count rows either, the three [B, N] summary planes instead.
template <typename Args>
bool batch_args(Args& g, const void* const* summary, int batch,
                int collect_summary) {
  if (batch < 1 || batch > kMaxBatch) return false;
  if (collect_summary) {
    g.owners = g.counts = nullptr;
    g.max_count = static_cast<int*>(const_cast<void*>(summary[0]));
    g.owned = static_cast<int*>(const_cast<void*>(summary[1]));
    g.final_owner = static_cast<int*>(const_cast<void*>(summary[2]));
  }
  return true;
}

}  // namespace

// C entry points (bound with ctypes). `ptrs` is a host array of device
// pointers in the order documented in kernel.py; `ints` holds
// (N, T, A, P, t0, tw, majority, lease_q4, round_q4, guard_q4, skip_stable,
// B, collect_summary, grid.x, grid.y, threads, shared bytes, lanes), A
// equal to this library's LEASE_ACCEPTORS, B 1 and collect_summary 0 for
// the unbatched entries, the last five the launch plan's (lanes a cell:
// read by the batched delayed entry alone). Each returns
// cudaErrorInvalidValue for a plan it refuses, else cudaGetLastError()
// after its launch (0 = launched).
extern "C" int lease_window_delayed(const void* const* ptrs, const int* ints,
                                    void* stream) {
  const DelayedArgs g = delayed_args(ptrs);
  const Params p = params_from(ints);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[2] != kA || ints[11] != 1 || ints[12] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_delayed<kA>(g, p, geometry_from(ints), st));
}

extern "C" int lease_window_sync(const void* const* ptrs, const int* ints,
                                 void* stream) {
  const SyncArgs g = sync_args(ptrs);
  const Params p = params_from(ints);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[2] != kA || ints[11] != 1 || ints[12] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_sync<kA>(g, p, geometry_from(ints), st));
}

// The batched entries: the same pointer layout with the 16 (delayed) or 4
// (sync) state-out slots ignored, then max_count, owned, final_owner
// ([B, N] each; read only in summary mode) at ptrs[48..50] (delayed) or
// ptrs[15..17] (sync); the per-scenario planes and, unless summary, the
// owner and count rows are [B, T, ...].
extern "C" int lease_window_delayed_batched(const void* const* ptrs,
                                            const int* ints, void* stream) {
  DelayedArgs g = delayed_args(ptrs);
  const Params p = params_from(ints);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[2] != kA || !batch_args(g, ptrs + 48, ints[11], ints[12]))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_delayed_batched<kA>(g, p, ints[11], geometry_from(ints), ints[17], st));
}

extern "C" int lease_window_sync_batched(const void* const* ptrs,
                                         const int* ints, void* stream) {
  SyncArgs g = sync_args(ptrs);
  const Params p = params_from(ints);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[2] != kA || !batch_args(g, ptrs + 15, ints[11], ints[12]))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = geometry_from(ints);
  return static_cast<int>(ints[12] ? launch_sync_batched<kA, kSummary>(g, p, ints[11], geo, st)
                                   : launch_sync_batched<kA, kRows>(g, p, ints[11], geo, st));
}
