// Phase A2 in one launch for Hopper (the super walk, SW): every ray's
// super portals expanded into the treelet portals inside them and merged
// into its sorted treelet list.
//
// Replaces the rounds of the JAX package's A2 in `_render_jit`
// (bvh_tpu/traverse/wide_treelet.py:1740-1873): K2 supers a ray and
// round, one B4 walk (`_collect_core`, :1158) a (ray, super) pair, and a
// stable merge of the round's records into each ray's list by entry t,
// cut at MP. The port ran those rounds from the host (`expand_supers`),
// each a sort of its pairs by super, a B4 launch, a merge launch
// (csrc/portal_sort.cu), three host reads and about 55 glue operations,
// 14 to 22 rounds a frame at the San-Miguel-class scene.
//
// It leaves exactly what the rounds leave, without running rounds:
// - A round walks each pair at the ray's own tmax, which A2 never lowers,
//   so every (ray, super) walk is independent of the rounds.
// - A run of stable merges, each cut at MP, equals one stable merge of
//   every record cut at MP: records order by radix key, then by (round,
//   record, slot in the round), after the list's equal keys; a round's
//   slots that hold no record are +inf padding, as in the rounds.
// - The rounds retire a column after the first round in which one of its
//   pairs recorded more than max_new or overflowed the stack, or its
//   merged list's finite count (before the cut) passed max_portals; that
//   round's merge still happens. A round's finite count follows from
//   counts alone: of the F finite and A -inf/-NaN keys of the list and of
//   every record merged before the round, the list holds
//   min(max(MP - A, 0), F) finite ones, since those keys sort first.
// So a column's walks come first, then its rounds' counts decide the
// round it stops after, then the records of the rounds that ran are
// merged once.
//
// What bounds it: B4's dependent walk steps, a 64-byte row each, as in
// the rounds; the bytes (rays, super lists, the lists read and written
// once, the super rows visited) take a small part of that. The design:
// - Warps take 32 consecutive columns at a time from a global counter,
//   or fewer where the columns would not give each warp the card holds
//   a share: a re-run attempt's few columns are the rays with the most
//   supers, and a warp works its columns one after another (on a 10M
//   re-run of 18,087 columns, 1.8 ms in windows of 7 against 6.9 in
//   windows of 32; H100 80GB HBM3 at 700 W). A warp packs the supers of
//   as many of its columns as fit into its `lanes` lanes, one (ray,
//   super) pair a lane, so that few lanes idle where rays hold a few
//   supers each; a column with more supers is walked alone, `lanes`
//   supers (lanes / K2 rounds) at a time. Each lane
//   walks its pair with B4's walk (`walk_super`, collect_step.cuh) and
//   stages its first max_new records in its region of the warp's shared
//   memory (`lanes` x max_new <= kRecords).
// - Then the warp takes the packed columns one by one: warp reductions
//   over the column's lanes give each round's counts and the round it
//   stops after; each staged record of the rounds that ran gets its slot
//   from the count of the list's keys and records ahead of it, ranked by
//   shuffles as portal_sort.cu's `merge_ray_by_warp` ranks one round's;
//   the list's portals move down past the new keys below them, walked
//   from the list's end so that nothing is overwritten before it is
//   read; then the records are written.
// - One stats row (the work counter, the most supers a ray recorded, the
//   most records a pair made, the longest merged list, the flags, the
//   pairs walked) takes the warps' maxima and flags, and is read once,
//   after the launch.
// Measured and dropped (PERF.md): merging a column whose list is empty
// by its own lane while the warp's other lanes merge theirs (-6% at 10M
// interior, +2% on diffuse rays at 8 records a lane, +52% at 32).

#include <cuda_runtime.h>
#include <stdint.h>

#include "collect_step.cuh"
#include "portal_key.cuh"

namespace {

using bvh::finite_key;
using bvh::kInfKey;
using bvh::kNegInfKey;
using bvh::radix_key;

constexpr int kWarps = 4;                     // warps a block
constexpr int kBlock = 32 * kWarps;
constexpr int kRecords = BVH_SUPER_WALK_RECORDS;  // staged a warp; kernels.py
constexpr unsigned kFull = 0xffffffffu;

// the stats row
enum { kNext, kMaxSup, kMaxRec, kMaxLen, kFlags, kSupOvf, kPairs, kStats };

struct Args {
    const float4* sup_cols;  // [S, Ps, 16] super rows
    int Ps;
    const int* sid;          // [mps, Rc] each column's supers, entry order
    const int* nsup;         // [Rc] supers a column recorded (past mps)
    int mps;
    const float* rays;       // [8, Rc]
    long long* tid;          // [MP, Rc] treelet lists, merged in place
    float* tent;
    int* tlen;               // [Rc] their lengths
    int MP, Rc;
    const bool* gone;        // [Rc] columns that take no expansion, or null
    int stack_depth, max_new, max_portals, k2, lanes;
    int window;              // columns a warp takes at a time
    bool* cols;              // [Rc] out: gone, or retired past a cap
    int* stats;              // [kStats], zero at the launch
};

// One warp's shared memory: the staged records (lane i's in slots
// [i * max_new, (i + 1) * max_new)), each record's merged slot, and the
// packing of the columns into lanes.
struct Staging {
    float t[kRecords];
    int id[kRecords];
    unsigned short dest[kRecords];
    int incl[32];            // inclusive prefix of the lanes' records
    int start[32];           // a packed column's first lane
    unsigned char owner[32]; // a lane's column (its lane in the window)
};

// A column's list (its length and its portals) and the finite and low
// (-inf, -NaN) keys of the list and of every record merged into it.
struct Column {
    long long c;
    int lo, nold, fin, low;
};

// What the warp saw, for the stats row (the same in every lane).
struct Seen {
    int max_rec = 0, max_len = 0, flags = 0, sup_ovf = 0, pairs = 0;
};

__device__ __forceinline__ int warp_sum(int v) {
    return __reduce_add_sync(kFull, v);
}

__device__ __forceinline__ int warp_max(int v) {
    return __reduce_max_sync(kFull, v);
}

// Column c's list of length lo (most lists are empty before A2 at the
// San-Miguel-class scene: then nothing is read).
__device__ Column read_column(const Args& a, long long c, int lo, int lane) {
    if (lo == 0) return {c, 0, 0, 0, 0};
    const size_t Rc = a.Rc;
    int nold = 0, fin = 0, low = 0;
    for (int o = lane; o < lo; o += 32) {
        const unsigned k = radix_key(a.tent[o * Rc + c]);
        nold += a.tid[o * Rc + c] != -1;
        fin += finite_key(k);
        low += k <= kNegInfKey;
    }
    return {c, lo, warp_sum(nold), warp_sum(fin), warp_sum(low)};
}

// The staged records of one column's rounds: lane L0 + i walked its
// super s0 + i and holds `rec` records of the merge (0 in other lanes).
struct Records {
    const Args& a;
    Staging& s;
    int L0, s0, ra;

    // record e (0 <= e < the records): its slot in the staging, and its
    // key and place q in the rounds' order, (round, record, slot)
    __device__ __forceinline__ int at(int e, unsigned& key, int& q) const {
        int i = 0;
        for (int step = 16; step > 0; step >>= 1)
            if (s.incl[i + step - 1] <= e) i += step;
        const int m = e - (i ? s.incl[i - 1] : 0);
        const int sup = s0 + i - L0;
        const int r = sup / a.k2;
        q = (r - ra) * a.k2 * a.max_new + m * a.k2 + (sup - r * a.k2);
        const int slot = i * a.max_new + m;
        key = radix_key(s.t[slot]);
        return slot;
    }
};

// Merge one column's records of `nr` rounds (`rec` of them in this lane,
// see Records) into its list, in place: the stable merge of the list's MP
// slots followed by the rounds' nr x k2 x max_new slots (the records,
// +inf padding in the rest), cut at MP.
__device__ void merge_column(const Args& a, Staging& s, Column& col,
                             const Records& recs, int rec, int nr,
                             int lane) {
    __syncwarp();   // the previous column's merge has read s.incl
    int incl = rec;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
    }
    s.incl[lane] = incl;
    __syncwarp();
    const int nn = __shfl_sync(kFull, incl, 31);
    if (nn == 0) return;   // only padding, which sorts past the list
    const size_t Rc = a.Rc;
    const long long c = col.c;
    const int lo = col.lo;
    const int npad = nr * a.k2 * a.max_new - nn;
    // 1. each record's slot: the list's keys at or below its own (the
    // list's padding too at +inf and above), the records ahead of it, and
    // at +inf the rounds' padding slots before it (past +inf all of them)
    int slot0 = 0;   // the staging slot of record `lane`
    for (int eb = 0; eb < nn; eb += 32) {
        const int e = eb + lane;
        unsigned ke = 0;
        int qe = 0, slot = 0;
        if (e < nn) slot = recs.at(e, ke, qe);
        if (eb == 0) slot0 = slot;
        int new_ahead = 0, rows_ahead = 0, old_le = 0;
        for (int fb = 0; fb < nn; fb += 32) {
            unsigned kf = ke;
            int qf = qe;
            if (fb != eb && fb + lane < nn) recs.at(fb + lane, kf, qf);
            const int cnt = min(32, nn - fb);
            for (int l = 0; l < cnt; ++l) {
                const unsigned kl = __shfl_sync(kFull, kf, l);
                const int ql = __shfl_sync(kFull, qf, l);
                new_ahead += kl < ke || (kl == ke && ql < qe);
                rows_ahead += ql < qe;
            }
        }
        for (int ob = 0; ob < lo; ob += 32) {
            const int o = ob + lane;
            const bool real = o < lo && a.tid[o * Rc + c] != -1;
            const unsigned ko = real ? radix_key(a.tent[o * Rc + c]) : 0u;
            const int cnt = min(32, lo - ob);
            for (int l = 0; l < cnt; ++l) {
                const unsigned kl = __shfl_sync(kFull, ko, l);
                const bool rl = __shfl_sync(kFull, real, l);
                old_le += rl && kl <= ke;
            }
        }
        if (e < nn) {
            if (ke >= kInfKey) old_le += a.MP - col.nold;
            const int pads = ke > kInfKey ? npad
                           : ke == kInfKey ? qe - rows_ahead : 0;
            s.dest[slot] = static_cast<unsigned short>(
                min(old_le + new_ahead + pads, 0xffff));
        }
    }
    __syncwarp();
    int last = -1, kept = 0;
    // 2. the list's portals, from its end down, each past the new keys
    // below its own (past +inf, the padding too)
    for (int ob = lo > 0 ? (lo - 1) & ~31 : -32; ob >= 0; ob -= 32) {
        const int o = ob + lane;
        const long long id = o < lo ? a.tid[o * Rc + c] : -1;
        const bool real = id != -1;
        const float t = real ? a.tent[o * Rc + c] : 0.0f;
        const unsigned ko = radix_key(t);
        int shift = 0;
        for (int fb = 0; fb < nn; fb += 32) {
            unsigned kf = 0;
            int qf = 0;
            if (fb + lane < nn) recs.at(fb + lane, kf, qf);
            const int cnt = min(32, nn - fb);
            for (int l = 0; l < cnt; ++l)
                shift += __shfl_sync(kFull, kf, l) < ko;
        }
        if (ko > kInfKey) shift += npad;
        const int d = o + shift;
        __syncwarp();
        if (real && shift > 0) {
            a.tid[o * Rc + c] = -1;
            a.tent[o * Rc + c] = bvh::pos_inf();
        }
        __syncwarp();
        if (real && d < a.MP) {
            if (shift > 0) {
                a.tid[d * Rc + c] = id;
                a.tent[d * Rc + c] = t;
            }
            last = max(last, d);
            ++kept;
        }
        __syncwarp();
    }
    // 3. the records
    for (int e = lane; e < nn; e += 32) {
        unsigned ke;
        int qe;
        const int slot = e == lane ? slot0 : recs.at(e, ke, qe);
        const int d = s.dest[slot];
        if (d < a.MP) {
            a.tid[d * Rc + c] = s.id[slot];
            a.tent[d * Rc + c] = s.t[slot];
            last = max(last, d);
            ++kept;
        }
    }
    col.lo = warp_max(last) + 1;
    col.nold = warp_sum(kept);
}

// One column's rounds ra .. rb - 1, whose supers s0 .. s0 + n - 1 lanes
// L0 .. L0 + n - 1 walked (s0 a multiple of k2; pcnt, ovf, fin, low are
// this lane's pair's records, overflow, and finite and low staged keys):
// each round's counts, read from the lanes, into `seen`, until the round
// the column stops after; then the merge of the rounds that ran. Returns
// whether the column stopped.
__device__ bool column_rounds(const Args& a, Staging& s, Column& col,
                              Seen& seen, int L0, int n, int s0, int pcnt,
                              int ovf, int fin, int low, int lane) {
    const bool mine = lane >= L0 && lane < L0 + n;
    const int rl = mine ? (s0 + lane - L0) / a.k2 : -1;
    const int ra = s0 / a.k2, rb = (s0 + n + a.k2 - 1) / a.k2;
    bool stop = false;
    int r = ra;
    for (; r < rb; ++r) {
        const bool in = rl == r;
        const int fr = warp_sum(in ? fin : 0);
        const int lr = warp_sum(in ? low : 0);
        const int most = warp_max(in ? pcnt : 0);
        const bool deep = __any_sync(kFull, in && ovf != 0);
        const int fcnt = min(max(a.MP - col.low, 0), col.fin) + fr;
        seen.pairs += __popc(__ballot_sync(kFull, in));
        seen.max_rec = max(seen.max_rec, most);
        seen.max_len = max(seen.max_len, fcnt);
        col.fin += fr;
        col.low += lr;
        if (most > a.max_new) {
            seen.flags |= 2;
            stop = true;
        }
        if (deep) {
            seen.sup_ovf = 1;
            stop = true;
        }
        if (fcnt > a.max_portals) {
            seen.flags |= 4;
            stop = true;
        }
        if (stop) break;
    }
    const int nr = (stop ? r + 1 : rb) - ra;
    const int rec = mine && rl < ra + nr ? min(pcnt, a.max_new) : 0;
    merge_column(a, s, col, Records{a, s, L0, s0, ra}, rec, nr, lane);
    return stop;
}

// Lane `lane` walks super `sidx` of column c, staging its records in
// its region: its record count (past max_new), overflow, and finite and
// low staged keys.
template <bool Robust>
__device__ void walk_pair(const Args& a, Staging& s, long long c, int sidx,
                          int lane, int& pcnt, int& ovf, int& fin,
                          int& low) {
    const size_t Rc = a.Rc;
    float o[3], d[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        o[i] = a.rays[i * Rc + c];
        d[i] = a.rays[(3 + i) * Rc + c];
    }
    const float tmin = a.rays[6 * Rc + c];
    const float tmax = a.rays[7 * Rc + c];
    const bvh::RayInv ray = bvh::make_ray_inv(o, d, Robust);
    const int sup = a.sid[sidx * Rc + c];
    const float4* table = a.sup_cols + static_cast<size_t>(sup) * a.Ps * 4;
    const int base = lane * a.max_new;
    bvh::walk_super<Robust>(
        table, ray, tmin, tmax, a.stack_depth, ovf, [&](int word, float t) {
            if (pcnt < a.max_new) {
                s.t[base + pcnt] = t;
                s.id[base + pcnt] = word >> 4;
                const unsigned k = radix_key(t);
                fin += finite_key(k);
                low += k <= kNegInfKey;
            }
            ++pcnt;
        });
}

template <bool Robust>
__global__ void __launch_bounds__(kBlock) super_walk_kernel(Args a) {
    __shared__ Staging staging[kWarps];
    const int lane = threadIdx.x & 31;
    Staging& s = staging[threadIdx.x >> 5];
    Seen seen;
    int max_sup = 0;
    for (;;) {
        int c0 = 0;
        if (lane == 0) c0 = atomicAdd(a.stats + kNext, a.window);
        c0 = __shfl_sync(kFull, c0, 0);
        if (c0 >= a.Rc) break;
        // this lane's column of the window: its supers, and whether it
        // takes no expansion (gone, or past mps)
        const int c = c0 + lane;
        const bool in = lane < a.window && c < a.Rc;
        const int n = in ? a.nsup[c] : 0;
        const int lo = in ? a.tlen[c] : 0;
        max_sup = max(max_sup, n);
        bool out = in && ((a.gone != nullptr && a.gone[c]) || n > a.mps);
        const int work = in && !out ? n : 0;
        int pre = work;   // inclusive prefix of the window's supers
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(kFull, pre, d);
            if (lane >= d) pre += v;
        }
        unsigned todo = __ballot_sync(kFull, work > 0);
        while (todo) {
            const int w0 = __ffs(todo) - 1;
            const int n0 = __shfl_sync(kFull, work, w0);
            int pcnt = 0, ovf = 0, fin = 0, low = 0;
            if (n0 > a.lanes) {
                // alone, `lanes` supers at a time
                Column col = read_column(a, c0 + w0,
                                         __shfl_sync(kFull, lo, w0), lane);
                bool stop = false;
                for (int s0 = 0; s0 < n0 && !stop; s0 += a.lanes) {
                    const int nl = min(a.lanes, n0 - s0);
                    pcnt = ovf = fin = low = 0;
                    if (lane < nl)
                        walk_pair<Robust>(a, s, col.c, s0 + lane, lane, pcnt,
                                          ovf, fin, low);
                    __syncwarp();
                    stop = column_rounds(a, s, col, seen, 0, nl, s0, pcnt,
                                         ovf, fin, low, lane);
                    __syncwarp();
                }
                if (lane == 0) a.tlen[col.c] = col.lo;
                if (lane == w0) out = stop;
                todo &= todo - 1;
                continue;
            }
            // w0 and the next columns whose supers fit the lanes with its
            const int base = __shfl_sync(kFull, pre, w0) - n0;
            const unsigned fit =
                __ballot_sync(kFull, lane >= w0 && pre - base <= a.lanes) &
                todo;
            const int total =
                __shfl_sync(kFull, pre, 31 - __clz(fit)) - base;
            if ((fit >> lane) & 1) {
                s.start[lane] = pre - work - base;
                for (int k = pre - work - base; k < pre - base; ++k)
                    s.owner[k] = static_cast<unsigned char>(lane);
            }
            __syncwarp();
            if (lane < total) {
                const int w = s.owner[lane];
                walk_pair<Robust>(a, s, c0 + w, lane - s.start[w], lane,
                                  pcnt, ovf, fin, low);
            }
            __syncwarp();
            for (unsigned m = fit; m; m &= m - 1) {
                const int w = __ffs(m) - 1;
                Column col = read_column(a, c0 + w,
                                         __shfl_sync(kFull, lo, w), lane);
                const bool stop = column_rounds(
                    a, s, col, seen, s.start[w], __shfl_sync(kFull, work, w),
                    0, pcnt, ovf, fin, low, lane);
                if (lane == 0) a.tlen[col.c] = col.lo;
                if (lane == w) out = stop;
            }
            __syncwarp();
            todo &= ~fit;
        }
        if (in) a.cols[c] = out;
    }
    max_sup = warp_max(max_sup);
    if (lane == 0) {
        atomicMax(a.stats + kMaxSup, max_sup);
        atomicMax(a.stats + kMaxRec, seen.max_rec);
        atomicMax(a.stats + kMaxLen, seen.max_len);
        if (seen.flags) atomicOr(a.stats + kFlags, seen.flags);
        if (seen.sup_ovf) atomicOr(a.stats + kSupOvf, 1);
        atomicAdd(a.stats + kPairs, seen.pairs);
    }
}

}  // namespace

// sup_cols [S, Ps, 16] f32, 16-byte aligned (B4's rows); sid [mps, Rc]
// i32 and nsup [Rc] i32 (the split's super lists and counts); rays
// [8, Rc] f32; tid [MP, Rc] i64, tent [MP, Rc] f32 and tlen [Rc] i32, the
// treelet lists and their lengths, merged in place; gone: null, or [Rc]
// bools, columns that take no expansion; `lanes` (a multiple of k2 of at
// most 32, lanes x max_new <= the staging's records) the supers a warp
// walks at once; MP <= 65535. Outputs: cols [Rc] bools (gone, past mps,
// or retired past max_new, max_portals or the stack), stats [7] i32
// (zeroed here on the stream: the work counter, the most supers a column
// recorded, the most records a walked pair made, the longest merged list
// before its cut, bit 2 past max_new | bit 4 past max_portals, a stack
// overflow, the pairs walked). Returns the first CUDA error of the
// launch, or cudaGetLastError() after it.
extern "C" int bvh_super_walk(const float* sup_cols, int Ps, const int* sid,
                              const int* nsup, int mps, const float* rays,
                              int Rc, long long* tid, float* tent, int* tlen,
                              int MP, const bool* gone, int robust,
                              int stack_depth, int max_new, int max_portals,
                              int k2, int lanes, bool* cols, int* stats,
                              void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(stats, 0, kStats * sizeof(int), st);
    if (err != cudaSuccess || Rc <= 0) return static_cast<int>(err);
    if (k2 < 1 || lanes < k2 || lanes > 32 || lanes % k2 != 0 ||
        max_new < 1 || lanes * max_new > kRecords || MP > 0xffff)
        return static_cast<int>(cudaErrorInvalidValue);
    int grid = 0;
    err = robust
        ? bvh::persistent_grid<super_walk_kernel<true>>(kBlock, grid)
        : bvh::persistent_grid<super_walk_kernel<false>>(kBlock, grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the columns a warp takes at a time: 32, or as many as give every
    // warp the card holds a share
    const int warps = grid * kWarps;
    const int window = min(32, max(1, (Rc + warps - 1) / warps));
    const int blocks =
        min(grid, ((Rc + window - 1) / window + kWarps - 1) / kWarps);
    const Args a{reinterpret_cast<const float4*>(sup_cols), Ps, sid, nsup,
                 mps, rays, tid, tent, tlen, MP, Rc, gone, stack_depth,
                 max_new, max_portals, k2, lanes, window, cols, stats};
    if (robust)
        super_walk_kernel<true><<<blocks, kBlock, 0, st>>>(a);
    else
        super_walk_kernel<false><<<blocks, kBlock, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
}
