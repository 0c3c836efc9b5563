// Portal ordering for Hopper: each ray's portal list sorted by entry
// distance after phase A (and, in two-level scenes, split into its
// supers and its treelets), and merged with phase A2's new treelet
// portals each A2 round.
//
// Replaces no TPU kernel: the JAX package orders portals with
// `jax.lax.sort` over padded [MP, Rc] columns (`_render_jit`,
// bvh_tpu/traverse/wide_treelet.py:1892, and its A2 merge :1840-1873),
// and so did the port, with torch.sort along dim 0. That sort reads every
// one of a ray's MP slots (PyTorch pads each to 128 or 1,024), at a
// stride of Rc, although a ray holds a handful to a few dozen portals:
// it took most of the render's device time. This kernel reads only each
// ray's records (phase A's count row says how many) and writes the same
// outputs, bit for bit.
//
// The order is the one torch.sort(stable=True) gives on the card, whose
// segmented sort is cub's radix sort: keys are the floats' bits as
// cub orders them (sign-flipped; -0.0 equal to +0.0, as cub's digit
// extractor makes them; -NaN first, +NaN last), equal keys in record
// order. Past a ray's count the lists hold -1 / +inf, which sort as
// records with key +inf placed after the real ones: so a record at +inf
// keeps its place before them, and a +NaN record goes after them.
//
// What bounds it: bytes. The outputs are MP x Rc slots of an int64 id
// and a float t (and in a two-level scene the [mps, Rc] super list), most
// of them padding, written once, slot by slot across a warp's rays so
// that the writes coalesce; the records read are a few percent of that.
// The design:
// - one thread a ray; a list of at most kCap records is sorted in that
//   thread's registers (an insertion whose every index is known at
//   compile time), so nothing but the records and the outputs touches
//   memory;
// - a longer list, or one with a record whose key reaches +inf (which
//   interleaves with the padding), is ordered after the block's short
//   ones by one warp of the block, chosen by the ray's own count on the
//   device: each lane ranks records by counting the keys before them,
//   the warp's keys passed round by shuffles, and writes each record to
//   its slot over the padding its thread wrote;
// - a merge moves only what changes: the new records go to their slots
//   and the old ones past them slide down by the number of new records
//   before them, walked from the list's end so that nothing is
//   overwritten before it is read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;                 // threads a block: a ray each
constexpr int kWarps = kBlock / 32;
constexpr int kCap = 16;                    // records a thread sorts alone
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfKey = 0xff800000u;   // key of +inf
constexpr unsigned kNegInfKey = 0x007fffffu;  // key of -inf
constexpr unsigned long long kEmpty = ~0ull;

// The float's bits as cub's radix sort orders them: the sign bit set
// for a positive float, every bit flipped for a negative one; -0.0 takes
// +0.0's key.
__device__ __forceinline__ unsigned radix_key(float t) {
    const unsigned b = __float_as_uint(t);
    const unsigned k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return k == 0x7fffffffu ? 0x80000000u : k;
}

__device__ __forceinline__ bool finite_key(unsigned k) {
    return k > kNegInfKey && k < kInfKey;
}

__device__ __forceinline__ float pos_inf() {
    return __int_as_float(0x7f800000);
}

// A sorted list of at most kCap (key, id, t) in registers: keys are
// unique (they carry the record's index), empty slots hold kEmpty, -1
// and +inf, so slot s of the list is the output's slot s.
struct RegList {
    unsigned long long k[kCap];
    int id[kCap];
    float t[kCap];

    __device__ __forceinline__ void clear() {
#pragma unroll
        for (int s = 0; s < kCap; ++s) {
            k[s] = kEmpty;
            id[s] = -1;
            t[s] = pos_inf();
        }
    }

    // Insert one entry: it passes every smaller key and pushes the rest
    // one slot on (the last one falls off: callers insert at most kCap).
    __device__ __forceinline__ void insert(unsigned long long ck, int ci,
                                           float ct) {
#pragma unroll
        for (int s = 0; s < kCap; ++s) {
            const bool sw = ck < k[s];
            const unsigned long long k0 = k[s];
            const int i0 = id[s];
            const float t0 = t[s];
            k[s] = sw ? ck : k0;
            id[s] = sw ? ci : i0;
            t[s] = sw ? ct : t0;
            ck = sw ? k0 : ck;
            ci = sw ? i0 : ci;
            ct = sw ? t0 : ct;
        }
    }
};

__device__ __forceinline__ int warp_sum(int v) {
    return __reduce_add_sync(kFull, v);
}

__device__ __forceinline__ int warp_max(int v) {
    return __reduce_max_sync(kFull, v);
}

// ---------------------------------------------------------------- sort
struct SortArgs {
    const int* ptid;      // [MP, R] phase A's records
    const float* ptent;
    const int* cnt;       // [R] records a ray made (past MP)
    int R, MP;
    const long long* sel; // [Rc] the rays, in output column order
    int Rc;
    int T;                // >= 0: split supers (tid >= T) off; < 0: sort
    int mps;
    long long* tid;       // [MP, Rc] the sorted (or treelet) list
    float* tent;
    int* sup;             // [mps, Rc] super list (split)
    int* nsup;            // [Rc] supers a ray recorded (split)
    int* tlen;            // [Rc] treelet list's length (split)
};

// A ray the block's threads left to a warp: every record ranked by the
// count of records before it in the order that decides its slot, the
// warp's keys handed round 32 at a time. The ray's thread already wrote
// padding over its whole column.
__device__ void sort_ray_by_warp(const SortArgs& a, int r, int lane) {
    const long long c = a.sel[r];
    const int n = min(a.cnt[c], a.MP);
    const bool split = a.T >= 0;
    const size_t R = a.R, Rc = a.Rc;
    int nsup = 0;
    if (split) {
        for (int i = lane; i < n; i += 32) nsup += a.ptid[i * R + c] >= a.T;
        nsup = warp_sum(nsup);
    }
    int last = -1;   // the treelet list's last filled slot
    for (int ib = 0; ib < n; ib += 32) {
        const int i = ib + lane;
        const bool have = i < n;
        const int id = have ? a.ptid[i * R + c] : -1;
        const float t = have ? a.ptent[i * R + c] : 0.0f;
        const unsigned ki = radix_key(t);
        const bool si = split && id >= a.T;
        int before = 0, before_same = 0;   // records ahead of record i
        for (int jb = 0; jb < n; jb += 32) {
            const int j = jb + lane;
            const unsigned kj = j < n ? radix_key(a.ptent[j * R + c]) : 0u;
            const bool sj = split && j < n && a.ptid[j * R + c] >= a.T;
            const int m = min(32, n - jb);
            for (int l = 0; l < m; ++l) {
                const unsigned kl = __shfl_sync(kFull, kj, l);
                const bool sl = __shfl_sync(kFull, sj, l);
                const bool ahead = kl < ki || (kl == ki && jb + l < i);
                before += ahead;
                before_same += ahead && sl == si;
            }
        }
        if (!have) continue;
        if (si) {                       // the super list, in entry order
            if (before_same < a.mps) a.sup[before_same * Rc + r] = id - a.T;
            continue;
        }
        // the slot among the padding (MP - n records at +inf after the
        // real ones) and, when splitting, among the supers, which take
        // key +inf in their sorted places
        int slot;
        if (!split)
            slot = before + (ki > kInfKey ? a.MP - n : 0);
        else if (ki < kInfKey)
            slot = before_same;
        else if (ki == kInfKey)
            slot = before;
        else
            slot = before_same + nsup + (a.MP - n);
        if (slot < a.MP) {
            a.tid[slot * Rc + r] = id;
            a.tent[slot * Rc + r] = t;
            last = max(last, slot);
        }
    }
    if (split) {
        last = warp_max(last);
        if (lane == 0) {
            a.nsup[r] = nsup;
            a.tlen[r] = last + 1;
        }
    }
}

__global__ void __launch_bounds__(kBlock)
portal_sort_kernel(SortArgs a) {
    __shared__ int queue[kBlock];
    __shared__ int queued;
    if (threadIdx.x == 0) queued = 0;
    __syncthreads();
    const int r = blockIdx.x * kBlock + threadIdx.x;
    const bool split = a.T >= 0;
    const size_t R = a.R, Rc = a.Rc;
    if (r < a.Rc) {
        const long long c = a.sel[r];
        const int n = min(a.cnt[c], a.MP);
        bool by_warp = n > kCap;
        int nsup = 0;
        RegList list;
        list.clear();
        if (!by_warp) {
            for (int j = 0; j < n; ++j) {
                const int id = a.ptid[j * R + c];
                const float t = a.ptent[j * R + c];
                const unsigned key = radix_key(t);
                const bool sup = split && id >= a.T;
                nsup += sup;
                // a +NaN record sorts past the padding; a treelet at +inf
                // interleaves with the supers that the split sets to +inf
                by_warp |= split ? (!sup && key >= kInfKey) : key > kInfKey;
                // treelets first, then supers; each by key, then record
                list.insert(static_cast<unsigned long long>(sup) << 63 |
                                static_cast<unsigned long long>(key) << 31 |
                                static_cast<unsigned>(j),
                            id, t);
            }
        }
        const int ntree = n - nsup;
        const int lim = by_warp ? 0 : (split ? ntree : n);
        // the list's slots, coalesced across the warp's rays; a ray left
        // to a warp gets padding here, its records later
#pragma unroll
        for (int s = 0; s < kCap; ++s) {
            if (s < a.MP) {
                const bool v = s < lim;
                a.tid[s * Rc + r] = v ? list.id[s] : -1;
                a.tent[s * Rc + r] = v ? list.t[s] : pos_inf();
            }
        }
        for (int s = kCap; s < a.MP; ++s) {
            a.tid[s * Rc + r] = -1;
            a.tent[s * Rc + r] = pos_inf();
        }
        if (split) {
            const int nput = by_warp ? 0 : min(nsup, a.mps);
#pragma unroll
            for (int s = 0; s < kCap; ++s) {
                const int k = s - ntree;
                if (k >= 0 && k < nput) a.sup[k * Rc + r] = list.id[s] - a.T;
            }
            for (int k = nput; k < a.mps; ++k) a.sup[k * Rc + r] = -1;
            if (!by_warp) {
                a.nsup[r] = nsup;
                a.tlen[r] = ntree;
            }
        }
        if (by_warp) queue[atomicAdd(&queued, 1)] = r;
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int q = warp; q < queued; q += kWarps)
        sort_ray_by_warp(a, queue[q], lane);
}

// --------------------------------------------------------------- merge
struct MergeArgs {
    long long* tid;        // [MP, Rc] treelet lists, merged in place
    float* tent;
    int* tlen;             // [Rc] their lengths
    int MP, Rc;
    const long long* rsel; // [Rr] the rays of this round (columns)
    int Rr;
    const int* pair;       // [k2, Rr] B4's pair of window slot j, or -1
    int k2;
    const int* ntid;       // [max_new, L] B4's records
    const float* nt;
    const int* ncnt;       // [L] records a pair made (past max_new)
    int L, max_new;
    int* dest;             // [max_new, L] scratch: a new record's slot
    int* fcnt;             // [Rr] merged finite count, before the cut
};

// Record e (0 <= e < the ray's new records) of ray r: its pair and
// record index, counting the pairs' records in window-slot order.
__device__ __forceinline__ void new_record(const MergeArgs& a, int r, int e,
                                           int& p, int& m, int& j) {
    for (j = 0; j < a.k2; ++j) {
        p = a.pair[j * a.Rr + r];
        const int cj = p < 0 ? 0 : min(a.ncnt[p], a.max_new);
        if (e < cj) break;
        e -= cj;
    }
    m = e;
}

// A ray the block's threads left to a warp. The merged order is that of
// the stable sort of the old list's MP slots followed by the
// max_new x k2 new slots (row m * k2 + j), where slots holding no portal
// are -1 / +inf; a slot's place is the count of slots ahead of it.
// The new records' places are computed first (into `dest`), then the
// old list is walked down from its end in steps of 32 slots, each
// portal moved down past the new keys below it, then the new records
// are written.
__device__ void merge_ray_by_warp(const MergeArgs& a, int r, int lane) {
    const long long c = a.rsel[r];
    const int lo = a.tlen[c];
    const size_t Rc = a.Rc, L = a.L;
    int nn = 0;
    for (int j = 0; j < a.k2; ++j) {
        const int p = a.pair[j * a.Rr + r];
        nn += p < 0 ? 0 : min(a.ncnt[p], a.max_new);
    }
    const int npad = a.max_new * a.k2 - nn;   // new slots with no portal
    int nold = 0;                             // old portals
    for (int i = lane; i < lo; i += 32) nold += a.tid[i * Rc + c] != -1;
    nold = warp_sum(nold);
    int last = -1, finite = 0;
    // 1. each new record's place
    for (int eb = 0; eb < nn; eb += 32) {
        const int e = eb + lane;
        int p = 0, m = 0, j = 0;
        unsigned ke = 0;
        int qe = 0;
        if (e < nn) {
            new_record(a, r, e, p, m, j);
            ke = radix_key(a.nt[m * L + p]);
            qe = m * a.k2 + j;
        }
        int new_ahead = 0, rows_ahead = 0, old_le = 0;
        for (int fb = 0; fb < nn; fb += 32) {
            const int f = fb + lane;
            unsigned kf = 0;
            int qf = 0;
            if (f < nn) {
                int pf, mf, jf;
                new_record(a, r, f, pf, mf, jf);
                kf = radix_key(a.nt[mf * L + pf]);
                qf = mf * a.k2 + jf;
            }
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
            // the old list's empty slots and the new ones are +inf
            if (ke >= kInfKey) old_le += a.MP - nold;
            const int pads = ke > kInfKey ? npad
                           : ke == kInfKey ? qe - rows_ahead : 0;
            a.dest[m * L + p] = old_le + new_ahead + pads;
            finite += finite_key(ke);
        }
    }
    __syncwarp();
    // 2. the old portals, from the list's end down
    for (int ob = lo > 0 ? (lo - 1) & ~31 : -32; ob >= 0; ob -= 32) {
        const int o = ob + lane;
        const long long id = o < lo ? a.tid[o * Rc + c] : -1;
        const bool real = id != -1;
        const float t = real ? a.tent[o * Rc + c] : 0.0f;
        const unsigned ko = radix_key(t);
        int shift = 0;
        for (int fb = 0; fb < nn; fb += 32) {
            const int f = fb + lane;
            unsigned kf = 0;
            if (f < nn) {
                int pf, mf, jf;
                new_record(a, r, f, pf, mf, jf);
                kf = radix_key(a.nt[mf * L + pf]);
            }
            const int cnt = min(32, nn - fb);
            for (int l = 0; l < cnt; ++l)
                shift += __shfl_sync(kFull, kf, l) < ko;
        }
        if (ko > kInfKey) shift += npad;
        const int d = o + shift;
        finite += real && finite_key(ko);
        __syncwarp();
        if (real && shift > 0) {
            a.tid[o * Rc + c] = -1;
            a.tent[o * Rc + c] = pos_inf();
        }
        __syncwarp();
        if (real && d < a.MP) {
            if (shift > 0) {
                a.tid[d * Rc + c] = id;
                a.tent[d * Rc + c] = t;
            }
            last = max(last, d);
        }
        __syncwarp();
    }
    // 3. the new records
    for (int e = lane; e < nn; e += 32) {
        int p, m, j;
        new_record(a, r, e, p, m, j);
        const int d = a.dest[m * L + p];
        if (d < a.MP) {
            a.tid[d * Rc + c] = a.ntid[m * L + p];
            a.tent[d * Rc + c] = a.nt[m * L + p];
            last = max(last, d);
        }
    }
    last = warp_max(last);
    finite = warp_sum(finite);
    if (lane == 0) {
        a.tlen[c] = last + 1;
        a.fcnt[r] = finite;
    }
}

__global__ void __launch_bounds__(kBlock)
portal_merge_kernel(MergeArgs a) {
    __shared__ int queue[kBlock];
    __shared__ int queued;
    if (threadIdx.x == 0) queued = 0;
    __syncthreads();
    const int r = blockIdx.x * kBlock + threadIdx.x;
    const size_t Rc = a.Rc, L = a.L;
    if (r < a.Rr) {
        const long long c = a.rsel[r];
        const int lo = a.tlen[c];
        // the thread's way: an old list of finite portals (slots 0 and
        // lo - 1 finite, so all between), at most kCap finite new ones
        bool by_warp = lo > 0 && !(finite_key(radix_key(a.tent[c])) &&
                                   finite_key(radix_key(
                                       a.tent[(lo - 1) * Rc + c])));
        RegList add;
        add.clear();
        int nn = 0;
        for (int j = 0; j < a.k2 && !by_warp; ++j) {
            const int p = a.pair[j * a.Rr + r];
            const int cj = p < 0 ? 0 : min(a.ncnt[p], a.max_new);
            if (nn + cj > kCap) {
                by_warp = true;
                break;
            }
            for (int m = 0; m < cj; ++m) {
                const float t = a.nt[m * L + p];
                const unsigned key = radix_key(t);
                by_warp |= !finite_key(key);
                add.insert(static_cast<unsigned long long>(key) << 32 |
                               static_cast<unsigned>(m * a.k2 + j),
                           a.ntid[m * L + p], t);
            }
            nn += cj;
        }
        if (!by_warp) {
            // old portal i moves down past the new keys below its own;
            // new record s lands past the old keys at or below its own
            int le[kCap];
#pragma unroll
            for (int s = 0; s < kCap; ++s) le[s] = 0;
            int i = lo - 1;
            for (; i >= 0; --i) {
                const float t = a.tent[i * Rc + c];
                const unsigned ki = radix_key(t);
                int shift = 0;
#pragma unroll
                for (int s = 0; s < kCap; ++s) {
                    const unsigned ks = static_cast<unsigned>(add.k[s] >> 32);
                    shift += s < nn && ks < ki;
                    le[s] += ki <= ks;
                }
                if (shift == 0) break;   // so for every portal below
                const int d = i + shift;
                if (d < a.MP) {
                    a.tid[d * Rc + c] = a.tid[i * Rc + c];
                    a.tent[d * Rc + c] = t;
                }
            }
            const int below = max(i, 0);   // portals 0..i-1, none visited
#pragma unroll
            for (int s = 0; s < kCap; ++s) {
                const int d = s + le[s] + below;
                if (s < nn && d < a.MP) {
                    a.tid[d * Rc + c] = add.id[s];
                    a.tent[d * Rc + c] = add.t[s];
                }
            }
            a.tlen[c] = min(lo + nn, a.MP);
            a.fcnt[r] = lo + nn;
        } else {
            queue[atomicAdd(&queued, 1)] = r;
        }
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int q = warp; q < queued; q += kWarps)
        merge_ray_by_warp(a, queue[q], lane);
}

}  // namespace

// ptid [MP, R] i32, ptent [MP, R] f32, cnt [R] i32 (phase A's records
// and counts); sel [Rc] i64; T < 0: tid [MP, Rc] i64, tent [MP, Rc] f32
// (each ray's records sorted); T >= 0: tid, tent the treelet list, sup
// [mps, Rc] i32, nsup [Rc] i32, tlen [Rc] i32. Returns
// cudaGetLastError() after the launch.
extern "C" int bvh_portal_sort(const int* ptid, const float* ptent,
                               const int* cnt, int R, int MP,
                               const long long* sel, int Rc, int T, int mps,
                               long long* tid, float* tent, int* sup,
                               int* nsup, int* tlen, void* stream) {
    if (Rc > 0) {
        const SortArgs a{ptid, ptent, cnt, R, MP, sel, Rc, T, mps,
                         tid, tent, sup, nsup, tlen};
        portal_sort_kernel<<<(Rc + kBlock - 1) / kBlock, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}

// tid [MP, Rc] i64, tent [MP, Rc] f32, tlen [Rc] i32 (merged in place at
// the columns rsel [Rr] i64); pair [k2, Rr] i32; ntid [max_new, L] i32,
// nt [max_new, L] f32, ncnt [L] i32 (kernel B4's outputs); dest
// [max_new, L] i32 scratch; fcnt [Rr] i32. Returns cudaGetLastError()
// after the launch.
extern "C" int bvh_portal_merge(long long* tid, float* tent, int* tlen,
                                int MP, int Rc, const long long* rsel, int Rr,
                                const int* pair, int k2, const int* ntid,
                                const float* nt, const int* ncnt, int L,
                                int max_new, int* dest, int* fcnt,
                                void* stream) {
    if (Rr > 0) {
        const MergeArgs a{tid, tent, tlen, MP, Rc, rsel, Rr, pair, k2,
                          ntid, nt, ncnt, L, max_new, dest, fcnt};
        portal_merge_kernel<<<(Rr + kBlock - 1) / kBlock, kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
