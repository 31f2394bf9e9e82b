/* Native arena executor: the GIL-free steady-state data plane.
 *
 * ≈ opal's sm/vader progress engine — the reference runs its shared-
 * memory flag waits, slot copies, and reduction loops in C; our Python
 * layer pays the GIL for every one of them, and on a host where ranks
 * (or a rank and its transport threads) share cores, a Python spin
 * loop in ONE rank steals the quantum the flag WRITER needs (measured
 * in the JAX package: an every-rank redundant fold was slower than a
 * single-rank fold purely from spinner interference).
 *
 * Every entry point here is called through ctypes, which drops the GIL
 * for the duration of the call — so a rank parked in a flag wait, a
 * 64 KiB slot publish, or a segment fold no longer serializes against
 * the other in-process ranks.  Policy stays in Python: a wait runs for
 * one bounded SLICE and returns, so the caller re-checks the FT
 * contract (revocation, detector-declared deaths, the dead-writer pid
 * probe) and the overall deadline between slices at the same cadence
 * the pure-Python loop did.
 *
 * Layout contracts (shared with coll/shm.py and btl_shm.py):
 *   - arena flags are a u64 array at the segment base; flag i is the
 *     aligned 8-byte word at index i (cacheline padding is the
 *     caller's indexing problem).  All flag loads are acquire, all
 *     flag stores release — on x86 both compile to plain MOVs, the
 *     same TSO discipline the memoryview.cast("Q") path relies on.
 *   - ring counter blocks put head at u64 index 0 (btl_shm._OFF_HEAD).
 *   - fold sources are element-aligned slot pointers; the fold chain
 *     is acc = op(acc, src[s]) in s-order per element — bit-identical
 *     to the numpy rank-ordered chain (signed overflow wraps via the
 *     unsigned detour; float min/max propagate NaN like np.minimum).
 */

#include <stdint.h>
#include <string.h>
#include <time.h>

#if defined(__linux__)
#include <errno.h>
#include <sys/syscall.h>
#include <unistd.h>
#if defined(__BYTE_ORDER__) && (__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__)
/* SHARED futex (no PRIVATE flag: the flag words live in cross-process
 * shm segments) on the LOW 32 bits of the monotonic u64 counter — on
 * little-endian that is the word that changes every increment */
#define ARENA_HAVE_FUTEX 1
#endif
#endif

#ifdef __cplusplus
extern "C" {
#endif

#if defined(__x86_64__) || defined(__i386__)
#define ARENA_RELAX() __builtin_ia32_pause()
#else
#define ARENA_RELAX() do { } while (0)
#endif

/* escalating in-slice nap: start near a context-switch quantum, cap at
 * 1 ms so a slice never oversleeps its caller's FT-check cadence much */
#define NAP_START_NS 20000LL
#define NAP_MAX_NS 1000000LL

/* longest single futex block: a publisher whose flag store took the
 * PYTHON path sends no wake, so every futex wait is bounded — the
 * missed-wake worst case degrades to the python loop's own 1 ms
 * escalation cap instead of a hang */
#define FUTEX_CAP_NS 1000000LL

#ifdef ARENA_HAVE_FUTEX
#define ARENA_FUTEX_WAIT 0
#define ARENA_FUTEX_WAKE 1

static void futex_wait32(const uint64_t *word, uint32_t seen,
                         int64_t max_ns) {
    struct timespec ts;
    if (max_ns > FUTEX_CAP_NS)
        max_ns = FUTEX_CAP_NS;
    ts.tv_sec = (time_t)(max_ns / 1000000000LL);
    ts.tv_nsec = (long)(max_ns % 1000000000LL);
    /* EAGAIN (word moved already), EINTR, ETIMEDOUT: caller re-checks */
    syscall(SYS_futex, (const uint32_t *)(const void *)word,
            ARENA_FUTEX_WAIT, seen, &ts, (void *)0, 0);
}

static void futex_wake32(const uint64_t *word) {
    syscall(SYS_futex, (const uint32_t *)(const void *)word,
            ARENA_FUTEX_WAKE, 0x7fffffff, (void *)0, (void *)0, 0);
}
#endif

static int64_t now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000LL + (int64_t)ts.tv_nsec;
}

static void park_ns(int64_t ns) {
    struct timespec ts;
    ts.tv_sec = (time_t)(ns / 1000000000LL);
    ts.tv_nsec = (long)(ns % 1000000000LL);
    /* EINTR just shortens the nap — the predicate re-check handles it */
    nanosleep(&ts, (struct timespec *)0);
}

static uint64_t load_u64(const uint64_t *p) {
    return __atomic_load_n(p, __ATOMIC_ACQUIRE);
}

/* -- span rings ----------------------------------------------------------- *
 *
 * Begin–end timestamps of the GIL-released parks, recorded into small
 * per-thread rings the Python side drains into its flight recorder —
 * without this the timeline shows gaps exactly where the interesting
 * waits happen.  Threads hash onto SPAN_SLOTS single-writer rings (a
 * slot collision can tear a triple; span data is metrics, the same
 * unlocked-loss tolerance as the python counters).  Disarmed (min_ns
 * < 0, the default) the only cost per entry is one relaxed load.
 */

#define SPAN_SLOTS 16
#define SPAN_RING 256
#define SPAN_KIND_WAIT 1
#define SPAN_KIND_WAIT_ALL 2
#define SPAN_KIND_WAIT_CHANGE 3
#define SPAN_KIND_RING_WAIT 4

typedef struct {
    uint64_t n;                  /* triples ever recorded (writer-owned) */
    uint64_t drained;            /* drain cursor (drainer-owned)         */
    uint64_t buf[SPAN_RING * 3]; /* kind, t0_ns, t1_ns                   */
} span_ring_t;

static span_ring_t g_spans[SPAN_SLOTS];
static int64_t g_span_min_ns = -1;   /* < 0 = disarmed */
static uint64_t g_span_slot_seq = 0;
static __thread int t_span_slot = -1;

/* begin-of-span stamp: 0 when disarmed (entries skip the end stamp) */
static int64_t span_t0(void) {
    if (__atomic_load_n(&g_span_min_ns, __ATOMIC_RELAXED) < 0)
        return 0;
    return now_ns();
}

static void span_record(uint64_t kind, int64_t t0) {
    span_ring_t *r;
    uint64_t i;
    int64_t t1 = now_ns();
    int64_t min_ns = __atomic_load_n(&g_span_min_ns, __ATOMIC_RELAXED);
    if (min_ns < 0 || t1 - t0 < min_ns)
        return;
    if (t_span_slot < 0)
        t_span_slot = (int)(__atomic_fetch_add(&g_span_slot_seq, 1,
                                               __ATOMIC_RELAXED)
                            % SPAN_SLOTS);
    r = &g_spans[t_span_slot];
    i = (r->n % SPAN_RING) * 3;
    r->buf[i] = kind;
    r->buf[i + 1] = (uint64_t)t0;
    r->buf[i + 2] = (uint64_t)t1;
    __atomic_store_n(&r->n, r->n + 1, __ATOMIC_RELEASE);
}

/* Arm (min_ns >= 0: record spans at least that long) or disarm (< 0). */
void ompi_tpu_arena_spans_enable(int64_t min_ns) {
    __atomic_store_n(&g_span_min_ns, min_ns, __ATOMIC_RELEASE);
}

/* Copy completed triples (kind, t0_ns, t1_ns) since the last drain into
 * out (capacity 3*max_triples u64s); returns the triple count.  Single
 * drainer assumed (Python under the GIL).  A ring that wrapped past the
 * cursor loses the overwritten spans — bounded memory wins. */
int64_t ompi_tpu_arena_spans_drain(uint64_t *out, int64_t max_triples) {
    int64_t got = 0;
    int s;
    for (s = 0; s < SPAN_SLOTS && got < max_triples; ++s) {
        span_ring_t *r = &g_spans[s];
        uint64_t n = __atomic_load_n(&r->n, __ATOMIC_ACQUIRE);
        uint64_t from = r->drained;
        if (n - from > SPAN_RING)
            from = n - SPAN_RING;
        for (; from < n && got < max_triples; ++from, ++got) {
            uint64_t i = (from % SPAN_RING) * 3;
            out[got * 3] = r->buf[i];
            out[got * 3 + 1] = r->buf[i + 1];
            out[got * 3 + 2] = r->buf[i + 2];
        }
        r->drained = from;
    }
    return got;
}

/* -- flag waits ----------------------------------------------------------- */

/* One bounded block on a single flag word: futex on the counter's low
 * half where available (publishers wake it — the wake-to-run latency
 * is the scheduler's, not a nap grid's), escalating nanosleep
 * otherwise.  *nap is the caller-held escalation state. */
static void block_on(const uint64_t *p, uint64_t cur, int64_t deadline,
                     int64_t *nap) {
#ifdef ARENA_HAVE_FUTEX
    int64_t remain = deadline - now_ns();
    (void)nap;
    if (remain > 0)
        futex_wait32(p, (uint32_t)cur, remain);
#else
    (void)p;
    (void)cur;
    (void)deadline;
    park_ns(*nap);
    if (*nap < NAP_MAX_NS)
        *nap *= 2;
#endif
}

/* Park until flags[idx] >= want: a bounded spin burst (pause-backed,
 * each iteration one acquire load), then futex-style blocks until the
 * slice expires.  1 = satisfied, 0 = slice expired (caller re-checks
 * FT + deadline and calls again). */
static int64_t arena_wait_impl(const uint64_t *flags, int64_t idx,
                               uint64_t want, int64_t spins,
                               int64_t slice_ns) {
    const uint64_t *p = flags + idx;
    int64_t s, deadline, nap;
    uint64_t cur;
    for (s = 0; s < spins; ++s) {
        if (load_u64(p) >= want)
            return 1;
        ARENA_RELAX();
    }
    deadline = now_ns() + slice_ns;
    nap = NAP_START_NS;
    for (;;) {
        cur = load_u64(p);
        if (cur >= want)
            return 1;
        if (now_ns() >= deadline)
            return 0;
        block_on(p, cur, deadline, &nap);
    }
}

/* Park until flags[base + i*stride] >= want for EVERY i in [0, n) —
 * the _wait_all_arrive/_wait_all_depart sweep as one GIL-released
 * call.  Satisfied prefixes are never re-checked (i only advances). */
static int64_t arena_wait_all_impl(const uint64_t *flags, int64_t base,
                                   int64_t stride, int64_t n, uint64_t want,
                                   int64_t spins, int64_t slice_ns) {
    int64_t i = 0, s, deadline, nap;
    uint64_t cur;
    for (s = 0; s < spins; ++s) {
        while (i < n && load_u64(flags + base + i * stride) >= want)
            ++i;
        if (i >= n)
            return 1;
        ARENA_RELAX();
    }
    deadline = now_ns() + slice_ns;
    nap = NAP_START_NS;
    for (;;) {
        while (i < n && load_u64(flags + base + i * stride) >= want)
            ++i;
        if (i >= n)
            return 1;
        if (now_ns() >= deadline)
            return 0;
        /* block on the first unsatisfied flag: its publisher's wake
         * releases us; the loop then advances past it */
        cur = load_u64(flags + base + i * stride);
        if (cur >= want)
            continue;
        block_on(flags + base + i * stride, cur, deadline, &nap);
    }
}

/* Park until *p != seen (a counter moved at all) — the writer-side
 * ring-full backpressure wait, layout-agnostic. */
static int64_t arena_wait_change_impl(const uint64_t *p, uint64_t seen,
                                      int64_t spins, int64_t slice_ns) {
    int64_t s, deadline, nap;
    for (s = 0; s < spins; ++s) {
        if (load_u64(p) != seen)
            return 1;
        ARENA_RELAX();
    }
    deadline = now_ns() + slice_ns;
    nap = NAP_START_NS;
    for (;;) {
        if (load_u64(p) != seen)
            return 1;
        if (now_ns() >= deadline)
            return 0;
        block_on(p, seen, deadline, &nap);
    }
}

/* Wake every futex waiter parked on flag word idx — publishers call
 * this right after a release flag store (native publishes fuse it;
 * python-side memoryview stores call it through ctypes).  A no-op
 * build (no futex) leaves waiters on their bounded naps. */
void ompi_tpu_arena_wake(const uint64_t *flags, int64_t idx) {
#ifdef ARENA_HAVE_FUTEX
    futex_wake32(flags + idx);
#else
    (void)flags;
    (void)idx;
#endif
}

/* Park until ANY ring i has head (ctrs[i][0]) != tails[i]; returns the
 * first such index, or -1 on slice expiry.  The btl/shm poller's idle
 * window: one GIL-released call instead of a time.sleep(0) spin that
 * fights every other thread for the interpreter. */
static int64_t ring_wait_any_impl(uint64_t **ctrs, const uint64_t *tails,
                                  int64_t n, int64_t spins,
                                  int64_t slice_ns) {
    int64_t s, i, deadline, nap;
    for (s = 0; s < spins; ++s) {
        for (i = 0; i < n; ++i)
            if (load_u64(ctrs[i]) != tails[i])
                return i;
        ARENA_RELAX();
    }
    deadline = now_ns() + slice_ns;
    nap = NAP_START_NS;
    for (;;) {
        for (i = 0; i < n; ++i)
            if (load_u64(ctrs[i]) != tails[i])
                return i;
        if (now_ns() >= deadline)
            return -1;
        park_ns(nap);
        if (nap < NAP_MAX_NS)
            nap *= 2;
    }
}

/* Exported park entries: the impl bracketed by the span stamps.  When
 * disarmed span_t0() returns 0 and the wrapper adds one relaxed load. */
int64_t ompi_tpu_arena_wait(const uint64_t *flags, int64_t idx,
                            uint64_t want, int64_t spins,
                            int64_t slice_ns) {
    int64_t t0 = span_t0();
    int64_t r = arena_wait_impl(flags, idx, want, spins, slice_ns);
    if (t0)
        span_record(SPAN_KIND_WAIT, t0);
    return r;
}

int64_t ompi_tpu_arena_wait_all(const uint64_t *flags, int64_t base,
                                int64_t stride, int64_t n, uint64_t want,
                                int64_t spins, int64_t slice_ns) {
    int64_t t0 = span_t0();
    int64_t r = arena_wait_all_impl(flags, base, stride, n, want, spins,
                                    slice_ns);
    if (t0)
        span_record(SPAN_KIND_WAIT_ALL, t0);
    return r;
}

int64_t ompi_tpu_arena_wait_change(const uint64_t *p, uint64_t seen,
                                   int64_t spins, int64_t slice_ns) {
    int64_t t0 = span_t0();
    int64_t r = arena_wait_change_impl(p, seen, spins, slice_ns);
    if (t0)
        span_record(SPAN_KIND_WAIT_CHANGE, t0);
    return r;
}

int64_t ompi_tpu_ring_wait_any(uint64_t **ctrs, const uint64_t *tails,
                               int64_t n, int64_t spins,
                               int64_t slice_ns) {
    int64_t t0 = span_t0();
    int64_t r = ring_wait_any_impl(ctrs, tails, n, spins, slice_ns);
    if (t0)
        span_record(SPAN_KIND_RING_WAIT, t0);
    return r;
}

/* -- publishes ------------------------------------------------------------ */

/* THE send-side copy + arrive store as one GIL-released call: memcpy
 * into the mapped slot, then a release store of the flag (NULL flags
 * ⇒ pure copy — the drain-side read uses the same entry point). */
void ompi_tpu_arena_publish(uint8_t *dst, const uint8_t *src,
                            int64_t nbytes, uint64_t *flags, int64_t fidx,
                            uint64_t fval) {
    if (nbytes > 0)
        memcpy(dst, src, (size_t)nbytes);
    if (flags) {
        __atomic_store_n(flags + fidx, fval, __ATOMIC_RELEASE);
        ompi_tpu_arena_wake(flags, fidx);
    }
}

/* Strided-source publish (the convertor plan ABI's vector-class shape:
 * nblocks blocks of bl bytes, source block i at src + i*stride, packed
 * dense into dst) + the same release flag store. */
void ompi_tpu_arena_publish_strided(uint8_t *dst, const uint8_t *src,
                                    int64_t nblocks, int64_t bl,
                                    int64_t stride, uint64_t *flags,
                                    int64_t fidx, uint64_t fval) {
    int64_t i;
    for (i = 0; i < nblocks; ++i) {
        memcpy(dst, src, (size_t)bl);
        dst += bl;
        src += stride;
    }
    if (flags) {
        __atomic_store_n(flags + fidx, fval, __ATOMIC_RELEASE);
        ompi_tpu_arena_wake(flags, fidx);
    }
}

/* Scattered-block copy plan + the same optional fused release store:
 * nblocks independent (dst, src, len) copies, then one flag publish.
 * This is the dense-exchange workhorse — the alltoall gather side reads
 * its column out of every peer slot (p copies), and the alltoallv
 * scatter side lays a length header plus variable blocks into its own
 * slot (p+1 copies) — as ONE GIL-released call instead of p ctypes
 * crossings.  NULL flags ⇒ pure copy plan (the gather side, which
 * signs completion through depart flags separately). */
void ompi_tpu_arena_copy_blocks(uint8_t **dsts, uint8_t **srcs,
                                const int64_t *lens, int64_t nblocks,
                                uint64_t *flags, int64_t fidx,
                                uint64_t fval) {
    int64_t i;
    for (i = 0; i < nblocks; ++i)
        if (lens[i] > 0)
            memcpy(dsts[i], srcs[i], (size_t)lens[i]);
    if (flags) {
        __atomic_store_n(flags + fidx, fval, __ATOMIC_RELEASE);
        ompi_tpu_arena_wake(flags, fidx);
    }
}

/* -- width-specialized segment folds -------------------------------------- */

/* dtype codes (numpy native-endian fixed widths):
 *   0 int8  1 int16  2 int32  3 int64
 *   4 uint8 5 uint16 6 uint32 7 uint64
 *   8 float32  9 float64
 * op codes: 0 sum, 1 prod, 2 min, 3 max (the commutative builtins).
 * Chain order per element is s = 0..nsrc-1, identical to the Python
 * rank-ordered op.host() fold, so results are bit-identical. */

#define FOLD_LOOP(T, OPEXPR)                                            \
    do {                                                                \
        T *d = (T *)dst;                                                \
        int64_t j, s_;                                                  \
        for (j = 0; j < nelems; ++j) {                                  \
            T a = ((const T *)(const void *)srcs[0])[j];                \
            for (s_ = 1; s_ < nsrc; ++s_) {                             \
                T b = ((const T *)(const void *)srcs[s_])[j];           \
                a = (OPEXPR);                                           \
            }                                                           \
            d[j] = a;                                                   \
        }                                                               \
        return 0;                                                       \
    } while (0)

/* signed sum/prod detour through the unsigned twin: numpy wraps on
 * overflow, and signed overflow is UB the sanitizer build would trap */
#define FOLD_TYPE_SINT(T, UT)                                           \
    switch (op) {                                                       \
    case 0: FOLD_LOOP(T, (T)(UT)((UT)a + (UT)b));                       \
    case 1: FOLD_LOOP(T, (T)(UT)((UT)a * (UT)b));                       \
    case 2: FOLD_LOOP(T, a < b ? a : b);                                \
    case 3: FOLD_LOOP(T, a > b ? a : b);                                \
    default: return -1;                                                 \
    }

#define FOLD_TYPE_UINT(T)                                               \
    switch (op) {                                                       \
    case 0: FOLD_LOOP(T, (T)(a + b));                                   \
    case 1: FOLD_LOOP(T, (T)(a * b));                                   \
    case 2: FOLD_LOOP(T, a < b ? a : b);                                \
    case 3: FOLD_LOOP(T, a > b ? a : b);                                \
    default: return -1;                                                 \
    }

/* float min/max propagate NaN FIRST-operand-first, matching
 * np.minimum/np.maximum ("if one element is NaN, that element is
 * returned") applied down the acc chain */
#define FOLD_TYPE_FLT(T)                                                \
    switch (op) {                                                       \
    case 0: FOLD_LOOP(T, a + b);                                        \
    case 1: FOLD_LOOP(T, a * b);                                        \
    case 2: FOLD_LOOP(T, (a != a) ? a : ((b != b) ? b                   \
                                         : (a < b ? a : b)));           \
    case 3: FOLD_LOOP(T, (a != a) ? a : ((b != b) ? b                   \
                                         : (a > b ? a : b)));           \
    default: return -1;                                                 \
    }

/* Fold nsrc equal-length segments elementwise into dst.  0 = done,
 * -1 = unsupported (dtype, op) — the caller pre-validates, so -1 is a
 * contract violation it surfaces, never a silent wrong answer. */
int64_t ompi_tpu_arena_fold(uint8_t *dst, uint8_t **srcs, int64_t nsrc,
                            int64_t nelems, int64_t dtype, int64_t op) {
    if (nsrc < 1 || nelems < 0)
        return -1;
    switch (dtype) {
    case 0: FOLD_TYPE_SINT(int8_t, uint8_t);
    case 1: FOLD_TYPE_SINT(int16_t, uint16_t);
    case 2: FOLD_TYPE_SINT(int32_t, uint32_t);
    case 3: FOLD_TYPE_SINT(int64_t, uint64_t);
    case 4: FOLD_TYPE_UINT(uint8_t);
    case 5: FOLD_TYPE_UINT(uint16_t);
    case 6: FOLD_TYPE_UINT(uint32_t);
    case 7: FOLD_TYPE_UINT(uint64_t);
    case 8: FOLD_TYPE_FLT(float);
    case 9: FOLD_TYPE_FLT(double);
    default: return -1;
    }
}

/* version tag so the loader can detect stale cached builds */
int64_t ompi_tpu_arena_abi(void) { return 3; }

#ifdef __cplusplus
}  /* extern "C" */
#endif
