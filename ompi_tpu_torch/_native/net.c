/* Native network executor: the GIL-free inter-node transport plane.
 *
 * ≈ opal's btl/tcp progress engine — the reference drains its endpoint
 * send queues and runs its event-loop reads in C; our Python plane pays
 * one b"".join copy, one syscall, and two GIL transitions per frame on
 * the send side, and a whole Python thread per accepted connection on
 * the receive side.  Every entry point here is called through ctypes,
 * which drops the GIL for the duration of the call, so:
 *
 *   - a writer drains an entire per-peer submission-ring backlog in one
 *     sendmsg (scatter-gather, MSG_DONTWAIT) call — the burst of small
 *     frames a collective fan-in produces coalesces into one syscall;
 *   - one poller parks in poll() across EVERY connection's fd instead
 *     of N Python read loops blocking in recv and then fighting for the
 *     interpreter to parse 8 bytes of length prefix;
 *   - rendezvous payloads land straight into the plan-registered
 *     receive buffer (recv into the caller-supplied pointer), not into
 *     an intermediate bytes object.
 *
 * Policy stays in Python, exactly like arena.c: every blocking entry
 * runs for ONE bounded slice and returns, so the caller re-runs the FT
 * contract (revocation, detector-declared deaths, stop flags) between
 * parks at the same cadence the pure-Python loop did.  Sockets are
 * never made nonblocking here — MSG_DONTWAIT gives per-call
 * nonblocking I/O, so the Python fallback plane can keep using the
 * very same (blocking) socket objects when `btl_tcp_native` flips off.
 *
 * Wire contract (shared with btl.py's python plane, bit-identical):
 *   frame = u32 LE total | u32 LE hdrlen | dss(header) | raw payload
 */

#include <stdint.h>
#include <string.h>
#include <time.h>

#include <errno.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#ifndef MSG_NOSIGNAL
#define MSG_NOSIGNAL 0
#endif

#ifdef __cplusplus
extern "C" {
#endif

#if defined(__x86_64__) || defined(__i386__)
#define NET_RELAX() __builtin_ia32_pause()
#else
#define NET_RELAX() do { } while (0)
#endif

/* EOF sentinel, outside the errno range so -errno stays unambiguous */
#define NET_EOF (-4096)

/* sendmsg batch width: frames are <= 3 iovecs (prefix, header,
 * payload), so 256 slots cover ~85 frames per syscall — far under any
 * IOV_MAX and a modest stack frame */
#define NET_IOV_BATCH 256

/* poll() fan-in cap (stack pollfd array) — worlds are far smaller; the
 * Python side falls back to select() past this */
#define NET_POLL_MAX 1024

static int64_t now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000LL + (int64_t)ts.tv_nsec;
}

static int poll_ms(int64_t remain_ns) {
    int64_t ms = (remain_ns + 999999LL) / 1000000LL;
    if (ms < 1)
        ms = 1;
    if (ms > 1000)
        ms = 1000;   /* missed-wake worst case stays bounded */
    return (int)ms;
}

/* -- span rings ----------------------------------------------------------- *
 *
 * Begin–end timestamps of the GIL-released transport parks, drained by
 * the Python side into its flight recorder (same design as arena.c:
 * per-thread single-writer rings, slot collisions may tear a triple —
 * span data is metrics, not control flow).  Disarmed (min_ns < 0, the
 * default) each entry pays one relaxed load. */

#define SPAN_SLOTS 16
#define SPAN_RING 256
#define SPAN_KIND_WRITEV 1
#define SPAN_KIND_SEND3 2
#define SPAN_KIND_POLL 3
#define SPAN_KIND_RECV_INTO 4

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
void ompi_tpu_net_spans_enable(int64_t min_ns) {
    __atomic_store_n(&g_span_min_ns, min_ns, __ATOMIC_RELEASE);
}

/* Copy completed triples (kind, t0_ns, t1_ns) since the last drain into
 * out (capacity 3*max_triples u64s); returns the triple count.  Single
 * drainer assumed (Python under the GIL); a wrapped ring drops the
 * overwritten spans. */
int64_t ompi_tpu_net_spans_drain(uint64_t *out, int64_t max_triples) {
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

/* -- send side ------------------------------------------------------------ */

/* Drain a scatter-gather backlog: `parts` is niov (addr, len) u64
 * pairs; the whole list is pushed through sendmsg(MSG_DONTWAIT) in
 * NET_IOV_BATCH chunks, polling POLLOUT between short writes, until
 * everything is written or the slice expires.
 *
 * Returns bytes written THIS call (>= 0; the caller re-slices the
 * remainder and re-runs its FT checks), or -errno on a hard socket
 * error with no progress (progress-then-error returns the progress;
 * the next call surfaces the error). */
static int64_t net_writev_impl(int64_t fd, const uint64_t *parts,
                               int64_t niov, int64_t slice_ns) {
    struct iovec iov[NET_IOV_BATCH];
    struct msghdr msg;
    int64_t i = 0, written = 0, deadline;
    uint64_t skip = 0;   /* bytes of parts[i] already written */
    ssize_t n;

    deadline = now_ns() + slice_ns;
    while (i < niov) {
        int64_t k = 0, j;
        for (j = i; j < niov && k < NET_IOV_BATCH; ++j) {
            uint64_t base = parts[2 * j];
            uint64_t len = parts[2 * j + 1];
            if (j == i) {
                base += skip;
                len -= skip;
            }
            if (len == 0 && j == i) {   /* fully-sent head: advance */
                ++i;
                skip = 0;
                continue;
            }
            iov[k].iov_base = (void *)(uintptr_t)base;
            iov[k].iov_len = (size_t)len;
            ++k;
        }
        if (k == 0)
            break;
        memset(&msg, 0, sizeof(msg));
        msg.msg_iov = iov;
        msg.msg_iovlen = (size_t)k;
        n = sendmsg((int)fd, &msg, MSG_DONTWAIT | MSG_NOSIGNAL);
        if (n > 0) {
            uint64_t left = (uint64_t)n;
            written += n;
            while (i < niov) {
                uint64_t len = parts[2 * i + 1] - skip;
                if (left < len) {
                    skip += left;
                    break;
                }
                left -= len;
                ++i;
                skip = 0;
            }
            continue;
        }
        if (n < 0 && errno == EINTR)
            continue;
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            struct pollfd pfd;
            int64_t remain = deadline - now_ns();
            if (remain <= 0)
                return written;
            pfd.fd = (int)fd;
            pfd.events = POLLOUT;
            pfd.revents = 0;
            (void)poll(&pfd, 1, poll_ms(remain));
            continue;
        }
        return written > 0 ? written : -(int64_t)errno;
    }
    return written;
}

/* Latency-path variant: one whole frame (prefix, header, payload) in a
 * single ctypes crossing.  ompi_tpu_net_writev needs the caller to
 * marshal (addr, len) pairs into a u64 array — ~10us of Python per
 * frame, which swamps the syscall on the ping-pong path.  Here ctypes
 * passes the three buffers straight through as pointer arguments (it
 * extracts bytes-object addresses in C), so the Python side does no
 * marshalling at all.  Same drain discipline as writev: sendmsg
 * MSG_DONTWAIT with partial-advance, POLLOUT waits bounded by the
 * slice.  Returns total bytes written this call (the caller resumes a
 * partial frame through writev with adjusted offsets), or -errno on a
 * hard error with no progress. */
static int64_t net_send3_impl(int64_t fd,
                              const uint8_t *p0, int64_t l0,
                              const uint8_t *p1, int64_t l1,
                              const uint8_t *p2, int64_t l2,
                              int64_t slice_ns) {
    struct iovec iov[3];
    struct msghdr msg;
    int64_t total = l0 + l1 + l2, written = 0, deadline;
    int n = 0, idx = 0;

    if (l0 > 0) { iov[n].iov_base = (void *)p0; iov[n].iov_len = (size_t)l0; ++n; }
    if (l1 > 0) { iov[n].iov_base = (void *)p1; iov[n].iov_len = (size_t)l1; ++n; }
    if (l2 > 0) { iov[n].iov_base = (void *)p2; iov[n].iov_len = (size_t)l2; ++n; }
    deadline = now_ns() + slice_ns;
    while (written < total) {
        ssize_t w;
        memset(&msg, 0, sizeof(msg));
        msg.msg_iov = iov + idx;
        msg.msg_iovlen = (size_t)(n - idx);
        w = sendmsg((int)fd, &msg, MSG_DONTWAIT | MSG_NOSIGNAL);
        if (w > 0) {
            written += w;
            while (idx < n && (size_t)w >= iov[idx].iov_len) {
                w -= (ssize_t)iov[idx].iov_len;
                ++idx;
            }
            if (idx < n && w > 0) {
                iov[idx].iov_base = (uint8_t *)iov[idx].iov_base + w;
                iov[idx].iov_len -= (size_t)w;
            }
            continue;
        }
        if (w < 0 && errno == EINTR)
            continue;
        if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            struct pollfd pfd;
            int64_t remain = deadline - now_ns();
            if (remain <= 0)
                return written;
            pfd.fd = (int)fd;
            pfd.events = POLLOUT;
            pfd.revents = 0;
            (void)poll(&pfd, 1, poll_ms(remain));
            continue;
        }
        return written > 0 ? written : -(int64_t)errno;
    }
    return written;
}

/* -- receive side --------------------------------------------------------- */

/* ONE park across every connection: a bounded spin burst of
 * zero-timeout polls (each iteration one syscall — cheap enough to
 * catch a ping-pong reply without a scheduler wake), then a single
 * blocking poll for the remaining slice.  ready[i] is set for any fd
 * with POLLIN/POLLERR/POLLHUP/POLLNVAL pending (errors count as
 * readable: the read surfaces them).  Returns the number of ready
 * fds, 0 on slice expiry, or -errno (-EINVAL when nfds exceeds the
 * stack cap — the caller falls back to select()). */
static int64_t net_poll_impl(const int64_t *fds, int64_t nfds,
                             uint8_t *ready, int64_t spins,
                             int64_t slice_ns) {
    struct pollfd pfds[NET_POLL_MAX];
    int64_t i, s, deadline;
    int rc;

    if (nfds < 0 || nfds > NET_POLL_MAX)
        return -(int64_t)EINVAL;
    for (i = 0; i < nfds; ++i) {
        pfds[i].fd = (int)fds[i];
        pfds[i].events = POLLIN;
        pfds[i].revents = 0;
        ready[i] = 0;
    }
    for (s = 0; s < spins; ++s) {
        rc = poll(pfds, (nfds_t)nfds, 0);
        if (rc != 0)
            goto harvest;
        NET_RELAX();
    }
    deadline = now_ns() + slice_ns;
    for (;;) {
        int64_t remain = deadline - now_ns();
        if (remain <= 0)
            return 0;
        rc = poll(pfds, (nfds_t)nfds, poll_ms(remain));
        if (rc > 0)
            goto harvest;
        if (rc < 0 && errno != EINTR && errno != EAGAIN)
            return -(int64_t)errno;
        /* rc == 0 (poll's own timeout) or EINTR: re-check the slice */
    }
harvest:
    if (rc < 0)
        return (errno == EINTR || errno == EAGAIN) ? 0 : -(int64_t)errno;
    for (i = 0; i < nfds; ++i)
        if (pfds[i].revents & (POLLIN | POLLERR | POLLHUP | POLLNVAL))
            ready[i] = 1;
    return (int64_t)rc;
}

/* One nonblocking gulp into the connection's staging buffer.  Returns
 * bytes read (> 0), NET_EOF on orderly shutdown, -EAGAIN when nothing
 * is pending, or -errno. */
int64_t ompi_tpu_net_read(int64_t fd, uint8_t *buf, int64_t cap) {
    ssize_t n;
    for (;;) {
        n = recv((int)fd, buf, (size_t)cap, MSG_DONTWAIT);
        if (n > 0)
            return (int64_t)n;
        if (n == 0)
            return NET_EOF;
        if (errno == EINTR)
            continue;
        return -(int64_t)errno;
    }
}

/* Land payload bytes straight into the caller's buffer (the rndv
 * zero-copy leg): poll(POLLIN) + recv(MSG_DONTWAIT) until `want`
 * bytes arrived or the slice expired.  Returns bytes landed THIS call
 * (>= 0; the caller re-runs FT checks and calls again with the
 * remainder), NET_EOF on orderly shutdown with no progress this call,
 * or -errno. */
static int64_t net_recv_into_impl(int64_t fd, uint8_t *dst, int64_t want,
                                  int64_t slice_ns) {
    int64_t got = 0, deadline;
    ssize_t n;

    deadline = now_ns() + slice_ns;
    while (got < want) {
        n = recv((int)fd, dst + got, (size_t)(want - got), MSG_DONTWAIT);
        if (n > 0) {
            got += n;
            continue;
        }
        if (n == 0)
            return got > 0 ? got : NET_EOF;
        if (errno == EINTR)
            continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
            struct pollfd pfd;
            int64_t remain = deadline - now_ns();
            if (remain <= 0)
                return got;
            pfd.fd = (int)fd;
            pfd.events = POLLIN;
            pfd.revents = 0;
            (void)poll(&pfd, 1, poll_ms(remain));
            continue;
        }
        return got > 0 ? got : -(int64_t)errno;
    }
    return got;
}

/* Exported transport parks: the impl bracketed by the span stamps.
 * When disarmed span_t0() returns 0 and the wrapper adds one relaxed
 * load. */
int64_t ompi_tpu_net_writev(int64_t fd, const uint64_t *parts,
                            int64_t niov, int64_t slice_ns) {
    int64_t t0 = span_t0();
    int64_t r = net_writev_impl(fd, parts, niov, slice_ns);
    if (t0)
        span_record(SPAN_KIND_WRITEV, t0);
    return r;
}

int64_t ompi_tpu_net_send3(int64_t fd,
                           const uint8_t *p0, int64_t l0,
                           const uint8_t *p1, int64_t l1,
                           const uint8_t *p2, int64_t l2,
                           int64_t slice_ns) {
    int64_t t0 = span_t0();
    int64_t r = net_send3_impl(fd, p0, l0, p1, l1, p2, l2, slice_ns);
    if (t0)
        span_record(SPAN_KIND_SEND3, t0);
    return r;
}

int64_t ompi_tpu_net_poll(const int64_t *fds, int64_t nfds,
                          uint8_t *ready, int64_t spins,
                          int64_t slice_ns) {
    int64_t t0 = span_t0();
    int64_t r = net_poll_impl(fds, nfds, ready, spins, slice_ns);
    if (t0)
        span_record(SPAN_KIND_POLL, t0);
    return r;
}

int64_t ompi_tpu_net_recv_into(int64_t fd, uint8_t *dst, int64_t want,
                               int64_t slice_ns) {
    int64_t t0 = span_t0();
    int64_t r = net_recv_into_impl(fd, dst, want, slice_ns);
    if (t0)
        span_record(SPAN_KIND_RECV_INTO, t0);
    return r;
}

/* Parse the length-prefix framing natively: scan buf[0..len) for
 * complete `u32 LE total | u32 LE hdrlen` frames and emit one
 * (offset, total, hdrlen) u64 triple per COMPLETE frame into `out`
 * (room for max_frames triples).  Stops at the first incomplete frame
 * (or when `out` is full).  Returns the number of frames emitted, or
 * -EPROTO on a malformed prefix (hdrlen > total): the stream can only
 * desync from a code bug, and a loud error beats a silent misparse. */
int64_t ompi_tpu_net_scan(const uint8_t *buf, int64_t len,
                          uint64_t *out, int64_t max_frames) {
    int64_t off = 0, nf = 0;
    while (nf < max_frames && len - off >= 8) {
        const uint8_t *p = buf + off;
        uint32_t total = (uint32_t)p[0] | ((uint32_t)p[1] << 8)
            | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
        uint32_t hdrlen = (uint32_t)p[4] | ((uint32_t)p[5] << 8)
            | ((uint32_t)p[6] << 16) | ((uint32_t)p[7] << 24);
        if (hdrlen > total)
            return -(int64_t)EPROTO;
        if (len - off - 8 < (int64_t)total)
            break;
        out[3 * nf] = (uint64_t)off;
        out[3 * nf + 1] = (uint64_t)total;
        out[3 * nf + 2] = (uint64_t)hdrlen;
        ++nf;
        off += 8 + (int64_t)total;
    }
    return nf;
}

/* version tag so the loader can detect stale cached builds */
int64_t ompi_tpu_net_abi(void) { return 3; }

#ifdef __cplusplus
}  /* extern "C" */
#endif
