/* SPSC byte ring buffer + UDP drain loop for the SDR ingest front end.
 *
 * The port's own copy of the JAX package's native/sdr_ring.c (same
 * functions, same semantics). At 250 ksps complex64 the IQ stream is
 * ~2 MB/s and bursty; a Python-thread recvfrom loop drops packets
 * whenever the GIL is held (by torch dispatch here). This is a
 * single-producer/single-consumer ring written by a C receive loop that
 * runs entirely outside the GIL (ctypes releases it for the duration of
 * the call), popped by the DSP thread in fixed-size chunks.
 *
 * Build: cc -O2 -shared -fPIC -o sdr_ring.so sdr_ring.c
 * (native/ring.py compiles it on first use into build/native/).
 */

#include <poll.h>
#include <stdatomic.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>

typedef struct {
    uint8_t *buf;
    size_t cap;
    /* Monotonic byte counters; index = counter % cap. SPSC: head is
     * written only by the producer, tail only by the consumer. */
    _Atomic uint64_t head;
    _Atomic uint64_t tail;
    _Atomic uint64_t dropped;   /* bytes discarded because the ring was full */
    _Atomic uint64_t received;  /* bytes accepted */
} ring_t;

ring_t *ring_create(size_t cap) {
    ring_t *r = calloc(1, sizeof(ring_t));
    if (!r) return NULL;
    r->buf = malloc(cap);
    if (!r->buf) { free(r); return NULL; }
    r->cap = cap;
    return r;
}

void ring_destroy(ring_t *r) {
    if (r) { free(r->buf); free(r); }
}

size_t ring_capacity(ring_t *r) { return r->cap; }

size_t ring_size(ring_t *r) {
    uint64_t h = atomic_load_explicit(&r->head, memory_order_acquire);
    uint64_t t = atomic_load_explicit(&r->tail, memory_order_acquire);
    return (size_t)(h - t);
}

uint64_t ring_dropped(ring_t *r) {
    return atomic_load_explicit(&r->dropped, memory_order_relaxed);
}

uint64_t ring_received(ring_t *r) {
    return atomic_load_explicit(&r->received, memory_order_relaxed);
}

/* Producer side. Whole-datagram semantics: a packet that does not fit
 * is dropped entirely (partial IQ frames would desync the stream). */
size_t ring_push(ring_t *r, const uint8_t *data, size_t n) {
    uint64_t h = atomic_load_explicit(&r->head, memory_order_relaxed);
    uint64_t t = atomic_load_explicit(&r->tail, memory_order_acquire);
    if (n > r->cap - (size_t)(h - t)) {
        atomic_fetch_add_explicit(&r->dropped, n, memory_order_relaxed);
        return 0;
    }
    size_t idx = (size_t)(h % r->cap);
    size_t first = r->cap - idx < n ? r->cap - idx : n;
    memcpy(r->buf + idx, data, first);
    memcpy(r->buf, data + first, n - first);
    atomic_store_explicit(&r->head, h + n, memory_order_release);
    atomic_fetch_add_explicit(&r->received, n, memory_order_relaxed);
    return n;
}

/* Consumer side: pops up to n bytes, returns the count. */
size_t ring_pop(ring_t *r, uint8_t *out, size_t n) {
    uint64_t h = atomic_load_explicit(&r->head, memory_order_acquire);
    uint64_t t = atomic_load_explicit(&r->tail, memory_order_relaxed);
    size_t avail = (size_t)(h - t);
    if (n > avail) n = avail;
    if (n == 0) return 0;
    size_t idx = (size_t)(t % r->cap);
    size_t first = r->cap - idx < n ? r->cap - idx : n;
    memcpy(out, r->buf + idx, first);
    memcpy(out + first, r->buf, n - first);
    atomic_store_explicit(&r->tail, t + n, memory_order_release);
    return n;
}

/* Drain a bound UDP socket into the ring until `max_bytes` accepted or
 * `idle_timeout_ms` passes with no traffic. Runs with the GIL released
 * (plain ctypes call); returns bytes accepted, -1 on poll error. */
long ring_recv_udp(ring_t *r, int sockfd, long max_bytes,
                   int idle_timeout_ms) {
    uint8_t pkt[65536];
    long got = 0;
    struct pollfd pfd = { .fd = sockfd, .events = POLLIN };
    while (got < max_bytes) {
        int pr = poll(&pfd, 1, idle_timeout_ms);
        if (pr < 0) return -1;
        if (pr == 0) break; /* idle: stream ended */
        ssize_t n = recv(sockfd, pkt, sizeof(pkt), 0);
        if (n <= 0) break;
        got += (long)ring_push(r, pkt, (size_t)n);
    }
    return got;
}
