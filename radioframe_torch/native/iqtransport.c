/* Native IQ sample transport — the host-side hot path.
 *
 * Reference analog (SURVEY.md §2.1 #5): `[U:fpga.c]` — the EXTI ISR that
 * clocks int16 IQ words off the FPGA bus into ring-buffer halves, plus the
 * I2S DMA codec feed. On a TPU host the equivalent hot loop is capture
 * ingest: int16 interleaved IQ -> float32 (complex64 layout) conversion and
 * a lock-free single-producer/single-consumer ring buffer decoupling a
 * capture/reader thread from the jitted compute loop.
 *
 * Built as a plain shared object (cc -O3 -shared -fPIC), loaded via ctypes
 * (radioframe/native/__init__.py) with a numpy fallback — no build-system
 * coupling, per the environment's no-pybind11 constraint.
 */

#include <stdatomic.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- int16 interleaved IQ -> float32 pairs (== complex64 memory layout) */

void iq_i16_to_f32(const int16_t *in, float *out, int64_t n, float scale) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (float)in[i] * scale;
    }
}

/* float32 pairs -> int16 with saturation (TX/DAC direction) */
void iq_f32_to_i16(const float *in, int16_t *out, int64_t n, float scale) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i] * scale;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        out[i] = (int16_t)v;
    }
}

/* interleaved int16 IQ -> two int16 planes (the int16-ingest fast path:
 * the device kernel upcasts in VMEM, so the host never touches f32 and the
 * ring carries half the bytes of the complex64 route) */
void iq_i16_deinterleave(const int16_t *in, int16_t *xr, int16_t *xi,
                         int64_t n_pairs) {
    for (int64_t i = 0; i < n_pairs; ++i) {
        xr[i] = in[2 * i];
        xi[i] = in[2 * i + 1];
    }
}

/* ---- lock-free SPSC byte ring buffer -------------------------------- */

typedef struct {
    uint8_t *buf;
    uint64_t capacity;            /* power of two */
    _Atomic uint64_t head;        /* write cursor (producer) */
    _Atomic uint64_t tail;        /* read cursor (consumer)  */
} ringbuf;

ringbuf *rb_create(uint64_t capacity) {
    /* round capacity up to a power of two */
    uint64_t cap = 1;
    while (cap < capacity) cap <<= 1;
    ringbuf *rb = (ringbuf *)malloc(sizeof(ringbuf));
    if (!rb) return NULL;
    rb->buf = (uint8_t *)malloc(cap);
    if (!rb->buf) { free(rb); return NULL; }
    rb->capacity = cap;
    atomic_store(&rb->head, 0);
    atomic_store(&rb->tail, 0);
    return rb;
}

void rb_destroy(ringbuf *rb) {
    if (rb) { free(rb->buf); free(rb); }
}

uint64_t rb_capacity(const ringbuf *rb) { return rb->capacity; }

uint64_t rb_fill(const ringbuf *rb) {
    return atomic_load(&rb->head) - atomic_load(&rb->tail);
}

/* returns bytes written (0 or n; no partial writes) */
uint64_t rb_write(ringbuf *rb, const uint8_t *src, uint64_t n) {
    uint64_t head = atomic_load_explicit(&rb->head, memory_order_relaxed);
    uint64_t tail = atomic_load_explicit(&rb->tail, memory_order_acquire);
    if (rb->capacity - (head - tail) < n) return 0;  /* would overflow */
    uint64_t pos = head & (rb->capacity - 1);
    uint64_t first = rb->capacity - pos;
    if (first > n) first = n;
    memcpy(rb->buf + pos, src, first);
    memcpy(rb->buf, src + first, n - first);
    atomic_store_explicit(&rb->head, head + n, memory_order_release);
    return n;
}

/* returns bytes read (0 or n; no partial reads) */
uint64_t rb_read(ringbuf *rb, uint8_t *dst, uint64_t n) {
    uint64_t tail = atomic_load_explicit(&rb->tail, memory_order_relaxed);
    uint64_t head = atomic_load_explicit(&rb->head, memory_order_acquire);
    if (head - tail < n) return 0;  /* not enough data */
    uint64_t pos = tail & (rb->capacity - 1);
    uint64_t first = rb->capacity - pos;
    if (first > n) first = n;
    memcpy(dst, rb->buf + pos, first);
    memcpy(dst + first, rb->buf, n - first);
    atomic_store_explicit(&rb->tail, tail + n, memory_order_release);
    return n;
}
