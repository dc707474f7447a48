/* A chunk's messages packed into the prehash's flat byte stream straight
 * from their Python str objects, on the host.
 *
 * The stream buffer is the one ops/place_preimages.py stream_buffer makes
 * and kernel place_preimages reads: offsets int64[B + 1] (prefix sums of
 * the messages' byte lengths), then the message bytes back to back, then
 * zeros to the buffer's end (whole words, one past the last byte).  The
 * plain route joins the messages into one str, encodes it, takes the
 * lengths one by one and copies the bytes once more; these two calls read
 * each message where it lies and copy its bytes once.
 *
 * Only compact ASCII str objects qualify: their UTF-8 encoding is their
 * one-byte-a-character data, as long as the text.  Anything else returns
 * -1 from the first call, and the caller takes the plain route.
 *
 * Both calls run holding the GIL (ctypes.PyDLL) and read the list and its
 * items without taking references: the caller holds the list throughout.
 * The copy may be split over threads by disjoint byte ranges; those threads
 * touch no Python object, only the data pointers the calling thread read.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_THREADS 64

/* Phase 1: offsets[0..B] <- the prefix sums of the B messages' lengths.
 * Returns the longest length, or -1 when `messages` is not a list of B
 * compact ASCII str objects. */
int64_t fct_pack_offsets(PyObject *messages, int64_t B, int64_t *offsets) {
  if (!PyList_Check(messages) || PyList_GET_SIZE(messages) != B) return -1;
  int64_t at = 0, longest = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < B; ++i) {
    PyObject *m = PyList_GET_ITEM(messages, i);
    if (!PyUnicode_Check(m) || !PyUnicode_IS_COMPACT_ASCII(m)) return -1;
    const int64_t n = PyUnicode_GET_LENGTH(m);
    at += n;
    offsets[i + 1] = at;
    if (n > longest) longest = n;
  }
  return longest;
}

typedef struct {
  const char *const *src; /* each message's bytes */
  const int64_t *offsets;
  int64_t B;
  uint8_t *dst;           /* the stream: dst[offsets[i]] is message i's first byte */
  int64_t lo, hi;         /* the byte range of the stream this share copies */
} Share;

/* The parts of messages that fall in [lo, hi) of the stream. */
static void *copy_share(void *arg) {
  const Share *s = (const Share *)arg;
  int64_t a = 0, b = s->B; /* first message that ends past lo */
  while (a < b) {
    const int64_t mid = a + (b - a) / 2;
    if (s->offsets[mid + 1] <= s->lo) a = mid + 1; else b = mid;
  }
  for (int64_t i = a; i < s->B && s->offsets[i] < s->hi; ++i) {
    const int64_t from = s->offsets[i] > s->lo ? s->offsets[i] : s->lo;
    const int64_t to = s->offsets[i + 1] < s->hi ? s->offsets[i + 1] : s->hi;
    if (to > from) memcpy(s->dst + from, s->src[i] + (from - s->offsets[i]), (size_t)(to - from));
  }
  return NULL;
}

/* Phase 2: buf[0 .. size) <- offsets int64[B + 1], the B messages' bytes at
 * their offsets, zeros to the end.  One thread copies each message as it
 * walks the list; more (`threads`, the calling one among them) first read
 * every data pointer, then copy disjoint byte ranges.  Returns 0, or -1
 * when the list no longer matches `offsets` (no byte is written past a
 * length checked against them) or the buffer is too small. */
int fct_pack_fill(PyObject *messages, const int64_t *offsets, int64_t B, uint8_t *buf,
                  int64_t size, int threads) {
  const int64_t head = 8 * (B + 1), total = offsets[B];
  if (!PyList_Check(messages) || PyList_GET_SIZE(messages) != B || size < head + total + 1)
    return -1;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const char **src = threads > 1 ? (const char **)malloc((size_t)B * sizeof(char *)) : NULL;
  uint8_t *stream = buf + head;
  for (int64_t i = 0; i < B; ++i) {
    PyObject *m = PyList_GET_ITEM(messages, i);
    const int64_t n = offsets[i + 1] - offsets[i];
    if (!PyUnicode_Check(m) || !PyUnicode_IS_COMPACT_ASCII(m) || PyUnicode_GET_LENGTH(m) != n) {
      free(src);
      return -1;
    }
    if (src != NULL) src[i] = (const char *)PyUnicode_DATA(m);
    else memcpy(stream + offsets[i], PyUnicode_DATA(m), (size_t)n);
  }
  if (src != NULL) {
    Share share[MAX_THREADS];
    pthread_t tid[MAX_THREADS];
    int started = 0;
    for (int t = 0; t < threads; ++t)
      share[t] = (Share){src, offsets, B, stream, total * t / threads, total * (t + 1) / threads};
    for (int t = 1; t < threads; ++t, ++started)
      if (pthread_create(&tid[t], NULL, copy_share, &share[t]) != 0) break;
    copy_share(&share[0]);
    for (int t = 1; t <= started; ++t) pthread_join(tid[t], NULL);
    for (int t = started + 1; t < threads; ++t) copy_share(&share[t]); /* not started */
    free(src);
  }
  memcpy(buf, offsets, (size_t)head);
  memset(stream + total, 0, (size_t)(size - head - total));
  return 0;
}
