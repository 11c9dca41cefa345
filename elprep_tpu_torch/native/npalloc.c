/* Custom numpy data allocator for virtualized hosts with pathologically
 * slow private-anonymous page faults.
 *
 * On the target VM, first-touch of private anon memory (malloc/brk)
 * faults at ~70 MB/s while MAP_SHARED anonymous memory faults at
 * ~1.2 GB/s (measured; see README "virtualized-host malloc" note).
 * Large numpy buffers (padded [n, L] columns at WGS scale) therefore
 * cost seconds per allocation on the default allocator.  This handler
 * routes allocations >= BIG_THRESHOLD through MAP_SHARED anonymous
 * mmap and leaves small ones on malloc (where glibc heap reuse,
 * configured by native.tune_malloc, already makes them cheap).
 *
 * Installed via numpy's PyDataMem_SetHandler (numpy >= 1.22); numpy
 * tracks the owning handler per array, so arrays allocated before
 * installation free through the default allocator safely.
 */
#define NPY_NO_DEPRECATED_API NPY_1_22_API_VERSION
#define NPY_TARGET_VERSION NPY_1_22_API_VERSION
#include <Python.h>
#include <numpy/arrayobject.h>

#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>

#define BIG_THRESHOLD ((size_t)(1u << 20)) /* 1 MiB */
#define HDR 64                             /* keeps 64-byte alignment */
#define MAGIC_MMAP 0x454c4d4d41503031ULL
#define MAGIC_MALLOC 0x454c4d414c303031ULL

typedef struct {
  uint64_t magic;
  size_t total; /* full mapping/malloc size including header */
} blk_hdr;

/* Free-list of MAP_SHARED segments: a reused mapping's pages are
 * already faulted in, so repeated large allocations (the per-chunk
 * padded columns, parse temporaries) cost ~nothing instead of a full
 * refault per allocation. Bounded slots + bytes keep RSS in check.
 *
 * The byte bound should exceed the whole phase's working set of big
 * temporaries, not just the largest column: this host's fresh-page
 * fault rate oscillates 40 MB/s - 1.4 GB/s (microbenched) while warm
 * rewrites run 3-5 GB/s, so every refault risks the slow path. With
 * 125 GiB RAM the default is 24 GiB; ELPREP_TPU_NPALLOC_CACHE_MB
 * overrides (0 disables caching). */
#define CACHE_SLOTS_MAX 128
#define CACHE_SLOTS_DEFAULT 64
#define CACHE_DEFAULT_BYTES ((size_t)24 << 30) /* 24 GiB (host: 125 GiB) */
static size_t cache_max_bytes = CACHE_DEFAULT_BYTES;
static int cache_slots = CACHE_SLOTS_DEFAULT;
static pthread_mutex_t cache_mu = PTHREAD_MUTEX_INITIALIZER;
static struct {
  void *p;
  size_t total;
} seg_cache[CACHE_SLOTS_MAX];
static size_t cache_bytes = 0;

__attribute__((constructor)) static void cache_init_from_env(void) {
  const char *v = getenv("ELPREP_TPU_NPALLOC_CACHE_MB");
  if (v && *v) {
    char *end = NULL;
    unsigned long long mb = strtoull(v, &end, 10);
    if (end && *end == '\0') cache_max_bytes = (size_t)mb << 20;
  }
  v = getenv("ELPREP_TPU_NPALLOC_SLOTS");
  if (v && *v) {
    char *end = NULL;
    unsigned long long s = strtoull(v, &end, 10);
    if (end && *end == '\0' && s >= 1 && s <= CACHE_SLOTS_MAX)
      cache_slots = (int)s;
  }
}

/* Quantize big mapping sizes to 4 MiB multiples (16 MiB above 256 MiB):
 * varied request sizes then land on identical segment sizes, so the
 * free-list hit rate stays high at WGS scale where thousands of
 * near-but-not-equal-sized parse temporaries otherwise each refault a
 * fresh mapping. Untouched excess MAP_SHARED pages are never faulted,
 * so the rounding costs address space, not RSS. */
static size_t quantize_total(size_t total) {
  size_t q = total > ((size_t)256 << 20) ? ((size_t)16 << 20)
                                         : ((size_t)4 << 20);
  return (total + q - 1) / q * q;
}

static void *cache_take(size_t total_need) {
  int best = -1;
  void *p = NULL;
  pthread_mutex_lock(&cache_mu);
  for (int i = 0; i < cache_slots; i++) {
    /* best fit, capped at 2x to bound internal waste (sizes are
     * quantized, so same-class requests hit exactly) */
    if (seg_cache[i].p && seg_cache[i].total >= total_need &&
        seg_cache[i].total <= 2 * total_need) {
      if (best < 0 || seg_cache[i].total < seg_cache[best].total) best = i;
    }
  }
  if (best >= 0) {
    p = seg_cache[best].p;
    cache_bytes -= seg_cache[best].total;
    seg_cache[best].p = NULL;
  }
  pthread_mutex_unlock(&cache_mu);
  return p;
}

static int cache_put(void *p, size_t total) {
  int stored = 0;
  int victim = -1;
  void *victim_p = NULL;
  size_t victim_total = 0;
  if (total > cache_max_bytes / 2) return 0;
  pthread_mutex_lock(&cache_mu);
  if (cache_bytes + total <= cache_max_bytes) {
    for (int i = 0; i < cache_slots; i++) {
      if (seg_cache[i].p == NULL) {
        seg_cache[i].p = p;
        seg_cache[i].total = total;
        cache_bytes += total;
        stored = 1;
        break;
      }
    }
    if (!stored) {
      /* all slots held: evict the smallest cached segment if this one
       * is larger (warm big segments are the expensive ones to lose) */
      for (int i = 0; i < cache_slots; i++) {
        if (victim < 0 || seg_cache[i].total < seg_cache[victim].total)
          victim = i;
      }
      if (victim >= 0 && seg_cache[victim].total < total) {
        victim_p = seg_cache[victim].p;
        victim_total = seg_cache[victim].total;
        cache_bytes += total - victim_total;
        seg_cache[victim].p = p;
        seg_cache[victim].total = total;
        stored = 1;
      }
    }
  }
  pthread_mutex_unlock(&cache_mu);
  if (victim_p != NULL) munmap(victim_p, victim_total);
  return stored;
}

static void *blk_alloc(size_t size, int zero) {
  size_t total = size + HDR;
  blk_hdr *h;
  if (size >= BIG_THRESHOLD) {
    total = quantize_total(total);
    void *p = cache_take(total);
    if (p != NULL) {
      h = (blk_hdr *)p;
      /* h->total still holds the full mapping size */
      h->magic = MAGIC_MMAP;
      if (zero) memset((char *)p + HDR, 0, size);
      return (char *)p + HDR;
    }
    p = mmap(NULL, total, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_ANONYMOUS, -1, 0);
    if (p != MAP_FAILED) {
      h = (blk_hdr *)p;
      h->magic = MAGIC_MMAP;
      h->total = total;
      return (char *)p + HDR; /* mmap memory is already zeroed */
    }
    /* fall through to malloc on mmap failure */
  }
  h = (blk_hdr *)(zero ? calloc(1, total) : malloc(total));
  if (h == NULL) return NULL;
  h->magic = MAGIC_MALLOC;
  h->total = total;
  return (char *)h + HDR;
}

static void blk_free(void *ptr) {
  blk_hdr *h;
  if (ptr == NULL) return;
  h = (blk_hdr *)((char *)ptr - HDR);
  if (h->magic == MAGIC_MMAP) {
    if (!cache_put(h, h->total)) munmap(h, h->total);
  } else {
    free(h);
  }
}

static void *np_malloc(void *ctx, size_t size) {
  (void)ctx;
  return blk_alloc(size, 0);
}

static void *np_calloc(void *ctx, size_t nelem, size_t elsize) {
  size_t size = nelem * elsize;
  (void)ctx;
  if (elsize != 0 && size / elsize != nelem) return NULL;
  return blk_alloc(size, 1);
}

static void *np_realloc(void *ctx, void *ptr, size_t new_size) {
  blk_hdr *h;
  void *np;
  size_t old_payload;
  (void)ctx;
  if (ptr == NULL) return blk_alloc(new_size, 0);
  h = (blk_hdr *)((char *)ptr - HDR);
  old_payload = h->total - HDR;
  if (h->magic == MAGIC_MALLOC && new_size < BIG_THRESHOLD) {
    blk_hdr *nh = (blk_hdr *)realloc(h, new_size + HDR);
    if (nh == NULL) return NULL;
    nh->total = new_size + HDR;
    return (char *)nh + HDR;
  }
  np = blk_alloc(new_size, 0);
  if (np == NULL) return NULL;
  memcpy(np, ptr, old_payload < new_size ? old_payload : new_size);
  blk_free(ptr);
  return np;
}

static void np_free(void *ctx, void *ptr, size_t size) {
  (void)ctx;
  (void)size;
  blk_free(ptr);
}

static PyDataMem_Handler handler = {
    "elprep_shared_mmap_allocator",
    1,
    {
        NULL,
        np_malloc,
        np_calloc,
        np_realloc,
        np_free,
    },
};

static PyObject *install(PyObject *self, PyObject *args) {
  PyObject *cap, *old;
  (void)self;
  (void)args;
  cap = PyCapsule_New(&handler, "mem_handler", NULL);
  if (cap == NULL) return NULL;
  old = PyDataMem_SetHandler(cap);
  Py_DECREF(cap);
  if (old == NULL) return NULL;
  Py_DECREF(old);
  Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"install", install, METH_NOARGS,
     "Install the MAP_SHARED-backed numpy data allocator."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_npalloc", NULL, -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__npalloc(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
