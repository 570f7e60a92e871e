// Native IO runtime for physicsbasedbayesianinference_tpu.
//
// Two facilities the Python layer calls through ctypes (see
// physicsbasedbayesianinference_tpu/native.py):
//
//  * nbody text parsing — the reference's initial-condition format
//    (header "N tmax dt", N masses, N position rows, N velocity rows;
//    reference samples/NBody/MiscFunctions.py:8-43). The reference parses
//    line-by-line in Python; this tokenizer is several times faster than
//    even a vectorised numpy parse and is the template for larger IC sets.
//
//  * a streaming sample sink — an append-only binary writer for sampler
//    output ([iteration, walker, dim] float32 chunks with a fixed 32-byte
//    header). The reference accumulates all samples in RAM and returns
//    them at the end (reference HMC.py:136-145); at 1e5 walkers that
//    (walkers x dims x iterations x 4) buffer does not fit, so the CLI
//    streams thinned chunks here while the device keeps sampling.
//
// Build: cc -O3 -shared -fPIC csrc/pbbi_io.cpp -o <lib> (driven by
// native.py at import time; no build system needed).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>

extern "C" {

// ---------------------------------------------------------------------------
// N-body text format
// ---------------------------------------------------------------------------

// Parse the header only: returns N, fills tmax/dt. -1 on malformed input.
long pbbi_nbody_header(const char* text, double* tmax, double* dt) {
    char* end = nullptr;
    long n = strtol(text, &end, 10);
    if (end == text || n <= 0) return -1;
    const char* p = end;
    *tmax = strtod(p, &end);
    if (end == p) return -1;
    p = end;
    *dt = strtod(p, &end);
    if (end == p) return -1;
    return n;
}

// Parse the full file into caller-allocated arrays:
//   mass[n], pos[n*3], vel[n*3] (row-major x,y,z per body).
// Returns 0 on success, -1 if fewer than the required 7n+3 numeric tokens.
int pbbi_nbody_parse(const char* text, long n,
                     double* mass, double* pos, double* vel) {
    const char* p = text;
    char* end = nullptr;
    // skip header (3 tokens)
    for (int i = 0; i < 3; ++i) {
        strtod(p, &end);
        if (end == p) return -1;
        p = end;
    }
    double* targets[3] = {mass, pos, vel};
    long counts[3] = {n, n * 3, n * 3};
    for (int t = 0; t < 3; ++t) {
        for (long i = 0; i < counts[t]; ++i) {
            double v = strtod(p, &end);
            if (end == p) return -1;  // ran out of tokens
            targets[t][i] = v;
            p = end;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Streaming sample sink
// ---------------------------------------------------------------------------

struct PbbiSink {
    FILE* f;
    int64_t num_walkers;
    int64_t num_dims;
    int64_t num_rows;  // total [walker, dim] rows appended
};

static const uint32_t PBBI_MAGIC = 0x50424249;  // "PBBI"
static const uint32_t PBBI_VERSION = 1;

// Header layout (32 bytes): magic, version, num_walkers, num_dims,
// num_rows (backfilled on close), reserved.
static int write_header(PbbiSink* s) {
    uint32_t head[8] = {PBBI_MAGIC, PBBI_VERSION,
                        (uint32_t)s->num_walkers, (uint32_t)s->num_dims,
                        (uint32_t)(s->num_rows & 0xffffffffu),
                        (uint32_t)(s->num_rows >> 32), 0, 0};
    if (fseek(s->f, 0, SEEK_SET) != 0) return -1;
    if (fwrite(head, sizeof(head), 1, s->f) != 1) return -1;
    return 0;
}

void* pbbi_sink_open(const char* path, int64_t num_walkers,
                     int64_t num_dims) {
    FILE* f = fopen(path, "wb");
    if (!f) return nullptr;
    PbbiSink* s = (PbbiSink*)malloc(sizeof(PbbiSink));
    s->f = f;
    s->num_walkers = num_walkers;
    s->num_dims = num_dims;
    s->num_rows = 0;
    if (write_header(s) != 0) {
        fclose(f);
        free(s);
        return nullptr;
    }
    return s;
}

// Append num_rows x num_dims float32 values (e.g. one thinned iteration =
// num_walkers rows). Returns total rows so far, or -1 on IO error.
int64_t pbbi_sink_append(void* handle, const float* data, int64_t num_rows) {
    PbbiSink* s = (PbbiSink*)handle;
    size_t count = (size_t)(num_rows * s->num_dims);
    if (fwrite(data, sizeof(float), count, s->f) != count) return -1;
    s->num_rows += num_rows;
    return s->num_rows;
}

int pbbi_sink_close(void* handle) {
    PbbiSink* s = (PbbiSink*)handle;
    int rc = write_header(s);  // backfill the row count
    rc |= fclose(s->f);
    free(s);
    return rc;
}

// Read a sink file's header; returns num_rows (or -1), fills walkers/dims.
int64_t pbbi_sink_info(const char* path, int64_t* num_walkers,
                       int64_t* num_dims) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint32_t head[8];
    if (fread(head, sizeof(head), 1, f) != 1 || head[0] != PBBI_MAGIC) {
        fclose(f);
        return -1;
    }
    *num_walkers = head[2];
    *num_dims = head[3];
    int64_t rows = (int64_t)head[4] | ((int64_t)head[5] << 32);
    fclose(f);
    return rows;
}

}  // extern "C"
