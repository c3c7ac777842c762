// mfas_io: host-side IO for the NTU data layer of mfas_tpu_torch, a copy
// of mfas_tpu/data/cpp/mfas_io.cpp (the two parsers agree bitwise):
//   * mfas_parse_skeleton: NTU .skeleton text parser (a single-pass strtof
//     scanner, GIL-free; the numpy parser in data/ntu.py is its reference);
//   * mfas_gather_normalize_u8: batched gather of packed uint8 video
//     samples + fused /255, mean/std normalize into a float batch,
//     multi-threaded;
//   * mfas_gather_f32: threaded gather of float32 rows.
//
// Host C++, not a device kernel. Exposed as a plain C ABI for ctypes and
// built by data/native.py with g++ at first use.

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// NTU skeleton text parser
// ---------------------------------------------------------------------------
// Layout (https://github.com/shahroudy/NTURGB-D read_skeleton_file):
//   line 0: num_frames
//   per frame: person_count; per person: info line, joint-count line,
//   25 joint lines whose first three floats are x y z.
// Output: out[3 * max_frames * 25 * 2] in (coord, frame, joint, person)
// order (C-contiguous (3, T, 25, 2) with T = max_frames).
// Persons beyond 2 are parsed and dropped (the reference swallows them,
// datasets/ntu.py:66-71). NaNs are zeroed. Returns the frame count in the
// file, -1 on IO error, or -2 on a truncated/malformed file (premature
// EOF, or implausible person/joint counts that would desync the scanner
// into silently writing zeros — the Python oracle raises on such files).
int mfas_parse_skeleton(const char* path, float* out, int max_frames) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(size + 1);
    if (fread(buf.data(), 1, size, f) != (size_t)size) { fclose(f); return -1; }
    fclose(f);
    buf[size] = '\0';

    const char* p = buf.data();
    const char* end = buf.data() + size;

    auto skip_ws = [&]() { while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p; };
    auto next_line = [&]() { while (p < end && *p != '\n') ++p; if (p < end) ++p; };
    auto read_int = [&]() -> long {
        skip_ws();
        char* q;
        long v = strtol(p, &q, 10);
        p = q;
        return v;
    };
    auto read_float = [&]() -> float {
        skip_ws();
        char* q;
        float v = strtof(p, &q);
        p = q;
        return v;
    };

    long num_frames = read_int();
    next_line();
    if (num_frames <= 0 || num_frames > 100000) return -2;

    const long T = max_frames;
    const long joint_stride = 2;            // persons
    const long frame_stride = 25 * 2;       // joints * persons
    const long coord_stride = T * 25 * 2;

    for (long t = 0; t < num_frames; ++t) {
        if (p >= end) return -2;             // truncated mid-file
        long nb_person = read_int();
        next_line();
        if (nb_person < 0 || nb_person > 16) return -2;
        for (long person = 0; person < nb_person; ++person) {
            next_line();                     // person info line
            long nj = read_int();            // joint-count line
            next_line();
            if (nj <= 0) nj = 25;
            if (nj > 100) return -2;
            for (long j = 0; j < nj; ++j) {
                if (p >= end) return -2;     // truncated mid-joint
                float x = read_float();
                float y = read_float();
                float z = read_float();
                next_line();                 // rest of the joint line
                if (person < 2 && t < T && j < 25) {
                    if (x != x) x = 0.f;     // NaN -> 0
                    if (y != y) y = 0.f;
                    if (z != z) z = 0.f;
                    long base = t * frame_stride + j * joint_stride + person;
                    out[0 * coord_stride + base] = x;
                    out[1 * coord_stride + base] = y;
                    out[2 * coord_stride + base] = z;
                }
            }
        }
    }
    return (int)num_frames;
}

// ---------------------------------------------------------------------------
// threaded batch gather + fused u8 -> f32 normalize
// ---------------------------------------------------------------------------
// base: packed uint8 store, samples of sample_elems bytes each, innermost
// dimension = channels with per-channel mean/std (after /255).
// out: float32 [n_idx, sample_elems].
void mfas_gather_normalize_u8(const uint8_t* base, const int64_t* indices,
                              int64_t n_idx, int64_t sample_elems,
                              const float* mean, const float* stddev,
                              int channels, float* out, int num_threads) {
    if (num_threads < 1) num_threads = 1;
    if (num_threads > n_idx) num_threads = (int)n_idx;   // no idle spawns
    // precompute per-channel scale/bias: (v/255 - mean)/std = v*s + b
    std::vector<float> scale(channels), bias(channels);
    for (int c = 0; c < channels; ++c) {
        scale[c] = 1.0f / (255.0f * stddev[c]);
        bias[c] = -mean[c] / stddev[c];
    }
    std::atomic<int64_t> cursor(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = cursor.fetch_add(1);
            if (i >= n_idx) return;
            const uint8_t* src = base + indices[i] * sample_elems;
            float* dst = out + i * sample_elems;
            if (channels == 3) {
                int64_t e = 0;
                const float s0 = scale[0], s1 = scale[1], s2 = scale[2];
                const float b0 = bias[0], b1 = bias[1], b2 = bias[2];
                for (; e + 2 < sample_elems; e += 3) {
                    dst[e] = src[e] * s0 + b0;
                    dst[e + 1] = src[e + 1] * s1 + b1;
                    dst[e + 2] = src[e + 2] * s2 + b2;
                }
            } else {
                for (int64_t e = 0; e < sample_elems; ++e) {
                    int c = (int)(e % channels);
                    dst[e] = src[e] * scale[c] + bias[c];
                }
            }
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < num_threads; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
}

// threaded gather of float32 rows: out[i] = base[indices[i]]
void mfas_gather_f32(const float* base, const int64_t* indices, int64_t n_idx,
                     int64_t sample_elems, float* out, int num_threads) {
    if (num_threads < 1) num_threads = 1;
    if (num_threads > n_idx) num_threads = (int)n_idx;   // no idle spawns
    std::atomic<int64_t> cursor(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = cursor.fetch_add(1);
            if (i >= n_idx) return;
            memcpy(out + i * sample_elems, base + indices[i] * sample_elems,
                   sample_elems * sizeof(float));
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < num_threads; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
}

}  // extern "C"
