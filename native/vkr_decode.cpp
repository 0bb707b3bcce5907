// Native host-side decoders for the rptr JAX path tracing framework.
//
// The reference keeps its hot host paths in C (ext/libvkr/src/vkr.c:
// vkr_dequantize_* are explicitly marked "TODO: Vectorize and/or
// multithread this") and C++ (BCn texture reads via mmap). This library is
// the equivalent native layer: OpenMP-parallel decoders for the quantized
// scene formats and BCn texture blocks, bound into Python via ctypes
// (realtimepathtracingresearchframework_tpu/native.py). The numpy
// implementations in models/quantization.py and models/texture.py remain
// the reference semantics (and the fallback when the library isn't built).
//
// Decode conventions (must match models/quantization.py bit-for-bit):
// - positions: q_axis * scale[axis] + offset[axis], bits x=0..20, y=21..41,
//   z=42..62 (librender/dequantize.glsl:8-21)
// - normals: 16-bit L1-octahedral + normalize (dequantize.glsl:23-41)
// - uv: u = qu*8/65535, v = 1 - qv*8/65535 (dequantize.glsl:43-48)
// - transforms: f32x3 translation + f32 signed scale + u16x4 quaternion of
//   the transposed linear part with negated w (vkr.c:1346-1410)

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

void rptr_dequantize_vertices(const uint64_t* vq, int64_t n,
                              const float* scale, const float* offset,
                              float* out /* n*3 */) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t q = vq[i];
        out[3 * i + 0] = (float)(q & 0x1FFFFFu) * scale[0] + offset[0];
        out[3 * i + 1] = (float)((q >> 21) & 0x1FFFFFu) * scale[1] + offset[1];
        out[3 * i + 2] = (float)((q >> 42) & 0x1FFFFFu) * scale[2] + offset[2];
    }
}

void rptr_dequantize_normal_uv(const uint64_t* nq, int64_t n,
                               float* normals /* n*3 */, float* uvs /* n*2 */) {
    // decode in double, normalize in float — matches the numpy reference
    // (models/quantization.py) bit-for-bit so golden images are identical
    // regardless of which decoder ran
    const float uv_scale = 8.0f / 65535.0f;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t q = nq[i];
        double nx = ((int)(q & 0xFFFFu) - 0x8000) / 32767.0;
        double ny = ((int)((q >> 16) & 0xFFFFu) - 0x8000) / 32767.0;
        const double l1 = std::fabs(nx) + std::fabs(ny);
        if (l1 >= 1.0) {
            const double fx = (1.0 - std::fabs(ny)) * (nx >= 0.0 ? 1.0 : -1.0);
            const double fy = (1.0 - std::fabs(nx)) * (ny >= 0.0 ? 1.0 : -1.0);
            nx = fx;
            ny = fy;
        }
        const float x = (float)nx, y = (float)ny, z = (float)(1.0 - l1);
        const float len = std::sqrt(x * x + y * y + z * z);
        normals[3 * i + 0] = x / len;
        normals[3 * i + 1] = y / len;
        normals[3 * i + 2] = z / len;
        uvs[2 * i + 0] = (float)((q >> 32) & 0xFFFFu) * uv_scale;
        uvs[2 * i + 1] = 1.0f - (float)((q >> 48) & 0xFFFFu) * uv_scale;
    }
}

void rptr_dequantize_transforms(const uint8_t* blob, int64_t n,
                                float* out /* n*12, row-major 3x4 */) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* p = blob + 24 * i;
        float tr[3], scaling;
        uint16_t qq[4];
        std::memcpy(tr, p, 12);
        std::memcpy(&scaling, p + 12, 4);
        std::memcpy(qq, p + 16, 8);
        double q[4];
        for (int k = 0; k < 4; ++k)
            q[k] = qq[k] * (2.0 / 65535.0) - 1.0;
        q[3] = -q[3];
        const double x = q[0], y = q[1], z = q[2], w = q[3];
        // quaternion -> matrix (of the transposed linear part), then
        // transpose back and scale
        double m[3][3] = {
            {1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)},
            {2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)},
            {2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)},
        };
        float* o = out + 12 * i;
        for (int r = 0; r < 3; ++r) {
            for (int c = 0; c < 3; ++c)
                o[4 * r + c] = (float)(m[c][r] * scaling);  // transpose
            o[4 * r + 3] = tr[r];
        }
    }
}

// ---------------------------------------------------------------------------
// BCn block decompression (models/texture.py conventions)
// ---------------------------------------------------------------------------

static inline void expand565(uint16_t c, int rgb[3]) {
    int r = (c >> 11) & 0x1F, g = (c >> 5) & 0x3F, b = c & 0x1F;
    rgb[0] = (r << 3) | (r >> 2);
    rgb[1] = (g << 2) | (g >> 4);
    rgb[2] = (b << 3) | (b >> 2);
}

void rptr_decode_bc1(const uint8_t* data, int width, int height, int opaque,
                     uint8_t* out /* h*w*4 */) {
    const int bw = (width + 3) / 4, bh = (height + 3) / 4;
#pragma omp parallel for schedule(static)
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* blk = data + 8 * (by * bw + bx);
            uint16_t c0, c1;
            uint32_t idx;
            std::memcpy(&c0, blk, 2);
            std::memcpy(&c1, blk + 2, 2);
            std::memcpy(&idx, blk + 4, 4);
            int p0[3], p1[3];
            expand565(c0, p0);
            expand565(c1, p1);
            int pal[4][4];
            for (int k = 0; k < 3; ++k) {
                pal[0][k] = p0[k];
                pal[1][k] = p1[k];
            }
            pal[0][3] = pal[1][3] = pal[2][3] = 255;
            if (c0 > c1) {
                for (int k = 0; k < 3; ++k) {
                    pal[2][k] = (2 * p0[k] + p1[k] + 1) / 3;
                    pal[3][k] = (p0[k] + 2 * p1[k] + 1) / 3;
                }
                pal[3][3] = 255;
            } else {
                for (int k = 0; k < 3; ++k) {
                    pal[2][k] = (p0[k] + p1[k]) / 2;
                    pal[3][k] = 0;
                }
                pal[3][3] = opaque ? 255 : 0;
            }
            for (int t = 0; t < 16; ++t) {
                const int px = bx * 4 + (t & 3), py = by * 4 + (t >> 2);
                if (px >= width || py >= height) continue;
                const int sel = (idx >> (2 * t)) & 3;
                uint8_t* o = out + 4 * ((int64_t)py * width + px);
                for (int k = 0; k < 4; ++k) o[k] = (uint8_t)pal[sel][k];
            }
        }
    }
}

static void decode_bc4_block(const uint8_t* blk, uint8_t vals[16]) {
    const int a0 = blk[0], a1 = blk[1];
    uint64_t bits = 0;
    for (int k = 0; k < 6; ++k) bits |= (uint64_t)blk[2 + k] << (8 * k);
    for (int t = 0; t < 16; ++t) {
        const int sel = (int)((bits >> (3 * t)) & 7);
        int v;
        if (sel == 0) v = a0;
        else if (sel == 1) v = a1;
        else if (a0 > a1) v = ((8 - sel) * a0 + (sel - 1) * a1) / 7;
        else if (sel == 6) v = 0;
        else if (sel == 7) v = 255;
        else v = ((6 - sel) * a0 + (sel - 1) * a1) / 5;
        vals[t] = (uint8_t)v;
    }
}

void rptr_decode_bc3(const uint8_t* data, int width, int height, uint8_t* out) {
    const int bw = (width + 3) / 4, bh = (height + 3) / 4;
#pragma omp parallel for schedule(static)
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* blk = data + 16 * (by * bw + bx);
            uint8_t alpha[16];
            decode_bc4_block(blk, alpha);
            // color part: always 4-color mode
            uint16_t c0, c1;
            uint32_t idx;
            std::memcpy(&c0, blk + 8, 2);
            std::memcpy(&c1, blk + 10, 2);
            std::memcpy(&idx, blk + 12, 4);
            int p0[3], p1[3];
            expand565(c0, p0);
            expand565(c1, p1);
            int pal[4][3];
            bool four = c0 > c1;
            for (int k = 0; k < 3; ++k) {
                pal[0][k] = p0[k];
                pal[1][k] = p1[k];
                pal[2][k] = four ? (2 * p0[k] + p1[k] + 1) / 3 : (p0[k] + p1[k]) / 2;
                pal[3][k] = four ? (p0[k] + 2 * p1[k] + 1) / 3 : 0;
            }
            for (int t = 0; t < 16; ++t) {
                const int px = bx * 4 + (t & 3), py = by * 4 + (t >> 2);
                if (px >= width || py >= height) continue;
                const int sel = (idx >> (2 * t)) & 3;
                uint8_t* o = out + 4 * ((int64_t)py * width + px);
                for (int k = 0; k < 3; ++k) o[k] = (uint8_t)pal[sel][k];
                o[3] = alpha[t];
            }
        }
    }
}

void rptr_decode_bc5(const uint8_t* data, int width, int height, uint8_t* out) {
    const int bw = (width + 3) / 4, bh = (height + 3) / 4;
#pragma omp parallel for schedule(static)
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* blk = data + 16 * (by * bw + bx);
            uint8_t r[16], g[16];
            decode_bc4_block(blk, r);
            decode_bc4_block(blk + 8, g);
            for (int t = 0; t < 16; ++t) {
                const int px = bx * 4 + (t & 3), py = by * 4 + (t >> 2);
                if (px >= width || py >= height) continue;
                uint8_t* o = out + 4 * ((int64_t)py * width + px);
                o[0] = r[t];
                o[1] = g[t];
                o[2] = 0;
                o[3] = 255;
            }
        }
    }
}

int rptr_native_version(void) { return 1; }

}  // extern "C"
