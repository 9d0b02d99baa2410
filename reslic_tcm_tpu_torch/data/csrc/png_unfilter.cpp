// Reverses PNG's five row filters (None, Sub, Up, Average, Paeth; PNG
// specification, section 9) over a decompressed image stream.
//
// The stream holds `rows` rows, each a filter-type byte followed by `stride`
// filtered bytes; `bpp` is the distance in bytes to the corresponding byte
// of the pixel on the left (at least 1). Sub, Average and Paeth read the
// reconstructed byte on the left, so each row runs in sequence; a loop in
// Python takes about a second on a 768x512 image, this one a millisecond.
//
// Built by reslic_tcm_tpu_torch/ops/build.py (g++) and called through ctypes
// by reslic_tcm_tpu_torch/data/png.py.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a);
    const int pb = std::abs(p - b);
    const int pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// Writes rows * stride reconstructed bytes to `out`. Returns 0, or r + 1
// when row r names a filter type above 4 (a corrupt stream).
int png_unfilter(const uint8_t* in, uint8_t* out, int64_t rows, int64_t stride, int bpp) {
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t type = in[r * (stride + 1)];
        const uint8_t* f = in + r * (stride + 1) + 1;
        uint8_t* o = out + r * stride;
        const uint8_t* up = r ? o - stride : nullptr;  // the row above, or zeros
        switch (type) {
            case 0:
                for (int64_t i = 0; i < stride; ++i) o[i] = f[i];
                break;
            case 1:
                for (int64_t i = 0; i < stride; ++i)
                    o[i] = static_cast<uint8_t>(f[i] + (i >= bpp ? o[i - bpp] : 0));
                break;
            case 2:
                for (int64_t i = 0; i < stride; ++i)
                    o[i] = static_cast<uint8_t>(f[i] + (up ? up[i] : 0));
                break;
            case 3:
                for (int64_t i = 0; i < stride; ++i) {
                    const int left = i >= bpp ? o[i - bpp] : 0;
                    const int above = up ? up[i] : 0;
                    o[i] = static_cast<uint8_t>(f[i] + ((left + above) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; ++i) {
                    const int left = i >= bpp ? o[i - bpp] : 0;
                    const int above = up ? up[i] : 0;
                    const int corner = (up && i >= bpp) ? up[i - bpp] : 0;
                    o[i] = static_cast<uint8_t>(f[i] + paeth(left, above, corner));
                }
                break;
            default:
                return static_cast<int>(r + 1);
        }
    }
    return 0;
}

}  // extern "C"
