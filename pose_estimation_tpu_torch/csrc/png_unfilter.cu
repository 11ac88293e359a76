// Undo the row filters of an 8-bit grayscale PNG: host code, built into
// the port's kernel library beside the CUDA kernels, called by
// `io/png.py:unfilter` through ctypes. Not a GPU kernel and no counterpart
// of a TPU kernel: the replay readers' image decoding on the host, where
// the Average and Paeth filters predict each byte from its reconstructed
// left and upper neighbours, a sequential loop along the row. Its numpy
// twin is `io/png.py:unfilter_plain`.

#include <cstdlib>

namespace {

inline unsigned char paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<unsigned char>(a);
  return static_cast<unsigned char>(pb <= pc ? b : c);
}

}  // namespace

// rows: height rows of 1 + width bytes (the filter type, then the
// filtered row); out: height x width pixels. Returns 0, or 1 + the index
// of the first row with an unknown filter type.
extern "C" int png_unfilter(const unsigned char* rows, int height, int width,
                            unsigned char* out) {
  for (int r = 0; r < height; ++r) {
    const unsigned char* f = rows + static_cast<size_t>(r) * (width + 1) + 1;
    unsigned char* x = out + static_cast<size_t>(r) * width;
    const unsigned char* up = r > 0 ? x - width : nullptr;
    switch (f[-1]) {
      case 0:
        for (int i = 0; i < width; ++i) x[i] = f[i];
        break;
      case 1:
        for (int i = 0; i < width; ++i) x[i] = f[i] + (i > 0 ? x[i - 1] : 0);
        break;
      case 2:
        for (int i = 0; i < width; ++i) x[i] = f[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int i = 0; i < width; ++i)
          x[i] = f[i] + (((i > 0 ? x[i - 1] : 0) + (up ? up[i] : 0)) >> 1);
        break;
      case 4:
        for (int i = 0; i < width; ++i)
          x[i] = f[i] + paeth(i > 0 ? x[i - 1] : 0, up ? up[i] : 0,
                              (up && i > 0) ? up[i - 1] : 0);
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}
