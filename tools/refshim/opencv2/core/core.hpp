// Minimal cv::Mat / imread / imwrite shim — just enough OpenCV 2.4 API to
// compile and run the reference STMatching pipeline headless, so this
// repo's outputs can be diffed against the REAL reference executable
// (north-star parity clause). Image I/O is binary PGM/PPM only (P5/P6);
// the Python harness converts PNG <-> PPM losslessly. imread mimics
// OpenCV's BGR channel order.
//
// This file is part of the verification harness of this framework; it
// contains no reference code. API coverage is exactly what
// STMatching/{StereoDisparity,StereoHelper,SegmentTree,Toolkit,main}.cpp
// touch: Mat (CV_8U/CV_8UC3/CV_32F, continuous), Mat1b/Mat1f/Mat3b views,
// Size, Scalar, InputArray/OutputArray, CV_Assert, saturating *=.
#ifndef GSM_REFSHIM_CORE_HPP
#define GSM_REFSHIM_CORE_HPP

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <type_traits>
#include <vector>
#include <math.h>  // ::fabs, as OpenCV's core headers expose it

#ifndef MIN
#define MIN(a, b) ((a) > (b) ? (b) : (a))
#endif
#ifndef MAX
#define MAX(a, b) ((a) < (b) ? (b) : (a))
#endif

#define CV_8U 0
#define CV_32F 5
#define CV_8UC1 0
#define CV_8UC3 16  // depth | ((channels-1) << 3), as in OpenCV
#define CV_32FC1 5

#define CV_Assert(expr)                                              \
  do {                                                               \
    if (!(expr)) {                                                   \
      std::fprintf(stderr, "CV_Assert failed: %s at %s:%d\n", #expr, \
                   __FILE__, __LINE__);                              \
      std::abort();                                                  \
    }                                                                \
  } while (0)

typedef unsigned char uchar;

namespace cv {

struct Size {
  int width = 0, height = 0;
  Size() = default;
  Size(int w, int h) : width(w), height(h) {}
  int area() const { return width * height; }
  bool operator==(const Size& o) const {
    return width == o.width && height == o.height;
  }
  bool operator!=(const Size& o) const { return !(*this == o); }
};

struct Scalar {
  double v[4] = {0, 0, 0, 0};
  Scalar() = default;
  Scalar(double v0) { v[0] = v0; }
};

class Mat {
 public:
  int rows = 0, cols = 0;
  uchar* data = nullptr;

  Mat() = default;
  Mat(int r, int c, int type) { create(r, c, type); }
  // Wrap an external buffer without copying (OpenCV semantics; the
  // caller keeps it alive — the reference leaks such buffers, which
  // keeps them valid for the program's lifetime).
  Mat(int r, int c, int type, void* external)
      : rows(r), cols(c), data((uchar*)external), type_(type) {}
  Mat(Size s, int type) { create(s.height, s.width, type); }
  Mat(Size s, int type, const Scalar& fill) {
    create(s.height, s.width, type);
    setTo(fill);
  }

  static int depthOf(int type) { return type & 7; }
  static int channelsOf(int type) { return (type >> 3) + 1; }
  static size_t elemSize1Of(int type) {
    return depthOf(type) == CV_32F ? 4 : 1;
  }

  void create(int r, int c, int type) {
    if (data && rows == r && cols == c && type_ == type) return;
    rows = r;
    cols = c;
    type_ = type;
    buf_ = std::make_shared<std::vector<uchar>>(
        (size_t)r * c * channelsOf(type) * elemSize1Of(type));
    data = buf_->data();
  }
  void create(Size s, int type) { create(s.height, s.width, type); }

  Size size() const { return Size(cols, rows); }
  int type() const { return type_; }
  int depth() const { return depthOf(type_); }
  int channels() const { return channelsOf(type_); }
  size_t elemSize1() const { return elemSize1Of(type_); }
  size_t step1() const { return (size_t)cols * channels(); }
  size_t total() const { return (size_t)rows * cols; }
  bool empty() const { return data == nullptr; }

  Mat clone() const {
    Mat m(rows, cols, type_);
    std::memcpy(m.data, data, bytes());
    return m;
  }

  void copyTo(Mat& dst) const {
    // OpenCV semantics: reuse dst's buffer when shape+type match
    // (critical: the callee writes through OutputArray-shared buffers),
    // reallocate otherwise.
    if (dst.rows != rows || dst.cols != cols || dst.type_ != type_)
      dst.create(rows, cols, type_);
    std::memmove(dst.data, data, bytes());
  }

  void copyTo(Mat&& dst) const {
    // rvalue target (e.g. `tmp.copyTo(out.getMat())`): the temporary
    // shares the caller's buffer, so writes land — but only if no
    // reallocation is needed. OpenCV would reallocate the underlying
    // array; the shim's callers always match (MeanFilter creates first).
    CV_Assert(dst.rows == rows && dst.cols == cols && dst.type() == type_);
    std::memmove(dst.data, data, bytes());
  }

  void setTo(const Scalar& s) {
    if (depth() == CV_8U) {
      std::memset(data, (int)s.v[0], bytes());
    } else {
      float v = (float)s.v[0];
      float* p = (float*)data;
      for (size_t i = 0; i < total() * channels(); ++i) p[i] = v;
    }
  }

  Mat& operator*=(int scale) {
    // OpenCV integer-Mat scaling saturates (convertTo semantics).
    CV_Assert(depth() == CV_8U);
    for (size_t i = 0; i < bytes(); ++i) {
      int v = (int)data[i] * scale;
      data[i] = (uchar)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
    return *this;
  }

  size_t bytes() const { return total() * channels() * elemSize1(); }

  template <typename T>
  T* ptr(int row) {
    return (T*)(data) + (size_t)row * step1();
  }
  template <typename T>
  const T* ptr(int row) const {
    return (const T*)(data) + (size_t)row * step1();
  }

 private:
  int type_ = 0;
  std::shared_ptr<std::vector<uchar>> buf_;
};

struct Point3i {
  int x = 0, y = 0, z = 0;
  Point3i() = default;
  Point3i(int x_, int y_, int z_) : x(x_), y(y_), z(z_) {}
};

// Typed element-access views (share the Mat's buffer).
template <typename T, int CN>
class Mat_ : public Mat {
 public:
  Mat_() = default;
  Mat_(const Mat& m) : Mat(m) {}
  Mat_& operator=(const Mat& m) {
    Mat::operator=(m);
    return *this;
  }
  // CN == 1: reference to the element; CN > 1: pointer to the pixel's
  // channels (supports the reference's `ptr(y, x)[c]` pattern, same
  // element layout as OpenCV's Vec<T, CN>&).
  template <int C = CN>
  typename std::enable_if<C == 1, T&>::type operator()(int y, int x) {
    return ((T*)data)[(size_t)y * cols + x];
  }
  template <int C = CN>
  typename std::enable_if<C == 1, const T&>::type operator()(int y,
                                                             int x) const {
    return ((T*)data)[(size_t)y * cols + x];
  }
  template <int C = CN>
  typename std::enable_if<C != 1, T*>::type operator()(int y, int x) {
    return (T*)data + ((size_t)y * cols + x) * CN;
  }
  template <int C = CN>
  typename std::enable_if<C != 1, const T*>::type operator()(int y,
                                                             int x) const {
    return (const T*)data + ((size_t)y * cols + x) * CN;
  }
};

typedef Mat_<uchar, 1> Mat1b;
typedef Mat_<float, 1> Mat1f;
typedef Mat_<uchar, 3> Mat3b;

class InputArray_ {
 public:
  InputArray_(const Mat& m) : m_(m) {}
  Mat getMat() const { return m_; }
  Size size() const { return m_.size(); }

 private:
  Mat m_;  // shares the caller's buffer
};
typedef const InputArray_& InputArray;

class OutputArray_ {
 public:
  OutputArray_(Mat& m) : m_(&m) {}
  void create(Size s, int type) const { m_->create(s, type); }
  Mat getMat() const { return *m_; }

 private:
  Mat* m_;
};
typedef const OutputArray_& OutputArray;

// ---- PGM/PPM I/O (the harness converts PNG <-> PPM losslessly) ----------

inline Mat imread(const std::string& path) {
  std::FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return Mat();
  char magic[3] = {0, 0, 0};
  if (std::fscanf(f, "%2s", magic) != 1) {
    std::fclose(f);
    return Mat();
  }
  int vals[3], got = 0;
  // header ints with '#' comment support
  while (got < 3) {
    int c = std::fgetc(f);
    if (c == '#') {
      while (c != '\n' && c != EOF) c = std::fgetc(f);
    } else if (c >= '0' && c <= '9') {
      std::ungetc(c, f);
      if (std::fscanf(f, "%d", &vals[got++]) != 1) break;
    } else if (c == EOF) {
      break;
    }
  }
  if (got < 3 || vals[2] != 255) {
    std::fclose(f);
    return Mat();
  }
  std::fgetc(f);  // single whitespace after maxval
  int w = vals[0], h = vals[1];
  Mat out;
  if (!std::strcmp(magic, "P5")) {
    // OpenCV imread() promotes grayscale to BGR by default — match it.
    std::vector<uchar> g((size_t)w * h);
    if (std::fread(g.data(), 1, g.size(), f) != g.size()) {
      std::fclose(f);
      return Mat();
    }
    out.create(h, w, CV_8UC3);
    for (size_t i = 0; i < g.size(); ++i)
      out.data[3 * i] = out.data[3 * i + 1] = out.data[3 * i + 2] = g[i];
  } else if (!std::strcmp(magic, "P6")) {
    out.create(h, w, CV_8UC3);
    if (std::fread(out.data, 1, out.bytes(), f) != out.bytes()) {
      std::fclose(f);
      return Mat();
    }
    for (size_t i = 0; i < out.total(); ++i)  // PPM is RGB; imread is BGR
      std::swap(out.data[3 * i], out.data[3 * i + 2]);
  }
  std::fclose(f);
  return out;
}

inline bool imwrite(const std::string& path, const Mat& m) {
  std::FILE* f = std::fopen(path.c_str(), "wb");
  if (!f || m.empty() || m.depth() != CV_8U) return false;
  if (m.channels() == 1) {
    std::fprintf(f, "P5\n%d %d\n255\n", m.cols, m.rows);
    std::fwrite(m.data, 1, m.bytes(), f);
  } else {
    std::fprintf(f, "P6\n%d %d\n255\n", m.cols, m.rows);
    std::vector<uchar> rgb(m.bytes());
    for (size_t i = 0; i < m.total(); ++i) {
      rgb[3 * i] = m.data[3 * i + 2];
      rgb[3 * i + 1] = m.data[3 * i + 1];
      rgb[3 * i + 2] = m.data[3 * i];
    }
    std::fwrite(rgb.data(), 1, rgb.size(), f);
  }
  std::fclose(f);
  return true;
}

}  // namespace cv

#endif  // GSM_REFSHIM_CORE_HPP
