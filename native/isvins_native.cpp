// Native host runtime: EuRoC CSV ingestion + IMU/image measurement alignment.
//
// The reference implements its driver and queue layer in C++
// (test/run_euroc.cpp:26-88 CSV readers; src/System.cpp:160-202
// getMeasurements + :279-296 mid-frame interpolation). This module is the
// engine's native equivalent: the Python pipeline calls it through
// ctypes (isvins_tpu/native.py), with a pure-Python fallback when the
// shared library has not been built.
//
// Build: make -C native   (produces libisvins_native.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ----------------------------------------------------------- CSV ingestion
// Parses "ts_ns,a,b,c,..." lines with `cols` numeric columns after the
// timestamp. Returns number of rows parsed; fills ts_s (seconds) and data
// (row-major n x cols). Caller allocates with capacity `max_rows`.
long parse_csv_ns(const char* path, int cols, long max_rows, double* ts_s,
                  double* data) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char line[1024];
  long n = 0;
  while (n < max_rows && fgets(line, sizeof(line), f)) {
    if (line[0] == '#' || line[0] == '\n' || line[0] == '\r') continue;
    char* p = line;
    char* end = nullptr;
    double ts = strtod(p, &end);
    if (end == p) continue;
    p = end;
    ts_s[n] = ts / 1e9;
    bool ok = true;
    for (int c = 0; c < cols; ++c) {
      while (*p == ',' || *p == ' ') ++p;
      double v = strtod(p, &end);
      if (end == p) { ok = false; break; }
      data[n * cols + c] = v;
      p = end;
    }
    if (ok) ++n;
  }
  fclose(f);
  return n;
}

// ------------------------------------------------- measurement alignment
// Ring-buffered IMU queue + feature-time alignment with the reference's
// boundary interpolation semantics (System.cpp:279-296): all samples with
// t < t_img are emitted with their own dt, then one synthetic sample
// linearly interpolated at exactly t_img.
struct Aligner {
  std::vector<double> t, ax, ay, az, gx, gy, gz;
  size_t head = 0;          // first unconsumed sample
  double current_time = -1; // time up to which samples were consumed
  double last_ax = 0, last_ay = 0, last_az = 0;
  double last_gx = 0, last_gy = 0, last_gz = 0;
  bool has_last = false;
};

void* aligner_create() { return new Aligner(); }
void aligner_destroy(void* a) { delete static_cast<Aligner*>(a); }

void aligner_push_imu(void* av, double t, const double* acc, const double* gyr) {
  Aligner* a = static_cast<Aligner*>(av);
  a->t.push_back(t);
  a->ax.push_back(acc[0]); a->ay.push_back(acc[1]); a->az.push_back(acc[2]);
  a->gx.push_back(gyr[0]); a->gy.push_back(gyr[1]); a->gz.push_back(gyr[2]);
}

int aligner_ready(void* av, double t_img) {
  Aligner* a = static_cast<Aligner*>(av);
  return (!a->t.empty() && a->t.back() > t_img) ? 1 : 0;
}

// Emits aligned samples for one image time: rows of [dt, ax,ay,az, gx,gy,gz].
// Returns the number of rows written (<= max_rows), or -1 if not ready.
long aligner_collect(void* av, double t_img, long max_rows, double* out) {
  Aligner* a = static_cast<Aligner*>(av);
  if (!aligner_ready(av, t_img)) return -1;
  if (a->current_time < 0) a->current_time = t_img;
  long n = 0;
  while (a->head < a->t.size() && a->t[a->head] < t_img && n < max_rows) {
    size_t i = a->head;
    double dt = a->t[i] - a->current_time;
    if (dt > 0) {
      double* row = out + n * 7;
      row[0] = dt;
      row[1] = a->ax[i]; row[2] = a->ay[i]; row[3] = a->az[i];
      row[4] = a->gx[i]; row[5] = a->gy[i]; row[6] = a->gz[i];
      ++n;
    }
    a->current_time = a->t[i];
    a->last_ax = a->ax[i]; a->last_ay = a->ay[i]; a->last_az = a->az[i];
    a->last_gx = a->gx[i]; a->last_gy = a->gy[i]; a->last_gz = a->gz[i];
    a->has_last = true;
    ++a->head;
  }
  // boundary interpolation at exactly t_img
  if (a->head < a->t.size() && a->has_last && n < max_rows) {
    double t2 = a->t[a->head];
    double dt1 = t_img - a->current_time;
    double dt2 = t2 - t_img;
    if (dt1 > 0 && dt2 >= 0) {
      double w1 = dt2 / (dt1 + dt2);
      double w2 = dt1 / (dt1 + dt2);
      double* row = out + n * 7;
      row[0] = dt1;
      row[1] = w1 * a->last_ax + w2 * a->ax[a->head];
      row[2] = w1 * a->last_ay + w2 * a->ay[a->head];
      row[3] = w1 * a->last_az + w2 * a->az[a->head];
      row[4] = w1 * a->last_gx + w2 * a->gx[a->head];
      row[5] = w1 * a->last_gy + w2 * a->gy[a->head];
      row[6] = w1 * a->last_gz + w2 * a->gz[a->head];
      ++n;
      a->current_time = t_img;
    }
  }
  // periodically compact the consumed prefix
  if (a->head > 4096) {
    auto drop = [&](std::vector<double>& v) { v.erase(v.begin(), v.begin() + a->head); };
    drop(a->t); drop(a->ax); drop(a->ay); drop(a->az);
    drop(a->gx); drop(a->gy); drop(a->gz);
    a->head = 0;
  }
  return n;
}

}  // extern "C"
