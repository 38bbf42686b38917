// Host-side frame reconstruction: entropy-decoded fields -> range image
// (and optionally the compacted (n, 4) xyz0 rows ready for .bin output).
//
// Mirrors the device decoder graph (models/decoder.py) and the reference
// decode chain (tools/decompress.py:87-112): run-length seg recovery
// (cpp_modules.cpp:561-593 walks the flattened map the same way),
// cluster-id-major residual ordering (cpp_modules.cpp:311-319, id 1
// skipped), intra-prediction (cpp_modules.cpp:264-281), ri = pred + q*step.
//
// Why a host decoder at all: the device path uploads ~150 KB/frame of
// entropy-decoded arrays and downloads a ~256 KB/frame range image, while
// the whole reconstruction is one pass of branch-free float math on the
// host.  f32 arithmetic with -ffp-contract=off matches the
// numpy fallback bit-for-bit; plane predictions agree with the device
// graph to float rounding (the residual bound is unaffected).

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

extern "C" {

int64_t host_decode_frame(
    const uint8_t* contour_packed,  // (HW/8,) MSB-first bit plane
    const uint16_t* seq, int64_t n_seq,
    const int16_t* stream, int64_t n_stream,
    const float* models, int32_t M,  // (M, 4) a,b,c,d rows
    const uint8_t* salience,         // (M,) or null (uniform mode)
    const float* level_acc, int32_t n_levels,  // per-level steps, or null
    float step,                      // uniform quantization step
    const float* tm,                 // (3, HW) planar unit rays
    int32_t H, int32_t W,
    float* ri_out,                   // (HW,)
    float* xyz_out) {                // (HW, 4) or null; returns rows written
  const int64_t hw = (int64_t)H * W;
  // 1. Segmentation map: run-length fill over the flattened image.
  std::vector<int32_t> seg((size_t)hw);
  {
    int64_t s = 0;
    int32_t cur = 0;
    for (int64_t p = 0; p < hw; ++p) {
      if (contour_packed[p >> 3] & (uint8_t)(0x80u >> (p & 7))) {
        if (s < n_seq) cur = (int32_t)seq[s++];
      }
      seg[(size_t)p] = cur;
    }
  }
  // 2. Stream offsets per cluster id: visit order 0, 2, 3, ..., M-1
  //    (id 1 = zero pixels carries no residuals).
  std::vector<int64_t> cnt((size_t)M, 0);
  for (int64_t p = 0; p < hw; ++p) {
    int32_t id = seg[(size_t)p];
    if (id >= 0 && id < M) ++cnt[(size_t)id];
  }
  std::vector<int64_t> pos((size_t)M, 0);
  int64_t off = cnt.empty() ? 0 : cnt[0];
  for (int32_t c = 2; c < M; ++c) {
    pos[(size_t)c] = off;
    off += cnt[(size_t)c];
  }
  // 3. Reconstruct: dequantize + intra-predict in one row-major pass.
  const float* tx = tm;
  const float* ty = tm + hw;
  const float* tz = tm + 2 * hw;
  for (int64_t p = 0; p < hw; ++p) {
    int32_t id = seg[(size_t)p];
    float r = 0.0f;
    if (id != 1 && id >= 0 && id < M) {
      int64_t k = pos[(size_t)id]++;
      float q = (k < n_stream) ? (float)stream[k] : 0.0f;
      float a = models[4 * id], b = models[4 * id + 1];
      float c = models[4 * id + 2], d = models[4 * id + 3];
      float pred;
      if (a + b + c == 0.0f) {  // exact-zero point-model test (cpp:271)
        pred = d;
      } else {
        float denom = a * tx[p] + b * ty[p] + c * tz[p];
        // Degenerate through-origin ray: predict 0, like both codec sides
        // (ops/stream.py::predict_stream).
        pred = (denom == 0.0f) ? 0.0f : -d / denom;
      }
      float st = step;
      if (salience != nullptr && level_acc != nullptr && n_levels > 0) {
        int32_t lv = (int32_t)salience[id];
        // Out-of-range levels clamp to the last level — same rule as the
        // device decoder's clamped gather (models/decoder.py step[salience])
        // and the numpy twin, so corrupt salience decodes identically on
        // every backend.
        if (lv >= n_levels) lv = n_levels - 1;
        st = level_acc[lv];
      }
      r = pred + q * st;
    }
    ri_out[p] = r;
  }
  // 4. Optional compacted (n, 4) xyz0 rows; the drop rule is sum(xyz) != 0,
  //    matching the reference save path (dataset/dataset.py:74-75).
  int64_t n = 0;
  if (xyz_out != nullptr) {
    for (int64_t p = 0; p < hw; ++p) {
      float r = ri_out[p];
      float x = r * tx[p], y = r * ty[p], z = r * tz[p];
      if (x + y + z != 0.0f) {
        xyz_out[4 * n] = x;
        xyz_out[4 * n + 1] = y;
        xyz_out[4 * n + 2] = z;
        xyz_out[4 * n + 3] = 0.0f;
        ++n;
      }
    }
  }
  return n;
}

// Invert the i8 row-delta decode downlink (models/decoder.py d8_down):
// q[p] = running sum of d8 with (pos-delta, value) exceptions resetting the
// accumulator; out[p] = (float)q * delta.  Bit-identical to the u16
// downlink's astype(f32) * delta (q <= 65535 exact in f32, one multiply).
// Frames with n_exc > cap are reconstructed from the truncated list and
// must be overwritten by the caller's u16 fallback.
void d8_reconstruct_batch(
    const int8_t* d8,      // (B, hw)
    const uint16_t* pd,    // (B, cap) exception position deltas
    const uint16_t* val,   // (B, cap) exception grid values
    const int32_t* n_exc,  // (B,)
    const float* delta,    // (B,)
    int64_t B, int64_t hw, int64_t cap,
    float* out) {          // (B, hw)
  for (int64_t i = 0; i < B; ++i) {
    const int8_t* d = d8 + i * hw;
    const uint16_t* epd = pd + i * cap;
    const uint16_t* ev = val + i * cap;
    const float dl = delta[i];
    float* o = out + i * hw;
    int64_t n = (int64_t)n_exc[i];
    if (n > cap) n = cap;
    int64_t p = 0, pos = -1;
    int32_t q = 0;
    for (int64_t e = 0; e < n; ++e) {
      const int64_t next = pos + (int64_t)epd[e];
      // Malformed exception list: positions must be strictly increasing
      // (epd >= 1) and inside the grid.  A zero pos-delta would make
      // `next < p` after the previous exception's p++ and the unguarded
      // o[p++] below would walk past the output buffer one float per
      // entry (heap OOB write, wire-reachable).
      if (epd[e] == 0 || next >= hw) break;
      for (; p < next; ++p) {
        q += (int32_t)d[p];
        o[p] = (float)q * dl;
      }
      q = (int32_t)ev[e];
      o[p++] = (float)q * dl;
      pos = next;
    }
    for (; p < hw; ++p) {
      q += (int32_t)d[p];
      o[p] = (float)q * dl;
    }
  }
}

void m8_reconstruct_batch(
    const uint8_t* maskp,  // (B, hw/8) MSB-first nonzero-occupancy bits
    const int8_t* d8c,     // (B, nz_cap) compact i8 deltas
    const uint16_t* pd,    // (B, exc_cap) exception pos-deltas (compact dom)
    const uint16_t* val,   // (B, exc_cap) exception grid values
    const int32_t* n_nz,   // (B,) live nonzero counts
    const int32_t* n_exc,  // (B,)
    const float* delta,    // (B,)
    int64_t B, int64_t hw, int64_t nz_cap, int64_t exc_cap,
    float* out) {          // (B, hw)
  // Inverts the device decoder's m8 downlink (models/decoder.py m8_down
  // branch — itself the encode uplink's wire code,
  // ops/projection.py::project_points_host_m8): reconstruct the compact
  // nonzero stream with the same exception walk as d8_reconstruct_batch,
  // then expand through the occupancy bit plane.  Frames with
  // n_nz > nz_cap or n_exc > exc_cap are truncated here and must be
  // overwritten by the caller's u16 fallback.
  const int64_t mb = hw / 8;
  std::vector<float> nzv;
  for (int64_t i = 0; i < B; ++i) {
    const int8_t* d = d8c + i * nz_cap;
    const uint16_t* epd = pd + i * exc_cap;
    const uint16_t* ev = val + i * exc_cap;
    const uint8_t* m = maskp + i * mb;
    const float dl = delta[i];
    float* o = out + i * hw;
    int64_t n = (int64_t)n_nz[i];
    if (n > nz_cap) n = nz_cap;
    int64_t ne = (int64_t)n_exc[i];
    if (ne > exc_cap) ne = exc_cap;
    nzv.resize((size_t)(n > 0 ? n : 0));
    int64_t p = 0, pos = -1;
    int32_t q = 0;
    for (int64_t e = 0; e < ne; ++e) {
      const int64_t next = pos + (int64_t)epd[e];
      // epd == 0 would make next < p (or next == -1 on an empty stream)
      // and the unguarded nzv[p++] below would overflow the n-element
      // vector one float per entry — same guard as d8_reconstruct_batch.
      if (epd[e] == 0 || next >= n) break;
      for (; p < next; ++p) {
        q += (int32_t)d[p];
        nzv[(size_t)p] = (float)q * dl;
      }
      q = (int32_t)ev[e];
      nzv[(size_t)p++] = (float)q * dl;
      pos = next;
    }
    for (; p < n; ++p) {
      q += (int32_t)d[p];
      nzv[(size_t)p] = (float)q * dl;
    }
    // Expand through the occupancy plane (MSB-first bits).
    int64_t r = 0;
    for (int64_t byte = 0; byte < mb; ++byte) {
      const uint8_t bits = m[byte];
      float* ob = o + byte * 8;
      if (bits == 0) {
        for (int k = 0; k < 8; ++k) ob[k] = 0.0f;
        continue;
      }
      for (int k = 0; k < 8; ++k) {
        if (bits & (uint8_t)(0x80u >> k)) {
          ob[k] = r < n ? nzv[(size_t)r] : 0.0f;
          ++r;
        } else {
          ob[k] = 0.0f;
        }
      }
    }
  }
}

// Back-project a reconstructed range image to compacted (n, 4) xyz0 rows —
// the device-decode save tail (parallel/engine.py::_points4_from_ris).
// Same math and drop rule as host_decode_frame step 4 (and the numpy twin:
// sum(xyz) != 0, reference dataset.py:74-75), so the device and host
// datalist decode backends share save semantics (byte-identical files in
// f32-transfer mode; reduced modes re-snap ranges to the u16 grid first).  The numpy
// broadcast this replaces ((H, W, 1) * (H, W, 3) + mask + concat) walked
// ~6 MB of temporaries per frame; this single pass reads ri + planar rays
// and writes only live rows.
int64_t backproject_compact(
    const float* ri,   // (hw,) reconstructed ranges
    const float* tm,   // (3, hw) planar unit rays
    int64_t hw,
    float* xyz_out) {  // (hw, 4) capacity; returns rows written
  const float* tx = tm;
  const float* ty = tm + hw;
  const float* tz = tm + 2 * hw;
  int64_t n = 0;
  for (int64_t p = 0; p < hw; ++p) {
    float r = ri[p];
    float x = r * tx[p], y = r * ty[p], z = r * tz[p];
    if (x + y + z != 0.0f) {
      xyz_out[4 * n] = x;
      xyz_out[4 * n + 1] = y;
      xyz_out[4 * n + 2] = z;
      xyz_out[4 * n + 3] = 0.0f;
      ++n;
    }
  }
  return n;
}

}  // extern "C"
