// Native memcomparable codec: the scan-path hot loops.
//
// The port's copy of the JAX package's native/codec.cc, with one kind
// added: byte strings (kind 4). It turns raw KV record pairs straight
// into the columnar buffers (int64/float64 + validity, and for strings
// an unstuffed byte arena with per-row end offsets) that the port's
// table.kvrows_to_chunk wraps as a chunk, replacing its per-datum Python
// loop. TPC-H lineitem carries two CHAR(1) columns, so without kind 4
// every lineitem scan took the Python loop.
//
// Exposed via a plain C ABI consumed with ctypes. All multi-byte
// integers in the encoding are big-endian.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t NIL_FLAG = 0x00;
constexpr uint8_t BYTES_FLAG = 0x01;
constexpr uint8_t INT_FLAG = 0x03;
constexpr uint8_t UINT_FLAG = 0x04;
constexpr uint8_t FLOAT_FLAG = 0x05;
constexpr uint8_t DECIMAL_FLAG = 0x06;
constexpr uint64_t SIGN_MASK = 0x8000000000000000ULL;

inline uint64_t load_be64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return v;
}

inline int64_t decode_int_payload(const uint8_t* p) {
  return (int64_t)(load_be64(p) ^ SIGN_MASK);
}

inline double decode_float_payload(const uint8_t* p) {
  uint64_t u = load_be64(p);
  if (u & SIGN_MASK) {
    u &= ~SIGN_MASK;
  } else {
    u = ~u;
  }
  double d;
  std::memcpy(&d, &u, sizeof(d));
  // stored big-endian bit pattern; memcpy gave us host order of the
  // already-reassembled integer, so this is correct on little-endian too
  return d;
}

// Skip (or measure) one group-stuffed byte string. Returns bytes consumed,
// or -1 on malformed input.
inline int64_t skip_bytes_datum(const uint8_t* p, int64_t avail) {
  int64_t off = 0;
  while (true) {
    if (off + 9 > avail) return -1;
    uint8_t marker = p[off + 8];
    off += 9;
    int pad = 0xFF - marker;
    if (pad == 0) continue;
    if (pad > 8) return -1;
    return off;
  }
}

// Skip one datum (flag + payload). Returns bytes consumed or -1.
inline int64_t skip_datum(const uint8_t* p, int64_t avail) {
  if (avail < 1) return -1;
  switch (p[0]) {
    case NIL_FLAG:
      return 1;
    case INT_FLAG:
    case UINT_FLAG:
    case FLOAT_FLAG:
      return avail >= 9 ? 9 : -1;
    case DECIMAL_FLAG: {
      return avail >= 10 ? 10 : -1;
    }
    case BYTES_FLAG: {
      int64_t n = skip_bytes_datum(p + 1, avail - 1);
      return n < 0 ? -1 : n + 1;
    }
    default:
      return -1;
  }
}

inline int64_t pow10_i64(int n) {
  int64_t v = 1;
  while (n-- > 0) v *= 10;
  return v;
}

}  // namespace

extern "C" {

// Column kinds for decode_rows.
// 0 = int64 (INT/DATETIME eval; also accepts UINT within int64 range)
// 1 = float64
// 2 = decimal (scaled int64; rescaled to col_frac when the stored frac
//     differs)
// 3 = handle (value comes from the record key, not the row)
// 4 = bytes: the group-stuffed payload unstuffs into out_arena[c] and
//     out_data[c][r] is the arena's END offset after row r (a NULL or
//     absent value adds nothing); def_valid must be 0 for this kind

// Decode n encoded rows into columnar buffers.
//   values / val_offsets[n+1]: concatenated row values
//   keys / key_offsets[n+1]:   concatenated record keys (for handles)
//   ncols, col_ids[ncols], col_kind[ncols], col_frac[ncols]
//   def_valid[ncols], def_int[ncols], def_float[ncols]: per-column default
//     (applied when the row lacks the column id; def_valid 0 => NULL)
//   out_data[ncols]: int64*/double* per column; out_valid[ncols]: uint8*
//   out_arena[ncols]: uint8* per bytes column (at least as large as the
//     concatenated values), unused for the other kinds
// Returns 0 on success, -1 on malformed/unsupported input (caller falls
// back to the Python decoder).
int decode_rows(const uint8_t* values, const int64_t* val_offsets,
                const uint8_t* keys, const int64_t* key_offsets,
                int64_t n, int32_t ncols, const int64_t* col_ids,
                const uint8_t* col_kind, const int32_t* col_frac,
                const uint8_t* def_valid, const int64_t* def_int,
                const double* def_float, int64_t** out_data,
                uint8_t** out_valid, uint8_t** out_arena) {
  // arena fill of each bytes column (columns are few: a fixed array)
  int64_t arena_pos[64] = {0};
  if (ncols > 64) return -1;
  for (int64_t r = 0; r < n; r++) {
    // handle: key = 't' + 9B(int flagged? no: raw encode_int 8B) + '_r' + 8B
    // record_key layout: 't' (1) + 8B sign-flipped table id + '_r' (2) +
    // 8B sign-flipped handle
    const uint8_t* k = keys + key_offsets[r];
    int64_t klen = key_offsets[r + 1] - key_offsets[r];
    if (klen < 1 + 8 + 2 + 8) return -1;
    int64_t handle = decode_int_payload(k + 1 + 8 + 2);

    // fill defaults first; found columns overwrite
    for (int32_t c = 0; c < ncols; c++) {
      if (col_kind[c] == 3) {
        out_data[c][r] = handle;
        out_valid[c][r] = 1;
      } else if (col_kind[c] == 4) {
        if (def_valid[c]) return -1;  // string default: python path
        out_valid[c][r] = 0;
      } else if (def_valid[c]) {
        out_valid[c][r] = 1;
        if (col_kind[c] == 1) {
          ((double*)out_data[c])[r] = def_float[c];
        } else {
          out_data[c][r] = def_int[c];
        }
      } else {
        out_valid[c][r] = 0;
        if (col_kind[c] == 1) {
          ((double*)out_data[c])[r] = 0.0;
        } else {
          out_data[c][r] = 0;
        }
      }
    }

    const uint8_t* v = values + val_offsets[r];
    int64_t avail = val_offsets[r + 1] - val_offsets[r];
    int64_t off = 0;
    while (off < avail) {
      // column id datum (always INT-flagged)
      if (v[off] != INT_FLAG || off + 9 > avail) return -1;
      int64_t cid = decode_int_payload(v + off + 1);
      off += 9;
      // find the output slot (ncols is small: linear scan)
      int32_t slot = -1;
      for (int32_t c = 0; c < ncols; c++) {
        if (col_kind[c] != 3 && col_ids[c] == cid) { slot = c; break; }
      }
      if (slot < 0) {
        int64_t used = skip_datum(v + off, avail - off);
        if (used < 0) return -1;
        off += used;
        continue;
      }
      if (off >= avail) return -1;
      uint8_t flag = v[off];
      if (col_kind[slot] == 4) {
        if (flag == NIL_FLAG) {
          out_valid[slot][r] = 0;
          off += 1;
          continue;
        }
        if (flag != BYTES_FLAG) return -1;  // python handles the casts
        off += 1;
        uint8_t* dst = out_arena[slot] + arena_pos[slot];
        while (true) {
          if (off + 9 > avail) return -1;
          int pad = 0xFF - v[off + 8];
          if (pad > 8) return -1;
          int take = 8 - pad;
          std::memcpy(dst, v + off, take);
          dst += take;
          arena_pos[slot] += take;
          off += 9;
          if (pad != 0) break;
        }
        out_valid[slot][r] = 1;
        continue;
      }
      switch (flag) {
        case NIL_FLAG:
          out_valid[slot][r] = 0;
          if (col_kind[slot] == 1) ((double*)out_data[slot])[r] = 0.0;
          else out_data[slot][r] = 0;
          off += 1;
          break;
        case INT_FLAG: {
          if (off + 9 > avail) return -1;
          int64_t x = decode_int_payload(v + off + 1);
          out_valid[slot][r] = 1;
          if (col_kind[slot] == 1) ((double*)out_data[slot])[r] = (double)x;
          else out_data[slot][r] = x;
          off += 9;
          break;
        }
        case UINT_FLAG: {
          if (off + 9 > avail) return -1;
          uint64_t x = load_be64(v + off + 1);
          out_valid[slot][r] = 1;
          if (col_kind[slot] == 1) {
            ((double*)out_data[slot])[r] = (double)x;
          } else {
            if (x > (uint64_t)INT64_MAX) return -1;  // python fallback
            out_data[slot][r] = (int64_t)x;
          }
          off += 9;
          break;
        }
        case FLOAT_FLAG: {
          if (off + 9 > avail) return -1;
          double x = decode_float_payload(v + off + 1);
          out_valid[slot][r] = 1;
          if (col_kind[slot] == 1) ((double*)out_data[slot])[r] = x;
          else return -1;  // float into int column: python handles casts
          off += 9;
          break;
        }
        case DECIMAL_FLAG: {
          if (off + 10 > avail) return -1;
          int frac = v[off + 1];
          int64_t scaled = decode_int_payload(v + off + 2);
          out_valid[slot][r] = 1;
          if (col_kind[slot] == 2) {
            int want = col_frac[slot];
            // >18-digit shifts overflow int64: python path handles those
            if (frac < want) {
              if (want - frac > 18) return -1;
              int64_t mul = pow10_i64(want - frac);
              if (scaled > INT64_MAX / mul || scaled < INT64_MIN / mul)
                return -1;
              scaled *= mul;
            } else if (frac > want) {
              if (frac - want > 18) return -1;
              // MySQL half-away-from-zero, matching _rescale_decimal
              int64_t div = pow10_i64(frac - want);
              int64_t q = scaled / div;
              int64_t rem = scaled % div;
              if (rem < 0) rem = -rem;
              if (2 * rem >= div) q += (scaled >= 0) ? 1 : -1;
              scaled = q;
            }
            out_data[slot][r] = scaled;
          } else if (col_kind[slot] == 1) {
            if (frac > 18) return -1;
            ((double*)out_data[slot])[r] =
                (double)scaled / (double)pow10_i64(frac);
          } else {
            return -1;
          }
          off += 10;
          break;
        }
        case BYTES_FLAG:
          return -1;  // varlen into fixed-width request: python fallback
        default:
          return -1;
      }
    }
    for (int32_t c = 0; c < ncols; c++) {
      if (col_kind[c] == 4) out_data[c][r] = arena_pos[c];
    }
  }
  return 0;
}

// Batch sign-flipped big-endian int64 encode (index/key building).
void encode_int_batch(const int64_t* vals, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t u = (uint64_t)vals[i] ^ SIGN_MASK;
    uint8_t* p = out + i * 8;
    for (int b = 7; b >= 0; b--) { p[b] = (uint8_t)u; u >>= 8; }
  }
}

// Batch decode of sign-flipped big-endian int64 (index value -> handle).
void decode_int_batch(const uint8_t* data, int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = decode_int_payload(data + i * 8);
}

}  // extern "C"
