// LOAD DATA line/field scanner — the native data-loader hot loop.
//
// Reference: the reference's LOAD DATA splitting lives in compiled Go
// (executor/load_data.go READ_INFO-style scanning); this is the C++
// equivalent for executor/loaddata.py's Python scanner. The
// contract is deliberately strict: the scanner handles REGULAR rows
// (single-byte terminators, enclosure only covering the whole field,
// escapes marked for host-side unescaping) and row-alignedly bails the
// moment anything irregular appears — the Python scanner, which matches
// MySQL semantics bit-for-bit, takes over from the reported offset.
//
// Output per field: [start,end) byte span (quotes excluded), flags:
//   1 = contains escape sequences (host runs unescape)
//   2 = contains doubled enclosure quotes (host collapses them)
//   4 = field is the \N NULL marker
//   8 = field was enclosed (an empty enclosed field is NOT an empty line)
// Row r's fields are fields[rowoff[r] : rowoff[r+1]].

#include <cstdint>

extern "C" {

// returns bytes consumed (always row-aligned; == n when fully done;
// < n when an irregular construct or output capacity stopped the scan —
// the caller finishes the remainder with the general scanner)
int64_t scan_rows(const uint8_t* t, int64_t n,
                  uint8_t ft, uint8_t lt, int32_t enc_i, int32_t esc_i,
                  int64_t ignore_lines, int32_t final_chunk,
                  int64_t* fstart, int64_t* fend, uint8_t* fflags,
                  int64_t* rowoff, int64_t max_fields, int64_t max_rows,
                  int64_t* out_nrows, int64_t* out_nfields) {
    const bool has_enc = enc_i >= 0, has_esc = esc_i >= 0;
    const uint8_t enc = (uint8_t)enc_i, esc = (uint8_t)esc_i;

    int64_t i = 0;
    // IGNORE n LINES skips PHYSICAL lines (raw terminator scan)
    for (int64_t skipped = 0; skipped < ignore_lines; skipped++) {
        while (i < n && t[i] != lt) i++;
        if (i < n) i++; else break;
    }

    int64_t nf = 0, nr = 0;
    int64_t row_begin = i;        // bail point: start of current row
    bool dangling = false;        // text ended right after a field sep
    rowoff[0] = 0;

    // every exit reports the COMPLETE rows scanned so far; fields of a
    // partial row are dropped (the caller rescans from the bail offset)
#define BAIL(ret) do { *out_nrows = nr; *out_nfields = rowoff[nr]; \
                       return (ret); } while (0)

    while (i < n) {
        // ---- one field ----
        uint8_t flags = 0;
        int64_t s, e;
        if (has_enc && t[i] == enc) {
            // enclosed field: content is everything to the closing
            // quote; doubled quotes stay (host collapses), escapes stay
            flags |= 8;
            s = ++i;
            for (;;) {
                if (i >= n) BAIL(row_begin);         // unterminated: bail
                uint8_t c = t[i];
                if (has_esc && c == esc) {
                    if (i + 1 >= n) BAIL(row_begin);
                    flags |= 1; i += 2; continue;
                }
                if (c == enc) {
                    if (i + 1 < n && t[i + 1] == enc) {
                        flags |= 2; i += 2; continue;
                    }
                    break;                            // closing quote
                }
                i++;
            }
            e = i++;                                  // skip the quote
            // only a terminator may follow a closing quote; anything
            // else is the mixed quoted+bare form -> Python handles it
            if (i < n && t[i] != ft && t[i] != lt) BAIL(row_begin);
        } else {
            s = i;
            for (;;) {
                if (i >= n) break;
                uint8_t c = t[i];
                if (has_esc && c == esc) {
                    if (i + 1 >= n) { i++; break; }   // lone esc: literal
                    flags |= 1; i += 2; continue;
                }
                if (c == ft || c == lt) break;
                if (has_enc && c == enc) BAIL(row_begin);   // stray quote
                i++;
            }
            e = i;
            // exactly \N (and nothing else) is SQL NULL
            if (has_esc && e - s == 2 && t[s] == esc && t[s + 1] == 'N')
                flags = 4;
        }
        if (nf >= max_fields) BAIL(row_begin);
        fstart[nf] = s; fend[nf] = e; fflags[nf] = flags; nf++;

        // ---- separator after the field ----
        if (i >= n) {
            // buffer ended mid-row: only a FINAL buffer may treat EOF
            // as the row terminator; otherwise the partial row carries
            // into the next chunk
            if (!final_chunk) BAIL(row_begin);
            if (nr >= max_rows) BAIL(row_begin);
            rowoff[++nr] = nf;
            row_begin = i;
        } else if (t[i] == lt) {
            i++;
            if (nr >= max_rows) BAIL(row_begin);
            rowoff[++nr] = nf;
            row_begin = i;
        } else {                                      // t[i] == ft
            i++;
            dangling = (i >= n);  // trailing sep: one empty field owed
        }
    }
    if (!final_chunk) {
        // mid-stream: an unterminated tail row stays UNCONSUMED — the
        // caller carries it into the next chunk (emitting it here would
        // split the row straddling the chunk boundary)
        BAIL(row_begin);
    }
    if (dangling) {
        if (nf >= max_fields) BAIL(row_begin);
        fstart[nf] = n; fend[nf] = n; fflags[nf] = 0; nf++;
    }
    if (nf > rowoff[nr]) {                            // unterminated tail
        if (nr >= max_rows) BAIL(row_begin);
        rowoff[++nr] = nf;
        row_begin = n;
    }
    *out_nrows = nr;
    *out_nfields = nf;
#undef BAIL
    return n;
}

}  // extern "C"
