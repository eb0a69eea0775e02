/* COCO run-length encoder, the host path of the label generator (the port's
 * copy of samrs_tpu/native/rle_ext.c).
 *
 * The reference encodes each instance mask with pycocotools' C mask module
 * (GD/main_sam_hbox_semantic.py:201); at dataset scale (105k images x ~30
 * masks x ~1 MPix) a Python varint loop would set the host's time, so this
 * mirrors samrs_tpu_torch/data/rle.py's numpy codec byte for byte in C.
 * Called through ctypes, which releases the GIL for the call, so a thread
 * pool encodes on several cores at once.
 *
 * Format: column-major runs starting with a zero run; counts delta-coded
 * (from the fourth on, less the count two before) and written as 5-bit
 * little-endian groups, 0x20 on every group but the last, plus 48.
 */

#include <stddef.h>
#include <stdint.h>

/* Encode one H x W row-major uint8 binary mask (any nonzero byte is 1).
 * Returns the bytes written, or -1 if they would pass out_cap. */
long rle_encode_mask(const uint8_t *mask, long h, long w, uint8_t *out, long out_cap) {
    long out_len = 0;
    long prev2 = 0, prev1 = 0; /* the raw counts one and two before */
    long count_idx = 0;
    uint8_t cur = 0; /* runs start with value 0 */
    long run = 0;

    /* emit one raw count, delta-coded and as varint characters */
    #define EMIT(xraw)                                                        \
        do {                                                                  \
            long x = (xraw);                                                  \
            if (count_idx > 2) x -= prev2;                                    \
            prev2 = prev1;                                                    \
            prev1 = (xraw);                                                   \
            count_idx++;                                                      \
            int more = 1;                                                     \
            while (more) {                                                    \
                long c = x & 0x1f;                                            \
                x >>= 5;                                                      \
                more = (c & 0x10) ? (x != -1) : (x != 0);                     \
                if (more) c |= 0x20;                                          \
                if (out_len >= out_cap) return -1;                            \
                out[out_len++] = (uint8_t)(c + 48);                           \
            }                                                                 \
        } while (0)

    for (long col = 0; col < w; col++) {
        const uint8_t *colp = mask + col;
        for (long row = 0; row < h; row++) {
            uint8_t v = colp[(size_t)row * w] ? 1 : 0;
            if (v == cur) {
                run++;
            } else {
                EMIT(run);
                cur = v;
                run = 1;
            }
        }
    }
    EMIT(run);
    return out_len;
    #undef EMIT
}

/* Batch: masks (N, H, W) contiguous, encoded one after the other into out;
 * offsets[i] receives the byte offset of mask i's encoding, lengths[i] its
 * length.  Returns the total bytes, or -1 if they would pass out_cap. */
long rle_encode_batch(const uint8_t *masks, long n_masks, long h, long w,
                      uint8_t *out, long out_cap, long *offsets, long *lengths) {
    long total = 0;
    for (long i = 0; i < n_masks; i++) {
        long len = rle_encode_mask(masks + (size_t)i * h * w, h, w,
                                   out + total, out_cap - total);
        if (len < 0) return -1;
        offsets[i] = total;
        lengths[i] = len;
        total += len;
    }
    return total;
}
