// Native convertor: the datatype pack/unpack hot loop.
//
// ≈ opal/datatype's compiled-descriptor convertor (opal_convertor_pack/
// unpack, opal_convertor.h:136,142) — the reference runs this loop in C for
// every non-contiguous send/recv; the Python layer's numpy gather is fine
// for small payloads but pays per-element index overhead.
//
// ABI 2 (run-coalescing pack plans): the Python side compiles a datatype ×
// count into a *plan* — either one strided progression (vector-class
// layouts: zero per-run metadata here), a flat list of absolute coalesced
// (offset, length) runs, or the per-item segment walk of ABI 1 for plans
// too large to expand.  Every entry point takes a ``uniform`` hint: when
// all runs share one small length the inner memcpy is specialized to a
// fixed-width copy, which removes the per-call memcpy dispatch that
// dominated a 1M-run pack.
//
// Layout contracts:
//   *_runs:    absolute runs (off[j], len[j]) into the user buffer; the
//              packed stream is their concatenation in order.
//   *_strided: nblocks blocks of bl bytes, block i at start + i*stride.
//   pack/unpack (per-item): item i occupies [i*extent, ...); its payload
//              bytes are the runs (seg_off[j], seg_len[j]) relative to the
//              item origin, in declaration order (ABI-1 contract).

#include <cstdint>
#include <cstring>

namespace {

template <int L>
void pack_uniform(uint8_t *dst, const uint8_t *src, const int64_t *off,
                  int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(dst, src + off[i], L);  // fixed-width: compiles to movs
        dst += L;
    }
}

template <int L>
void unpack_uniform(const uint8_t *src, uint8_t *dst, const int64_t *off,
                    int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(dst + off[i], src, L);
        src += L;
    }
}

template <int L>
void pack_strided_fixed(uint8_t *dst, const uint8_t *src, int64_t n,
                        int64_t stride) {
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(dst, src, L);
        dst += L;
        src += stride;
    }
}

template <int L>
void unpack_strided_fixed(const uint8_t *src, uint8_t *dst, int64_t n,
                          int64_t stride) {
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(dst, src, L);
        src += L;
        dst += stride;
    }
}

}  // namespace

extern "C" {

// -- coalesced absolute-run plans -----------------------------------------

void ompi_tpu_pack_runs(uint8_t *dst, const uint8_t *src,
                        const int64_t *off, const int64_t *len,
                        int64_t n, int64_t uniform) {
    switch (uniform) {
    case 1:  pack_uniform<1>(dst, src, off, n);  return;
    case 2:  pack_uniform<2>(dst, src, off, n);  return;
    case 4:  pack_uniform<4>(dst, src, off, n);  return;
    case 8:  pack_uniform<8>(dst, src, off, n);  return;
    case 16: pack_uniform<16>(dst, src, off, n); return;
    case 32: pack_uniform<32>(dst, src, off, n); return;
    }
    for (int64_t j = 0; j < n; ++j) {
        std::memcpy(dst, src + off[j], static_cast<size_t>(len[j]));
        dst += len[j];
    }
}

void ompi_tpu_unpack_runs(const uint8_t *src, uint8_t *dst,
                          const int64_t *off, const int64_t *len,
                          int64_t n, int64_t uniform) {
    switch (uniform) {
    case 1:  unpack_uniform<1>(src, dst, off, n);  return;
    case 2:  unpack_uniform<2>(src, dst, off, n);  return;
    case 4:  unpack_uniform<4>(src, dst, off, n);  return;
    case 8:  unpack_uniform<8>(src, dst, off, n);  return;
    case 16: unpack_uniform<16>(src, dst, off, n); return;
    case 32: unpack_uniform<32>(src, dst, off, n); return;
    }
    for (int64_t j = 0; j < n; ++j) {
        std::memcpy(dst + off[j], src, static_cast<size_t>(len[j]));
        src += len[j];
    }
}

// -- strided progressions (vector-class plans: no per-run metadata) -------

void ompi_tpu_pack_strided(uint8_t *dst, const uint8_t *src,
                           int64_t nblocks, int64_t bl, int64_t stride) {
    switch (bl) {
    case 1:  pack_strided_fixed<1>(dst, src, nblocks, stride);  return;
    case 2:  pack_strided_fixed<2>(dst, src, nblocks, stride);  return;
    case 4:  pack_strided_fixed<4>(dst, src, nblocks, stride);  return;
    case 8:  pack_strided_fixed<8>(dst, src, nblocks, stride);  return;
    case 16: pack_strided_fixed<16>(dst, src, nblocks, stride); return;
    case 32: pack_strided_fixed<32>(dst, src, nblocks, stride); return;
    }
    for (int64_t i = 0; i < nblocks; ++i) {
        std::memcpy(dst, src, static_cast<size_t>(bl));
        dst += bl;
        src += stride;
    }
}

void ompi_tpu_unpack_strided(const uint8_t *src, uint8_t *dst,
                             int64_t nblocks, int64_t bl, int64_t stride) {
    switch (bl) {
    case 1:  unpack_strided_fixed<1>(src, dst, nblocks, stride);  return;
    case 2:  unpack_strided_fixed<2>(src, dst, nblocks, stride);  return;
    case 4:  unpack_strided_fixed<4>(src, dst, nblocks, stride);  return;
    case 8:  unpack_strided_fixed<8>(src, dst, nblocks, stride);  return;
    case 16: unpack_strided_fixed<16>(src, dst, nblocks, stride); return;
    case 32: unpack_strided_fixed<32>(src, dst, nblocks, stride); return;
    }
    for (int64_t i = 0; i < nblocks; ++i) {
        std::memcpy(dst, src, static_cast<size_t>(bl));
        src += bl;
        dst += stride;
    }
}

// -- per-item segment walk (plans too large to expand; ABI-1 semantics,
//    now with the uniform-length specialization in the inner loop) --------

void ompi_tpu_pack(uint8_t *dst, const uint8_t *src, int64_t count,
                   int64_t extent, const int64_t *seg_off,
                   const int64_t *seg_len, int64_t nsegs,
                   int64_t uniform, int64_t item_size) {
    for (int64_t i = 0; i < count; ++i) {
        ompi_tpu_pack_runs(dst, src + i * extent, seg_off, seg_len, nsegs,
                           uniform);
        dst += item_size;
    }
}

void ompi_tpu_unpack(const uint8_t *src, uint8_t *dst, int64_t count,
                     int64_t extent, const int64_t *seg_off,
                     const int64_t *seg_len, int64_t nsegs,
                     int64_t uniform, int64_t item_size) {
    for (int64_t i = 0; i < count; ++i) {
        ompi_tpu_unpack_runs(src, dst + i * extent, seg_off, seg_len, nsegs,
                             uniform);
        src += item_size;
    }
}

// version tag so the loader can detect stale cached builds
int64_t ompi_tpu_native_abi(void) { return 2; }

}  // extern "C"
