// Native framing codec for the cross-silo transport
// (fl4health_tpu_torch.transport; a copy of fl4health_tpu/transport/_codec.cpp,
// so the two packages write the same bytes).
//
// Role: the hot host-side byte work of the wire path — CRC-32 integrity
// checksums and frame assembly/validation — in C++. Host code, not a device
// kernel: the array math stays on the card; this is the runtime seam around it.
//
// Frame layout (little-endian):
//   magic   u32  = 0x464C3448  ("FL4H")
//   version u16  = 1
//   flags   u16  (bit 0: payload is COO-sparse)
//   header_len u32
//   payload_len u64
//   header  [header_len]   (JSON metadata, produced by Python)
//   payload [payload_len]  (raw array bytes)
//   crc     u32  (CRC-32 over everything above)
//
// Exposed C ABI (ctypes):
//   u32  fl4h_crc32(const u8* data, u64 len, u32 seed)
//   i64  fl4h_frame_size(u32 header_len, u64 payload_len)
//   i64  fl4h_frame(const u8* header, u32 header_len,
//                   const u8* payload, u64 payload_len,
//                   u16 flags, u8* out, u64 out_cap)
//   i64  fl4h_unframe(const u8* buf, u64 len,
//                     u32* header_off, u32* header_len,
//                     u64* payload_off, u64* payload_len, u16* flags)
//     returns 0 ok; -1 short; -2 bad magic; -3 bad version; -4 bad crc
//   i64  fl4h_pack_nibbles(const i8* vals, u64 n, u8* out, u64 out_cap)
//     packs signed int4 values (each in [-8, 7]) two per byte (low nibble
//     first); returns packed byte count or -1 on short buffer
//   i64  fl4h_unpack_nibbles(const u8* packed, u64 n_vals,
//                            i8* out, u64 out_cap)
//     inverse (sign-extends each nibble); returns n_vals or -1
// The nibble helpers are the hot byte loop of the compressed int4 wire
// frames (codec.py encode_compressed) — the Python twin matches them
// byte-for-byte (tests/test_torch_transport.py).

#include <cstdint>
#include <cstring>

extern "C" {

static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_init_done = true;
}

uint32_t fl4h_crc32(const uint8_t* data, uint64_t len, uint32_t seed) {
    if (!crc_init_done) crc_init();
    uint32_t c = seed ^ 0xFFFFFFFFu;
    for (uint64_t i = 0; i < len; i++)
        c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

static const uint32_t kMagic = 0x464C3448u;
static const uint16_t kVersion = 1;
static const uint64_t kHeaderFixed = 4 + 2 + 2 + 4 + 8;

int64_t fl4h_frame_size(uint32_t header_len, uint64_t payload_len) {
    return (int64_t)(kHeaderFixed + header_len + payload_len + 4);
}

static void put_u16(uint8_t* p, uint16_t v) { memcpy(p, &v, 2); }
static void put_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
static void put_u64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }
static uint16_t get_u16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
static uint32_t get_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
static uint64_t get_u64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

int64_t fl4h_frame(const uint8_t* header, uint32_t header_len,
                   const uint8_t* payload, uint64_t payload_len,
                   uint16_t flags, uint8_t* out, uint64_t out_cap) {
    uint64_t total = kHeaderFixed + header_len + payload_len + 4;
    if (out_cap < total) return -1;
    uint8_t* p = out;
    put_u32(p, kMagic); p += 4;
    put_u16(p, kVersion); p += 2;
    put_u16(p, flags); p += 2;
    put_u32(p, header_len); p += 4;
    put_u64(p, payload_len); p += 8;
    if (header_len) { memcpy(p, header, header_len); p += header_len; }
    if (payload_len) { memcpy(p, payload, payload_len); p += payload_len; }
    uint32_t crc = fl4h_crc32(out, (uint64_t)(p - out), 0);
    put_u32(p, crc);
    return (int64_t)total;
}

int64_t fl4h_unframe(const uint8_t* buf, uint64_t len,
                     uint32_t* header_off, uint32_t* header_len,
                     uint64_t* payload_off, uint64_t* payload_len,
                     uint16_t* flags) {
    if (len < kHeaderFixed + 4) return -1;
    if (get_u32(buf) != kMagic) return -2;
    if (get_u16(buf + 4) != kVersion) return -3;
    uint16_t fl = get_u16(buf + 6);
    uint32_t hlen = get_u32(buf + 8);
    uint64_t plen = get_u64(buf + 12);
    uint64_t total = kHeaderFixed + hlen + plen + 4;
    if (len < total) return -1;
    uint32_t expect = get_u32(buf + total - 4);
    uint32_t actual = fl4h_crc32(buf, total - 4, 0);
    if (expect != actual) return -4;
    *header_off = (uint32_t)kHeaderFixed;
    *header_len = hlen;
    *payload_off = kHeaderFixed + hlen;
    *payload_len = plen;
    *flags = fl;
    return 0;
}

int64_t fl4h_pack_nibbles(const int8_t* vals, uint64_t n,
                          uint8_t* out, uint64_t out_cap) {
    uint64_t packed = (n + 1) / 2;
    if (out_cap < packed) return -1;
    for (uint64_t i = 0; i < packed; i++) {
        uint8_t lo = (uint8_t)(vals[2 * i]) & 0xF;
        uint8_t hi = (2 * i + 1 < n) ? ((uint8_t)(vals[2 * i + 1]) & 0xF) : 0;
        out[i] = (uint8_t)(lo | (hi << 4));
    }
    return (int64_t)packed;
}

int64_t fl4h_unpack_nibbles(const uint8_t* packed, uint64_t n_vals,
                            int8_t* out, uint64_t out_cap) {
    if (out_cap < n_vals) return -1;
    for (uint64_t i = 0; i < n_vals; i++) {
        uint8_t nib = (i & 1) ? (packed[i / 2] >> 4) : (packed[i / 2] & 0xF);
        // sign-extend the 4-bit two's-complement value
        out[i] = (int8_t)((nib ^ 0x8) - 0x8);
    }
    return (int64_t)n_vals;
}

}  // extern "C"
