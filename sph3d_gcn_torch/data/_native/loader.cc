// Native record-reader core: TFRecord framing and CRC32C (counterpart of
// the JAX package's data/_native/loader.cc, the same code).
//
// The host-side record IO is this small C++ core; the Python wire-format
// Example decoder sits on top (protobuf decode is not the bottleneck, file
// scanning and checksumming are).
//
// Built at first use by sph3d_gcn_torch/data/native_loader.py:
//   g++ -O3 -std=c++17 -shared -fPIC loader.cc -o libsph3dloader.so
// into .kernel_build/native_loader/<hash of source and flags>/, bound via
// ctypes there.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// CRC32C (Castagnoli), slicing-by-8.
uint32_t kTable[8][256];
bool kInit = false;

void init_tables() {
  if (kInit) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    kTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int s = 1; s < 8; ++s)
      kTable[s][i] = (kTable[s - 1][i] >> 8) ^ kTable[0][kTable[s - 1][i] & 0xFF];
  kInit = true;
}

uint32_t crc32c(const uint8_t* data, int64_t n) {
  init_tables();
  uint32_t crc = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    word ^= crc;  // little-endian host assumed (x86/arm64)
    crc = kTable[7][word & 0xFF] ^ kTable[6][(word >> 8) & 0xFF] ^
          kTable[5][(word >> 16) & 0xFF] ^ kTable[4][(word >> 24) & 0xFF] ^
          kTable[3][(word >> 32) & 0xFF] ^ kTable[2][(word >> 40) & 0xFF] ^
          kTable[1][(word >> 48) & 0xFF] ^ kTable[0][(word >> 56) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) crc = (crc >> 8) ^ kTable[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, int64_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

}  // namespace

extern "C" {

// Masked CRC32C as used by the TFRecord framing.
uint32_t sph3d_masked_crc32c(const uint8_t* data, int64_t n) {
  return masked_crc(data, n);
}

// Scan a TFRecord file: fill (offsets, lengths) of up to `cap` payloads.
// Returns the record count, or a negative error:
//   -1 open failure, -2 truncated file, -3 CRC mismatch, -4 cap exceeded.
int64_t sph3d_tfrecord_scan(const char* path, int64_t* offsets,
                            int64_t* lengths, int64_t cap, int verify_crc) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t count = 0;
  std::vector<uint8_t> buf;
  for (;;) {
    uint8_t header[12];
    size_t got = std::fread(header, 1, 12, f);
    if (got == 0) break;
    if (got != 12) { std::fclose(f); return -2; }
    uint64_t len;
    std::memcpy(&len, header, 8);
    if (verify_crc) {
      uint32_t hcrc;
      std::memcpy(&hcrc, header + 8, 4);
      if (masked_crc(header, 8) != hcrc) { std::fclose(f); return -3; }
    }
    int64_t offset = static_cast<int64_t>(std::ftell(f));
    if (count >= cap) { std::fclose(f); return -4; }
    offsets[count] = offset;
    lengths[count] = static_cast<int64_t>(len);
    if (verify_crc) {
      buf.resize(len);
      if (std::fread(buf.data(), 1, len, f) != len) { std::fclose(f); return -2; }
      uint8_t footer[4];
      if (std::fread(footer, 1, 4, f) != 4) { std::fclose(f); return -2; }
      uint32_t dcrc;
      std::memcpy(&dcrc, footer, 4);
      if (masked_crc(buf.data(), len) != dcrc) { std::fclose(f); return -3; }
    } else {
      if (std::fseek(f, static_cast<long>(len) + 4, SEEK_CUR) != 0) {
        std::fclose(f);
        return -2;
      }
    }
    ++count;
  }
  std::fclose(f);
  return count;
}

// Read all record payloads into one contiguous buffer (caller sized it from
// a prior scan). Returns total bytes written or negative error as above.
int64_t sph3d_tfrecord_read(const char* path, uint8_t* out, int64_t out_cap,
                            const int64_t* offsets, const int64_t* lengths,
                            int64_t count) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t pos = 0;
  for (int64_t i = 0; i < count; ++i) {
    if (pos + lengths[i] > out_cap) { std::fclose(f); return -4; }
    if (std::fseek(f, static_cast<long>(offsets[i]), SEEK_SET) != 0) {
      std::fclose(f);
      return -2;
    }
    if (std::fread(out + pos, 1, lengths[i], f) !=
        static_cast<size_t>(lengths[i])) {
      std::fclose(f);
      return -2;
    }
    pos += lengths[i];
  }
  std::fclose(f);
  return pos;
}

}  // extern "C"
