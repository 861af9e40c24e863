// Threaded PLINK 1.x .bed genotype decoder.
//
// The reference framework takes plain arrays; real eQTL workflows stream
// genotypes from PLINK .bed files (2-bit packed, SNP-major).  This decoder
// mmap-free (plain pread) reads a variant range and expands it to float64
// allele counts with NaN for missing, threaded across variants — the
// native IO layer feeding the scan drivers.
//
// Encoding (PLINK 1.9, SNP-major, magic 0x6c 0x1b 0x01), 2 bits per sample,
// little-endian within a byte:
//   00 -> 2.0   (homozygous A1)
//   10 -> 1.0   (heterozygous)
//   11 -> 0.0   (homozygous A2)
//   01 -> NaN   (missing)
// This matches the a1-allele-count convention of pandas-plink.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libbed.so bedreader.cc -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const double kLut[4] = {2.0, std::nan(""), 1.0, 0.0};

}  // namespace

extern "C" {

// Returns 0 on success; 1 bad magic / io error; 2 bad arguments.
// out: column-major blocks — out[(v - v_start) * n_samples + s].
int bed_decode_range(const char* path, int64_t n_samples, int64_t n_variants,
                     int64_t v_start, int64_t v_end, double* out,
                     int n_threads) {
  if (n_samples <= 0 || v_start < 0 || v_end > n_variants || v_start > v_end)
    return 2;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  unsigned char magic[3];
  if (std::fread(magic, 1, 3, f) != 3 || magic[0] != 0x6c ||
      magic[1] != 0x1b || magic[2] != 0x01) {
    std::fclose(f);
    return 1;
  }
  std::fclose(f);

  int64_t bytes_per_variant = (n_samples + 3) / 4;
  int64_t n_out = v_end - v_start;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = (int)std::min<int64_t>(n_threads, std::max<int64_t>(1, n_out));

  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    FILE* fh = std::fopen(path, "rb");
    if (!fh) {
      err.store(1);
      return;
    }
    std::vector<unsigned char> buf(bytes_per_variant);
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_out || err.load()) break;
      int64_t v = v_start + i;
      int64_t off = 3 + v * bytes_per_variant;
#if defined(_WIN32)
      std::fseek(fh, (long)off, SEEK_SET);
#else
      // fseeko is POSIX, declared by <cstdio> in the global namespace only
      fseeko(fh, off, SEEK_SET);
#endif
      if (std::fread(buf.data(), 1, bytes_per_variant, fh) !=
          (size_t)bytes_per_variant) {
        err.store(1);
        break;
      }
      double* col = out + i * n_samples;
      int64_t s = 0;
      for (int64_t b = 0; b < bytes_per_variant; ++b) {
        unsigned char byte = buf[b];
        for (int shift = 0; shift < 8 && s < n_samples; shift += 2, ++s) {
          col[s] = kLut[(byte >> shift) & 0x3];
        }
      }
    }
    std::fclose(fh);
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return err.load();
}

}  // extern "C"
