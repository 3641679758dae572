// Parallel, in-order FASTQ/FASTA reader: the port's host ingest.
//
// Same batch stream as the JAX package's reader (cpp/fastq_reader.cpp:
// N-segmentation at an N at offset >= k of the current segment, earlier Ns
// kept as code 4; the read-middle seed column; long segments tiled into rows
// with k-1 overlap; the 2-bit pack and N mask of ops/packio.pack_np), but one
// file is decoded on all threads:
//
//   I/O thread   reads each file in turn in parts of about CHUNK bytes (plain
//                files with read(2) straight into the part's buffer, gzip
//                through zlib, bzip2 through the dlopen'd libbz2), cuts each
//                part after its last complete record (FASTQ: every fourth
//                line from the file's start; FASTA: before the last line that
//                starts with '>'), and numbers the parts.  A record never
//                spans two parts.
//   workers      decode whole parts, with no lock per read, into one set of
//                row arrays a part (codes, or packed + nmask; lengths; seed
//                columns).
//   hand-off     next_batch / next_batch_packed take the parts strictly in
//                their order, one lock a part, and copy row ranges into the
//                caller's batch; a part's rows may straddle batches.
//
// Files are read one after another in list order, so the rows come out in
// file order, the order the reference's single worker gives for one file.
// At most 2 * workers + 2 parts exist at once (the slots of a ring), each
// holding about CHUNK bytes of text and its rows: with 8 workers and 150 bp
// FASTQ about 18 x 10 MB of host memory.
//
// Plain C interface for ctypes; built by io/native.py.
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <dlfcn.h>
#include <fcntl.h>
#include <unistd.h>
#include <zlib.h>

namespace {

constexpr uint8_t CODE_N = 4;
constexpr uint8_t CODE_PAD = 5;
constexpr size_t CHUNK = 1u << 23;  // 8 MB parts, like the reference

// ---------------------------------------------------------------------------
// bzip2 via dlopen: the stable public ABI (bz_stream and the three decompress
// entry points) is declared here and bound at run time, so no bzlib.h is
// needed.  Multi-stream files (pbzip2 output) re-init on BZ_STREAM_END.

struct bz_stream {
  char* next_in;
  unsigned avail_in;
  unsigned total_in_lo32, total_in_hi32;
  char* next_out;
  unsigned avail_out;
  unsigned total_out_lo32, total_out_hi32;
  void* state;
  void* (*bzalloc)(void*, int, int);
  void (*bzfree)(void*, void*);
  void* opaque;
};
constexpr int BZ_OK = 0, BZ_STREAM_END = 4;

struct Bz2Api {
  int (*init)(bz_stream*, int, int) = nullptr;
  int (*decompress)(bz_stream*) = nullptr;
  int (*end)(bz_stream*) = nullptr;
  bool ok() const { return init && decompress && end; }
};

const Bz2Api& bz2_api() {
  static Bz2Api api = [] {
    Bz2Api a;
    for (const char* name : {"libbz2.so.1", "libbz2.so", "libbz2.so.1.0"}) {
      if (void* h = dlopen(name, RTLD_NOW | RTLD_GLOBAL)) {
        a.init = (int (*)(bz_stream*, int, int))dlsym(
            h, "BZ2_bzDecompressInit");
        a.decompress = (int (*)(bz_stream*))dlsym(h, "BZ2_bzDecompress");
        a.end = (int (*)(bz_stream*))dlsym(h, "BZ2_bzDecompressEnd");
        if (a.ok()) break;
        a = Bz2Api();
      }
    }
    return a;
  }();
  return api;
}

class Bz2File {
 public:
  explicit Bz2File(const std::string& path) {
    f_ = fopen(path.c_str(), "rb");
    if (!f_ || !bz2_api().ok()) return;
    memset(&strm_, 0, sizeof(strm_));
    if (bz2_api().init(&strm_, 0, 0) != BZ_OK) return;
    live_ = true;
    in_.resize(1u << 20);
  }
  ~Bz2File() {
    if (live_) bz2_api().end(&strm_);
    if (f_) fclose(f_);
  }
  bool ok() const { return f_ != nullptr && live_; }

  // Up to len bytes; fewer only at the end of the stream; -1 on error.
  long read(char* buf, unsigned len) {
    if (eof_) return 0;
    if (!live_) return -1;
    strm_.next_out = buf;
    strm_.avail_out = len;
    while (strm_.avail_out > 0) {
      if (strm_.avail_in == 0 && !in_eof_) {
        size_t got = fread(in_.data(), 1, in_.size(), f_);
        if (got == 0) {
          if (ferror(f_)) return -1;
          in_eof_ = true;
        }
        strm_.next_in = in_.data();
        strm_.avail_in = (unsigned)got;
      }
      int rc = bz2_api().decompress(&strm_);
      if (rc == BZ_STREAM_END) {
        bz2_api().end(&strm_);
        live_ = false;
        if (strm_.avail_in == 0 && in_eof_) {
          eof_ = true;
          break;
        }
        char* ni = strm_.next_in;
        unsigned ai = strm_.avail_in;
        char* no = strm_.next_out;
        unsigned ao = strm_.avail_out;
        memset(&strm_, 0, sizeof(strm_));
        if (bz2_api().init(&strm_, 0, 0) != BZ_OK) return -1;
        live_ = true;
        strm_.next_in = ni;
        strm_.avail_in = ai;
        strm_.next_out = no;
        strm_.avail_out = ao;
      } else if (rc != BZ_OK) {
        return -1;
      } else if (strm_.avail_in == 0 && in_eof_) {
        eof_ = true;  // truncated stream: what was decoded, then the end
        break;
      }
    }
    return (long)(len - strm_.avail_out);
  }

 private:
  FILE* f_ = nullptr;
  bz_stream strm_;
  std::vector<char> in_;
  bool live_ = false, eof_ = false, in_eof_ = false;
};

// One input stream: plain (read(2)), gzip (zlib) or bzip2, by magic bytes
// (and the .bz2 suffix, as the reference sniffs it).
class Source {
 public:
  explicit Source(const std::string& path) {
    int fd = open(path.c_str(), O_RDONLY);
    if (fd < 0) return;
    unsigned char m[3] = {0, 0, 0};
    ssize_t got = pread(fd, m, 3, 0);
    const bool bz2 =
        (path.size() >= 4 && path.compare(path.size() - 4, 4, ".bz2") == 0) ||
        (got == 3 && m[0] == 'B' && m[1] == 'Z' && m[2] == 'h');
    const bool gz = got >= 2 && m[0] == 0x1f && m[1] == 0x8b;
    if (bz2) {
      close(fd);
      bz_ = new Bz2File(path);
      ok_ = bz_->ok();
    } else if (gz) {
      gz_ = gzdopen(fd, "rb");
      if (!gz_) {
        close(fd);
        return;
      }
      gzbuffer(gz_, 1u << 24);
      ok_ = true;
    } else {
      fd_ = fd;
      posix_fadvise(fd_, 0, 0, POSIX_FADV_SEQUENTIAL);
      ok_ = true;
    }
  }
  ~Source() {
    if (gz_) gzclose(gz_);
    if (fd_ >= 0) close(fd_);
    delete bz_;
  }
  bool ok() const { return ok_; }

  // Fill buf with up to len bytes; fewer only at the end; -1 on error.
  long fill(char* buf, size_t len) {
    size_t got = 0;
    while (got < len) {
      const size_t want = std::min(len - got, (size_t)1 << 30);
      long r;
      if (fd_ >= 0) r = ::read(fd_, buf + got, want);
      else if (gz_) r = gzread(gz_, buf + got, (unsigned)want);
      else r = bz_->read(buf + got, (unsigned)want);
      if (r < 0) return -1;
      if (r == 0) break;
      got += (size_t)r;
    }
    return (long)got;
  }

 private:
  int fd_ = -1;
  gzFile gz_ = nullptr;
  Bz2File* bz_ = nullptr;
  bool ok_ = false;
};

uint8_t g_ascii2code[256];

void init_tables() {
  static std::once_flag once;
  std::call_once(once, [] {
    memset(g_ascii2code, CODE_N, sizeof(g_ascii2code));
    g_ascii2code['A'] = g_ascii2code['a'] = 0;
    g_ascii2code['C'] = g_ascii2code['c'] = 1;
    g_ascii2code['G'] = g_ascii2code['g'] = 2;
    g_ascii2code['T'] = g_ascii2code['t'] = 3;
  });
}

// Newlines in [p, p + n), eight bytes at a time.
size_t count_newlines(const char* p, size_t n) {
  constexpr uint64_t ONES = 0x0101010101010101ull, LOW7 = 0x7F7F7F7F7F7F7F7Full;
  size_t c = 0, i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    memcpy(&w, p + i, 8);
    const uint64_t x = w ^ (ONES * '\n');
    // high bit set exactly in the zero bytes of x
    c += __builtin_popcountll(~(((x & LOW7) + LOW7) | x | LOW7));
  }
  for (; i < n; i++) c += p[i] == '\n';
  return c;
}

// A part's text, grown without zero-filling.
class Text {
 public:
  char* data() { return p_.get(); }
  // Room for n bytes (and an eighth more), keeping the first `keep`.
  void reserve(size_t n, size_t keep) {
    if (n_ >= n) return;
    n_ = n + n / 8;
    std::unique_ptr<char[]> q(new char[n_]);
    if (keep) memcpy(q.get(), p_.get(), keep);
    p_ = std::move(q);
  }

 private:
  std::unique_ptr<char[]> p_;
  size_t n_ = 0;
};

struct Part {
  Text text;  // text[0, len) holds whole records
  size_t len = 0;
  bool fasta = false;
  uint64_t seq = 0;
  enum { FREE, READY, DONE } state = FREE;
  // rows: codes (row_bytes = L) or packed (row_bytes = L / 4, + nmask)
  std::vector<uint8_t> rows, nmask;
  std::vector<int32_t> lengths, seeds;
  size_t n_rows = 0;
};

class Reader {
 public:
  Reader(std::vector<std::string> paths, int k, int n_threads, int row_len,
         bool packed, size_t part_bytes)
      : paths_(std::move(paths)),
        k_(k),
        L_(row_len),
        packed_(packed),
        part_bytes_(part_bytes ? part_bytes : CHUNK) {
    init_tables();
    const int w = std::max(1, n_threads);
    slots_.resize(2 * (size_t)w + 2);
    used_.assign(w, 0);
    io_ = std::thread([this] { io_loop(); });
    for (int i = 0; i < w; i++) workers_.emplace_back([this, i] { work(i); });
  }

  ~Reader() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_free_.notify_all();
    cv_ready_.notify_all();
    cv_done_.notify_all();
    io_.join();
    for (auto& t : workers_) t.join();
  }

  bool failed() const { return failed_.load(); }

  void stats(int64_t* parts, int32_t* workers, double* wait_s) {
    std::lock_guard<std::mutex> g(mu_);
    *parts = (int64_t)decoded_;
    *workers = (int32_t)std::count(used_.begin(), used_.end(), 1);
    *wait_s = wait_s_;
  }

  // Up to B rows of (B, L) codes, lengths and seed columns (-1 in every row
  // without the read's middle k-mer).  Rows past the count returned are left
  // as they are, except their seed column.  0 means the end of the stream;
  // -1 a batch shape other than the one the reader was opened for.
  int next_batch(uint8_t* codes, int32_t* lengths, int B, int L,
                 int32_t* seed_cols) {
    if (L != L_ || packed_) return -1;
    const int rows = fill(codes, nullptr, lengths, seed_cols, B, (size_t)L);
    for (int r = rows; r < B; r++) seed_cols[r] = -1;
    return rows;
  }

  // Packed batch: packed u8[B, L/4] (2-bit codes, little-endian within the
  // byte), nmask u8[B, L/8] (bit j%8 set iff code >= 4, pad included), the
  // ops/packio.pack_np layout.  Rows past the count returned are pad rows:
  // packed 0, nmask all set, length 0, seed column -1.
  int next_batch_packed(uint8_t* packed, uint8_t* nmask, int32_t* lengths,
                        int B, int L, int32_t* seed_cols) {
    if (L != L_ || !packed_) return -1;
    const int rows = fill(packed, nmask, lengths, seed_cols, B, (size_t)L / 4);
    const size_t Lq = L / 4, Lo = L / 8;
    for (int r = rows; r < B; r++) {
      memset(packed + r * Lq, 0, Lq);
      memset(nmask + r * Lo, 0xFF, Lo);
      lengths[r] = 0;
      seed_cols[r] = -1;
    }
    return rows;
  }

 private:
  // ---- hand-off: parts in their order, row ranges into the batch ----------
  int fill(uint8_t* rows, uint8_t* nmask, int32_t* lengths, int32_t* seeds,
           int B, size_t row_bytes) {
    const size_t Lo = (size_t)L_ / 8;
    int row = 0;
    while (row < B) {
      if (!cur_) {
        std::unique_lock<std::mutex> lk(mu_);
        Part& p = slots_[next_out_ % slots_.size()];
        auto ready = [&] {
          return stop_ || (p.state == Part::DONE && p.seq == next_out_) ||
                 (io_done_ && next_out_ >= published_);
        };
        if (!ready()) {
          const auto t0 = std::chrono::steady_clock::now();
          cv_done_.wait(lk, ready);
          wait_s_ += std::chrono::duration<double>(
                         std::chrono::steady_clock::now() - t0)
                         .count();
        }
        if (stop_ || p.state != Part::DONE || p.seq != next_out_) break;
        cur_ = &p;
        cur_row_ = 0;
      }
      const size_t n = std::min((size_t)(B - row), cur_->n_rows - cur_row_);
      if (n) {  // a part may hold no row: all its reads shorter than k
        memcpy(rows + row * row_bytes,
               cur_->rows.data() + cur_row_ * row_bytes, n * row_bytes);
        if (nmask)
          memcpy(nmask + row * Lo, cur_->nmask.data() + cur_row_ * Lo,
                 n * Lo);
        memcpy(lengths + row, cur_->lengths.data() + cur_row_, n * 4);
        memcpy(seeds + row, cur_->seeds.data() + cur_row_, n * 4);
        row += (int)n;
        cur_row_ += n;
      }
      if (cur_row_ == cur_->n_rows) {
        std::lock_guard<std::mutex> g(mu_);
        cur_->state = Part::FREE;
        cur_ = nullptr;
        next_out_++;
        cv_free_.notify_all();
      }
    }
    return row;
  }

  // ---- I/O thread: whole records into numbered parts ----------------------
  void io_loop() {
    for (const std::string& path : paths_) {
      Source src(path);
      if (!src.ok()) {
        failed_.store(true);
        break;
      }
      std::string carry;  // the start of a record the last part cut off
      bool first = true, fasta = false, eof = false;
      while (!eof) {
        Part* p = take_free_slot();
        if (!p) break;
        Text& t = p->text;
        size_t len = carry.size(), cut = 0, nl = 0, scanned = 0;
        t.reserve(len + part_bytes_, 0);
        memcpy(t.data(), carry.data(), len);
        for (;;) {
          const long got = src.fill(t.data() + len, part_bytes_);
          if (got < 0) {
            failed_.store(true);
            break;
          }
          len += (size_t)got;
          if (first && len) {
            fasta = t.data()[0] == '>';
            first = false;
          }
          eof = (size_t)got < part_bytes_;
          if (fasta) cut = eof ? len : fasta_cut(t.data(), len, scanned);
          else cut = fastq_cut(t.data(), len, nl, scanned, eof);
          if (cut || eof) break;
          t.reserve(len + part_bytes_, len);  // no whole record yet: read on
        }
        if (failed_.load()) break;
        carry.assign(t.data() + cut, len - cut);
        p->len = cut;
        p->fasta = fasta;
        publish(p);
      }
      if (failed_.load() || stopping()) break;
    }
    std::lock_guard<std::mutex> g(mu_);
    io_done_ = true;
    cv_ready_.notify_all();
    cv_done_.notify_all();
  }

  // FASTQ: the end of the last complete 4-line record of t[0, len) (the
  // part starts at a record), or 0.  At the end of the file a last line
  // without a newline counts, as the reference reads it; lines past the last
  // complete record drop.  nl and scanned carry the newline count across
  // reads into the same part.
  static size_t fastq_cut(const char* t, size_t len, size_t& nl,
                          size_t& scanned, bool eof) {
    nl += count_newlines(t + scanned, len - scanned);
    scanned = len;
    if (eof && len && t[len - 1] != '\n' && (nl + 1) % 4 == 0) return len;
    if (nl < 4) return 0;
    // back over the newlines of the last, incomplete record
    size_t end = len;
    for (size_t skip = nl % 4;; skip--) {
      end = (size_t)((const char*)memrchr(t, '\n', end) - t);
      if (skip == 0) return end + 1;
    }
  }

  // FASTA, more data to come: the start of the last line that begins with
  // '>' (past offset 0), or 0.  scanned: the offset searched down to so far.
  static size_t fasta_cut(const char* t, size_t len, size_t& scanned) {
    size_t end = len, lo = scanned ? scanned - 1 : 0;
    while (end > lo) {
      const char* q = (const char*)memrchr(t + lo, '\n', end - lo);
      if (!q) break;
      const size_t i = (size_t)(q - t);
      if (i + 1 < len && t[i + 1] == '>') {
        scanned = len;
        return i + 1;
      }
      end = i;
    }
    scanned = len;
    return 0;
  }

  Part* take_free_slot() {
    std::unique_lock<std::mutex> lk(mu_);
    Part& p = slots_[published_ % slots_.size()];
    cv_free_.wait(lk, [&] { return stop_ || p.state == Part::FREE; });
    return stop_ ? nullptr : &p;
  }

  void publish(Part* p) {
    if (!p->len) return;  // an empty file, or nothing after the last cut
    std::lock_guard<std::mutex> g(mu_);
    p->seq = published_++;
    p->state = Part::READY;
    cv_ready_.notify_one();
  }

  bool stopping() {
    std::lock_guard<std::mutex> g(mu_);
    return stop_;
  }

  // ---- workers: whole parts into rows --------------------------------------
  struct Scratch {
    std::vector<uint8_t> codes, row;
    std::string fasta_seq;
  };

  void work(int id) {
    Scratch s;
    s.row.resize((size_t)L_ + 8);
    for (;;) {
      Part* p;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_ready_.wait(lk, [&] {
          return stop_ || next_decode_ < published_ || io_done_;
        });
        if (stop_ || next_decode_ >= published_) return;
        p = &slots_[next_decode_++ % slots_.size()];
      }
      decode(*p, s);
      std::lock_guard<std::mutex> g(mu_);
      p->state = Part::DONE;
      decoded_++;
      used_[id] = 1;
      cv_done_.notify_all();
    }
  }

  void decode(Part& p, Scratch& s) {
    p.n_rows = 0;
    const char* t = p.text.data();
    const size_t n = p.len;
    size_t pos = 0;
    if (!p.fasta) {
      // lines 4i + 1 are the sequences; the part holds whole records
      for (size_t line = 0; pos < n; line++) {
        const char* q = (const char*)memchr(t + pos, '\n', n - pos);
        const size_t end = q ? (size_t)(q - t) : n;
        if ((line & 3) == 1) {
          size_t l = end - pos;
          while (l && t[pos + l - 1] == '\r') l--;
          if (l) emit_read(p, s, t + pos, l);
        }
        pos = end + 1;
      }
      return;
    }
    std::string& seq = s.fasta_seq;
    seq.clear();
    while (pos < n) {
      const char* q = (const char*)memchr(t + pos, '\n', n - pos);
      const size_t end = q ? (size_t)(q - t) : n;
      size_t l = end - pos;
      while (l && t[pos + l - 1] == '\r') l--;
      if (l) {
        if (t[pos] == '>') {
          if (!seq.empty()) emit_read(p, s, seq.data(), seq.size());
          seq.clear();
        } else {
          seq.append(t + pos, l);
        }
      }
      pos = end + 1;
    }
    if (!seq.empty()) emit_read(p, s, seq.data(), seq.size());
  }

  // Encode one read, split it at the N-segmentation rule, tile each segment.
  void emit_read(Part& p, Scratch& s, const char* seq, size_t n) {
    const size_t k = (size_t)k_;
    if (s.codes.size() < n) s.codes.resize(n);
    uint8_t* codes = s.codes.data();
    uint8_t any_n = 0;
    for (size_t i = 0; i < n; i++) {
      const uint8_t c = g_ascii2code[(uint8_t)seq[i]];
      codes[i] = c;
      any_n |= c;
    }
    any_n &= CODE_N;
    // the read-middle seed k-mer (reference find_unitigs_mt_master seeding,
    // contig_assembly.cpp:2068-2080), skipped when it holds an N
    const size_t middle = n / 2;
    bool seed_ok = middle + k <= n;
    if (seed_ok && any_n)
      for (size_t i = middle; i < middle + k; i++)
        if (codes[i] == CODE_N) {
          seed_ok = false;
          break;
        }
    auto segment = [&](size_t b, size_t e) {
      const int64_t seed =
          seed_ok && b <= middle && middle + k <= e ? (int64_t)(middle - b) : -1;
      tile(p, s, codes + b, e - b, seed);
    };
    size_t start = 0;
    if (any_n)
      for (size_t i = k; i < n; i++)
        if (codes[i] == CODE_N && i >= start + k) {
          segment(start, i);
          start = i + 1;
        }
    if (n >= start + k) segment(start, n);
  }

  // Rows of one segment: L codes a row, k - 1 of overlap.
  void tile(Part& p, Scratch& s, const uint8_t* codes, size_t n, int64_t seed) {
    const size_t L = (size_t)L_, k = (size_t)k_, step = L - k + 1;
    for (size_t off = 0; off + k <= n; off += step) {
      const size_t len = std::min(L, n - off);
      const int32_t col =
          seed >= (int64_t)off && seed < (int64_t)(off + step)
              ? (int32_t)(seed - (int64_t)off)
              : -1;
      add_row(p, s, codes + off, len, col);
      if (off + len >= n) break;
    }
  }

  void add_row(Part& p, Scratch& s, const uint8_t* codes, size_t len,
               int32_t seed_col) {
    const size_t L = (size_t)L_, r = p.n_rows++;
    if (p.lengths.size() < p.n_rows) {
      const size_t cap = std::max<size_t>(1024, 2 * p.n_rows);
      p.lengths.resize(cap);
      p.seeds.resize(cap);
      p.rows.resize(cap * (packed_ ? L / 4 : L));
      if (packed_) p.nmask.resize(cap * (L / 8));
    }
    p.lengths[r] = (int32_t)len;
    p.seeds[r] = seed_col;
    if (!packed_) {
      uint8_t* dst = p.rows.data() + r * L;
      memcpy(dst, codes, len);
      memset(dst + len, CODE_PAD, L - len);
      return;
    }
    uint8_t* row = s.row.data();
    memcpy(row, codes, len);
    memset(row + len, CODE_PAD, L - len);
    uint8_t* pd = p.rows.data() + r * (L / 4);
    uint8_t* nm = p.nmask.data() + r * (L / 8);
    for (size_t j = 0; j < L; j += 8) {
      uint64_t x;
      memcpy(&x, row + j, 8);
      // 2-bit codes of the eight bytes, gathered into 16 bits
      uint64_t y = x & 0x0303030303030303ull;
      y = (y | (y >> 6)) & 0x000F000F000F000Full;
      y = (y | (y >> 12)) & 0x000000FF000000FFull;
      y = (y | (y >> 24)) & 0xFFFFull;
      pd[j / 4] = (uint8_t)y;
      pd[j / 4 + 1] = (uint8_t)(y >> 8);
      // code >= 4 (N or pad) is bit 2 of each byte, gathered into 8 bits
      uint64_t z = (x >> 2) & 0x0101010101010101ull;
      z = (z | (z >> 7)) & 0x0003000300030003ull;
      z = (z | (z >> 14)) & 0x0000000F0000000Full;
      z = (z | (z >> 28)) & 0xFFull;
      nm[j / 8] = (uint8_t)z;
    }
  }

  const std::vector<std::string> paths_;
  const int k_, L_;
  const bool packed_;
  const size_t part_bytes_;
  std::vector<Part> slots_;
  std::thread io_;
  std::vector<std::thread> workers_;
  std::atomic<bool> failed_{false};
  std::mutex mu_;
  std::condition_variable cv_free_, cv_ready_, cv_done_;
  uint64_t published_ = 0, next_decode_ = 0, next_out_ = 0, decoded_ = 0;
  bool io_done_ = false, stop_ = false;
  std::vector<char> used_;
  double wait_s_ = 0.0;
  // the hand-off's part (touched by the caller's thread only)
  Part* cur_ = nullptr;
  size_t cur_row_ = 0;
};

}  // namespace

extern "C" {

// 1 iff libbz2 bound at run time (io/native.py reads .bz2 with the Python
// reader otherwise).
int fqr_has_bz2() { return bz2_api().ok() ? 1 : 0; }

// packed: 1 for next_batch_packed (row_len a multiple of 8), 0 for
// next_batch.  part_bytes: 0 for the default 8 MB parts.
void* fqr_open(const char** paths, int n_paths, int k, int n_threads,
               int row_len, int packed, int64_t part_bytes) {
  if (k < 1 || row_len < k || (packed && row_len % 8) || part_bytes < 0)
    return nullptr;
  std::vector<std::string> v;
  for (int i = 0; i < n_paths; i++) v.emplace_back(paths[i]);
  return new Reader(std::move(v), k, n_threads, row_len, packed != 0,
                    (size_t)part_bytes);
}

int fqr_next_batch(void* h, uint8_t* codes, int32_t* lengths, int B, int L,
                   int32_t* seed_cols) {
  return static_cast<Reader*>(h)->next_batch(codes, lengths, B, L, seed_cols);
}

int fqr_next_batch_packed(void* h, uint8_t* packed, uint8_t* nmask,
                          int32_t* lengths, int B, int L,
                          int32_t* seed_cols) {
  return static_cast<Reader*>(h)->next_batch_packed(packed, nmask, lengths, B,
                                                    L, seed_cols);
}

int fqr_failed(void* h) { return static_cast<Reader*>(h)->failed() ? 1 : 0; }

// Parts decoded, workers that decoded at least one, and the seconds the
// hand-off waited for the next part in order.
void fqr_stats(void* h, int64_t* parts, int32_t* workers, double* wait_s) {
  static_cast<Reader*>(h)->stats(parts, workers, wait_s);
}

void fqr_close(void* h) { delete static_cast<Reader*>(h); }

}  // extern "C"
