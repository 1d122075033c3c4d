// Native I/O runtime: multithreaded BGZF inflate + BAM/FASTQ decoding
// into the columnar arrays the device kernels consume.
//
// Replaces the reference's samtools-text pipelines and BamTools reader
// (TERefiner/bam_parse.cpp) on the host side of the framework.
// C ABI (ctypes-friendly), no Python headers required.
//
// Layout contract mirrors gappadder/io/bam.py (Alignments) and
// io/fastq.py (ReadSet); name hashing = FNV-1a 64 over the normalized
// name (token before whitespace, trailing /1 or /2 stripped).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <zlib.h>

namespace {

constexpr uint64_t FNV_OFFSET = 0xCBF29CE484222325ull;
constexpr uint64_t FNV_PRIME = 0x100000001B3ull;

uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = FNV_OFFSET;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= FNV_PRIME;
  }
  return h;
}

// normalized length: up to first whitespace, minus trailing /1 or /2
size_t normalize(const char* s, size_t n) {
  size_t e = 0;
  while (e < n && s[e] != ' ' && s[e] != '\t') ++e;
  if (e >= 2 && s[e - 2] == '/' && (s[e - 1] == '1' || s[e - 1] == '2'))
    e -= 2;
  return e;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t rd = fread(out->data(), 1, out->size(), f);
  fclose(f);
  return rd == out->size();
}

struct Block {
  size_t in_off;
  size_t in_len;    // compressed payload length
  size_t out_off;
  size_t out_len;   // isize
};

// Parse BGZF block table, then inflate blocks across threads.
bool bgzf_inflate_all(const std::vector<uint8_t>& in,
                      std::vector<uint8_t>* out) {
  std::vector<Block> blocks;
  size_t off = 0, total = 0;
  while (off + 18 <= in.size()) {
    if (in[off] != 0x1f || in[off + 1] != 0x8b) return false;
    uint16_t xlen;
    memcpy(&xlen, &in[off + 10], 2);
    size_t eoff = off + 12, eend = eoff + xlen;
    if (eend > in.size()) return false;
    uint32_t bsize = 0;
    while (eoff + 4 <= eend) {
      uint8_t si1 = in[eoff], si2 = in[eoff + 1];
      uint16_t slen;
      memcpy(&slen, &in[eoff + 2], 2);
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        uint16_t bs;
        memcpy(&bs, &in[eoff + 4], 2);
        bsize = static_cast<uint32_t>(bs) + 1;
      }
      eoff += 4 + slen;
    }
    if (bsize == 0) return false;
    if (off + bsize > in.size()) return false;
    uint32_t isize;
    memcpy(&isize, &in[off + bsize - 4], 4);
    Block b;
    b.in_off = off + 12 + xlen;
    b.in_len = bsize - 12 - xlen - 8;
    b.out_off = total;
    b.out_len = isize;
    blocks.push_back(b);
    total += isize;
    off += bsize;
  }
  out->resize(total);
  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 2;
  nthreads = std::min<unsigned>(nthreads, 16);
  std::vector<std::thread> threads;
  std::vector<int> ok(nthreads, 1);
  size_t per = (blocks.size() + nthreads - 1) / nthreads;
  for (unsigned t = 0; t < nthreads; ++t) {
    threads.emplace_back([&, t]() {
      size_t lo = t * per, hi = std::min(blocks.size(), lo + per);
      for (size_t i = lo; i < hi; ++i) {
        const Block& b = blocks[i];
        if (b.out_len == 0) continue;
        z_stream zs{};
        if (inflateInit2(&zs, -15) != Z_OK) { ok[t] = 0; return; }
        zs.next_in = const_cast<Bytef*>(&in[b.in_off]);
        zs.avail_in = static_cast<uInt>(b.in_len);
        zs.next_out = &(*out)[b.out_off];
        zs.avail_out = static_cast<uInt>(b.out_len);
        int rc = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        if (rc != Z_STREAM_END) { ok[t] = 0; return; }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int o : ok) if (!o) return false;
  return true;
}

struct Decoded {
  std::vector<int32_t> i32cols;  // 11 columns x n, column-major
  std::vector<uint64_t> hashes;
  std::string refs;              // '\n'-joined reference names
  int64_t n = 0;
};

}  // namespace

// ---------------- streaming BAM reader ----------------
// Bounded-memory path for production-scale BAMs: the BGZF block table
// is built from the file (header reads + seeks only), then records
// decode chunk by chunk with a carry buffer for records spanning
// block boundaries.
struct BamStream {
  FILE* f = nullptr;
  std::vector<Block> blocks;     // in_off/in_len valid; out_off unused
  size_t next_block = 0;
  std::vector<uint8_t> carry;    // undecoded bytes from previous chunk
  std::string refs;
  bool header_done = false;
  // column staging for the current chunk
  std::vector<int32_t> cols[11];
  std::vector<uint64_t> hashes;
};

static bool stream_fill(BamStream* s, size_t want_bytes) {
  // append inflated blocks to carry until >= want_bytes or EOF
  while (s->carry.size() < want_bytes && s->next_block < s->blocks.size()) {
    const Block& b = s->blocks[s->next_block++];
    if (b.out_len == 0) continue;
    std::vector<uint8_t> comp(b.in_len);
    if (fseek(s->f, static_cast<long>(b.in_off), SEEK_SET) != 0) return false;
    if (fread(comp.data(), 1, b.in_len, s->f) != b.in_len) return false;
    size_t old = s->carry.size();
    s->carry.resize(old + b.out_len);
    z_stream zs{};
    if (inflateInit2(&zs, -15) != Z_OK) return false;
    zs.next_in = comp.data();
    zs.avail_in = static_cast<uInt>(b.in_len);
    zs.next_out = &s->carry[old];
    zs.avail_out = static_cast<uInt>(b.out_len);
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END) return false;
  }
  return true;
}

extern "C" {

void* bam_stream_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new BamStream();
  s->f = f;
  // scan BGZF block headers (header bytes + seeks only)
  uint8_t hdr[12];
  long off = 0;
  for (;;) {
    if (fseek(f, off, SEEK_SET) != 0) break;
    size_t rd = fread(hdr, 1, 12, f);
    if (rd < 12) break;
    if (hdr[0] != 0x1f || hdr[1] != 0x8b) break;
    uint16_t xlen;
    memcpy(&xlen, &hdr[10], 2);
    std::vector<uint8_t> extra(xlen);
    if (fread(extra.data(), 1, xlen, f) != xlen) break;
    uint32_t bsize = 0;
    size_t e = 0;
    while (e + 4 <= extra.size()) {
      uint16_t slen;
      memcpy(&slen, &extra[e + 2], 2);
      if (extra[e] == 'B' && extra[e + 1] == 'C' && slen == 2) {
        uint16_t bs;
        memcpy(&bs, &extra[e + 4], 2);
        bsize = static_cast<uint32_t>(bs) + 1;
      }
      e += 4 + slen;
    }
    if (bsize == 0) break;
    if (fseek(f, off + bsize - 4, SEEK_SET) != 0) break;
    uint32_t isize;
    if (fread(&isize, 1, 4, f) != 4) break;
    Block b;
    b.in_off = static_cast<size_t>(off) + 12 + xlen;
    b.in_len = bsize - 12 - xlen - 8;
    b.out_off = 0;
    b.out_len = isize;
    s->blocks.push_back(b);
    off += bsize;
  }
  if (s->blocks.empty()) { fclose(f); delete s; return nullptr; }
  // decode the header (fill until we can parse refs)
  if (!stream_fill(s, 1 << 16)) { fclose(f); delete s; return nullptr; }
  auto rd_i32 = [&](size_t o) {
    int32_t v; memcpy(&v, &s->carry[o], 4); return v;
  };
  if (s->carry.size() < 12 || memcmp(s->carry.data(), "BAM\x01", 4) != 0) {
    fclose(f); delete s; return nullptr;
  }
  int32_t l_text = rd_i32(4);
  size_t need = 8 + static_cast<size_t>(l_text) + 4;
  if (!stream_fill(s, need + (1 << 20))) { fclose(f); delete s; return nullptr; }
  size_t o = 8 + l_text;
  int32_t n_ref = rd_i32(o);
  o += 4;
  for (int r = 0; r < n_ref; ++r) {
    if (!stream_fill(s, o + (1 << 16))) break;
    int32_t l_name = rd_i32(o);
    if (r) s->refs.push_back('\n');
    s->refs.append(reinterpret_cast<char*>(&s->carry[o + 4]), l_name - 1);
    o += 4 + l_name + 4;
  }
  s->carry.erase(s->carry.begin(), s->carry.begin() + o);
  s->header_done = true;
  return s;
}

int64_t bam_stream_refs_len(void* h) {
  return static_cast<int64_t>(static_cast<BamStream*>(h)->refs.size());
}

void bam_stream_copy_refs(void* h, char* out) {
  auto* s = static_cast<BamStream*>(h);
  memcpy(out, s->refs.data(), s->refs.size());
}

// Decode up to max_records records; returns the count (0 = EOF).
// Call bam_stream_copy afterwards to fetch the staged columns.
int64_t bam_stream_next(void* h, int64_t max_records) {
  auto* s = static_cast<BamStream*>(h);
  for (auto& c : s->cols) c.clear();
  s->hashes.clear();
  size_t o = 0;
  while (static_cast<int64_t>(s->hashes.size()) < max_records) {
    if (s->carry.size() - o < 4) {
      s->carry.erase(s->carry.begin(), s->carry.begin() + o);
      o = 0;
      if (!stream_fill(s, 4) || s->carry.size() < 4) break;
    }
    int32_t bsz;
    memcpy(&bsz, &s->carry[o], 4);
    if (s->carry.size() - o < static_cast<size_t>(bsz) + 4) {
      s->carry.erase(s->carry.begin(), s->carry.begin() + o);
      o = 0;
      if (!stream_fill(s, static_cast<size_t>(bsz) + 4) ||
          s->carry.size() < static_cast<size_t>(bsz) + 4)
        break;
    }
    const uint8_t* rec = &s->carry[o + 4];
    auto gi = [&](size_t k) {
      int32_t v; memcpy(&v, rec + k, 4); return v;
    };
    int32_t tid = gi(0), pos = gi(4);
    uint8_t l_rn = rec[8], mapq = rec[9];
    uint16_t n_cig; memcpy(&n_cig, rec + 12, 2);
    uint16_t flag; memcpy(&flag, rec + 14, 2);
    int32_t l_seq = gi(16), mtid = gi(20), mpos = gi(24), tlen = gi(28);
    const char* name = reinterpret_cast<const char*>(rec + 32);
    const uint8_t* cig = rec + 32 + l_rn;
    int32_t lclip = 0, rclip = 0, nmatch = 0;
    for (int c = 0; c < n_cig; ++c) {
      uint32_t v; memcpy(&v, cig + 4 * c, 4);
      uint32_t ln = v >> 4, op = v & 0xF;
      if (op == 0 || op == 7 || op == 8) nmatch += ln;
      if (c == 0 && (op == 4 || op == 5)) lclip = ln;
      if (c == n_cig - 1 && (op == 4 || op == 5)) rclip = ln;
    }
    int32_t vals[11] = {tid, pos, flag, mapq, mtid, mpos, tlen,
                        lclip, rclip, nmatch, l_seq};
    for (int c = 0; c < 11; ++c) s->cols[c].push_back(vals[c]);
    s->hashes.push_back(fnv1a(name, normalize(name, l_rn - 1)));
    o += 4 + bsz;
  }
  s->carry.erase(s->carry.begin(), s->carry.begin() + o);
  return static_cast<int64_t>(s->hashes.size());
}

void bam_stream_copy(void* h, int32_t* i32out, uint64_t* hout) {
  auto* s = static_cast<BamStream*>(h);
  size_t n = s->hashes.size();
  for (int c = 0; c < 11; ++c)
    memcpy(i32out + c * n, s->cols[c].data(), n * 4);
  memcpy(hout, s->hashes.data(), n * 8);
}

void bam_stream_close(void* h) {
  auto* s = static_cast<BamStream*>(h);
  if (s->f) fclose(s->f);
  delete s;
}

// ---------- BAM ----------
// Opens + fully decodes a BAM; returns an opaque handle (or null).
void* bam_open(const char* path) {
  std::vector<uint8_t> raw;
  if (!read_file(path, &raw)) return nullptr;
  std::vector<uint8_t> u;
  if (!bgzf_inflate_all(raw, &u)) return nullptr;
  if (u.size() < 12 || memcmp(u.data(), "BAM\x01", 4) != 0) return nullptr;

  auto rd_i32 = [&](size_t o) {
    int32_t v; memcpy(&v, &u[o], 4); return v;
  };
  size_t off = 4;
  int32_t l_text = rd_i32(off); off += 4 + l_text;
  int32_t n_ref = rd_i32(off); off += 4;
  auto* d = new Decoded();
  for (int r = 0; r < n_ref; ++r) {
    int32_t l_name = rd_i32(off);
    if (r) d->refs.push_back('\n');
    d->refs.append(reinterpret_cast<char*>(&u[off + 4]), l_name - 1);
    off += 4 + l_name + 4;
  }
  // two-phase parse: a cheap sequential boundary hop (records are
  // length-prefixed, so offsets can't be found in parallel), then
  // PARALLEL field extraction straight into the preallocated columnar
  // output — the CIGAR walk + name hashing dominate and are
  // embarrassingly parallel per record range
  std::vector<size_t> rec_off;
  rec_off.reserve(u.size() / 128);
  while (off + 4 <= u.size()) {
    int32_t bsz = rd_i32(off);
    size_t rec = off + 4;
    off = rec + bsz;
    if (off > u.size()) break;
    rec_off.push_back(rec);
  }
  size_t n = rec_off.size();
  d->n = static_cast<int64_t>(n);
  d->i32cols.resize(n * 11);
  d->hashes.resize(n);
  int32_t* cols = d->i32cols.data();
  uint64_t* hashes = d->hashes.data();
  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 2;
  nthreads = std::max<unsigned>(
      1, std::min<size_t>(std::min<unsigned>(nthreads, 16), n ? n : 1));
  size_t per = n ? (n + nthreads - 1) / nthreads : 0;
  const uint8_t* ub = u.data();
  auto parse_range = [&](size_t lo_i, size_t hi_i) {
    for (size_t i = lo_i; i < hi_i; ++i) {
      size_t rec = rec_off[i];
      auto rd = [&](size_t o) {
        int32_t v; memcpy(&v, ub + o, 4); return v;
      };
      uint8_t l_rn = ub[rec + 8];
      uint16_t n_cig; memcpy(&n_cig, ub + rec + 12, 2);
      uint16_t flag; memcpy(&flag, ub + rec + 14, 2);
      const char* name = reinterpret_cast<const char*>(ub + rec + 32);
      size_t cig = rec + 32 + l_rn;
      int32_t lclip = 0, rclip = 0, nmatch = 0;
      for (int c = 0; c < n_cig; ++c) {
        uint32_t v; memcpy(&v, ub + cig + 4 * c, 4);
        uint32_t ln = v >> 4, op = v & 0xF;
        if (op == 0 || op == 7 || op == 8) nmatch += ln;
        if (c == 0 && (op == 4 || op == 5)) lclip = ln;
        if (c == n_cig - 1 && (op == 4 || op == 5)) rclip = ln;
      }
      cols[0 * n + i] = rd(rec + 0);                    // tid
      cols[1 * n + i] = rd(rec + 4);                    // pos
      cols[2 * n + i] = flag;
      cols[3 * n + i] = ub[rec + 9];                    // mapq
      cols[4 * n + i] = rd(rec + 20);                   // mtid
      cols[5 * n + i] = rd(rec + 24);                   // mpos
      cols[6 * n + i] = rd(rec + 28);                   // tlen
      cols[7 * n + i] = lclip;
      cols[8 * n + i] = rclip;
      cols[9 * n + i] = nmatch;
      cols[10 * n + i] = rd(rec + 16);                  // l_seq
      hashes[i] = fnv1a(name, normalize(name, l_rn - 1));
    }
  };
  if (nthreads <= 1 || n < 4096) {
    parse_range(0, n);
  } else {
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < nthreads; ++t)
      threads.emplace_back(parse_range, t * per,
                           std::min(n, (t + 1) * per));
    for (auto& th : threads) th.join();
  }
  return d;
}

int64_t bam_num_records(void* h) { return static_cast<Decoded*>(h)->n; }

int64_t bam_refs_len(void* h) {
  return static_cast<int64_t>(static_cast<Decoded*>(h)->refs.size());
}

void bam_copy_refs(void* h, char* out) {
  auto* d = static_cast<Decoded*>(h);
  memcpy(out, d->refs.data(), d->refs.size());
}

// copies 11 int32 columns (tid,pos,flag,mapq,mtid,mpos,tlen,lclip,
// rclip,nmatch,read_len) and the uint64 hash column
void bam_copy_columns(void* h, int32_t* i32out, uint64_t* hout) {
  auto* d = static_cast<Decoded*>(h);
  memcpy(i32out, d->i32cols.data(), d->i32cols.size() * 4);
  memcpy(hout, d->hashes.data(), d->hashes.size() * 8);
}

void bam_close(void* h) { delete static_cast<Decoded*>(h); }

// ---------- FASTQ ----------
struct FastqDecoded {
  std::vector<int8_t> seq;      // n x max_len
  std::vector<uint8_t> qual;    // n x max_len
  std::vector<int32_t> lens;
  std::vector<uint64_t> hashes;
  std::vector<int32_t> name_off;  // offsets into names blob (n+1)
  std::string names;
  int64_t n = 0;
  int32_t max_len = 0;
};

void* fastq_open(const char* path) {
  std::vector<uint8_t> raw;
  if (!read_file(path, &raw)) return nullptr;
  int8_t enc[256];
  memset(enc, 4, sizeof(enc));
  enc['A'] = enc['a'] = 0; enc['C'] = enc['c'] = 1;
  enc['G'] = enc['g'] = 2; enc['T'] = enc['t'] = 3;

  auto* d = new FastqDecoded();
  // first pass: line index for records + max length
  size_t i = 0, n = raw.size();
  std::vector<std::pair<size_t, size_t>> name_sp, seq_sp, qual_sp;
  int line_in_rec = 0;
  while (i < n) {
    size_t j = i;
    while (j < n && raw[j] != '\n') ++j;
    size_t len = j - i;
    if (len && raw[i + len - 1] == '\r') --len;
    switch (line_in_rec) {
      case 0: name_sp.emplace_back(i, len); break;
      case 1: seq_sp.emplace_back(i, len); break;
      case 3: qual_sp.emplace_back(i, len); break;
    }
    line_in_rec = (line_in_rec + 1) & 3;
    i = j + 1;
  }
  size_t cnt = std::min(name_sp.size(),
                        std::min(seq_sp.size(), qual_sp.size()));
  int32_t maxlen = 1;
  for (size_t r = 0; r < cnt; ++r)
    maxlen = std::max<int32_t>(maxlen, static_cast<int32_t>(seq_sp[r].second));
  d->n = static_cast<int64_t>(cnt);
  d->max_len = maxlen;
  d->seq.assign(cnt * maxlen, 4);
  d->qual.assign(cnt * maxlen, 0);
  d->lens.resize(cnt);
  d->hashes.resize(cnt);
  d->name_off.resize(cnt + 1, 0);
  for (size_t r = 0; r < cnt; ++r) {
    const char* nm = reinterpret_cast<char*>(&raw[name_sp[r].first]);
    size_t nl = name_sp[r].second;
    if (nl && nm[0] == '@') { ++nm; --nl; }
    size_t norm = normalize(nm, nl);
    d->hashes[r] = fnv1a(nm, norm);
    d->names.append(nm, norm);
    d->name_off[r + 1] = static_cast<int32_t>(d->names.size());
    size_t sl = seq_sp[r].second;
    d->lens[r] = static_cast<int32_t>(sl);
    const uint8_t* sp = &raw[seq_sp[r].first];
    int8_t* dst = &d->seq[r * maxlen];
    for (size_t c = 0; c < sl; ++c) dst[c] = enc[sp[c]];
    size_t ql = std::min<size_t>(qual_sp[r].second, sl);
    memcpy(&d->qual[r * maxlen], &raw[qual_sp[r].first], ql);
  }
  return d;
}

// ---- streaming FASTQ scan: name hashes + byte offsets ONLY -----------
// Bounded-memory collect (pipeline/collect.py): the whole-file decode
// above holds every payload; this scan streams the file through a 4MB
// buffer and records, per read, the FNV-1a name hash plus byte offsets
// of the sequence/quality/name regions, so payloads can be gathered
// lazily (mmap) for just the recruited rows. Replaces the reference's
// whole-FASTQ dispatch scan
// (/root/reference/run_multi_threads_discordant.py:141-317).
struct FastqScan {
  int64_t n = 0;
  int32_t max_len = 1;
  std::vector<uint64_t> hashes;
  std::vector<int32_t> lens, name_len;
  std::vector<int64_t> seq_off, qual_off, name_off;
};

void* fastq_scan_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* d = new FastqScan();
  std::vector<uint8_t> buf(1 << 22);
  std::string line;
  int64_t base = 0, line_start = 0;
  int phase = 0;
  auto handle = [&](int64_t start, const std::string& s) {
    size_t len = s.size();
    if (len && s[len - 1] == '\r') --len;
    switch (phase) {
      case 0: {
        const char* nm = s.data();
        size_t nl = len;
        int64_t noff = start;
        if (nl && nm[0] == '@') { ++nm; --nl; ++noff; }
        size_t norm = normalize(nm, nl);
        d->hashes.push_back(fnv1a(nm, norm));
        d->name_off.push_back(noff);
        d->name_len.push_back(static_cast<int32_t>(norm));
        break;
      }
      case 1:
        d->seq_off.push_back(start);
        d->lens.push_back(static_cast<int32_t>(len));
        if (static_cast<int32_t>(len) > d->max_len)
          d->max_len = static_cast<int32_t>(len);
        break;
      case 3:
        d->qual_off.push_back(start);
        break;
    }
    phase = (phase + 1) & 3;
  };
  size_t got;
  while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    size_t i = 0;
    while (i < got) {
      size_t j = i;
      while (j < got && buf[j] != '\n') ++j;
      line.append(reinterpret_cast<char*>(&buf[i]), j - i);
      if (j < got) {
        handle(line_start, line);
        line.clear();
        line_start = base + static_cast<int64_t>(j) + 1;
        i = j + 1;
      } else {
        i = j;
      }
    }
    base += static_cast<int64_t>(got);
  }
  if (!line.empty()) handle(line_start, line);
  fclose(f);
  size_t n = d->hashes.size();
  n = std::min(n, d->lens.size());
  n = std::min(n, d->qual_off.size());
  d->n = static_cast<int64_t>(n);
  return d;
}

int64_t fastq_scan_num(void* h) { return static_cast<FastqScan*>(h)->n; }
int32_t fastq_scan_max_len(void* h) {
  return static_cast<FastqScan*>(h)->max_len;
}

void fastq_scan_copy(void* h, uint64_t* hashes, int32_t* lens,
                     int64_t* seq_off, int64_t* qual_off,
                     int64_t* name_off, int32_t* name_len) {
  auto* d = static_cast<FastqScan*>(h);
  size_t n = static_cast<size_t>(d->n);
  memcpy(hashes, d->hashes.data(), n * 8);
  memcpy(lens, d->lens.data(), n * 4);
  memcpy(seq_off, d->seq_off.data(), n * 8);
  memcpy(qual_off, d->qual_off.data(), n * 8);
  memcpy(name_off, d->name_off.data(), n * 8);
  memcpy(name_len, d->name_len.data(), n * 4);
}

void fastq_scan_close(void* h) { delete static_cast<FastqScan*>(h); }

int64_t fastq_num(void* h) { return static_cast<FastqDecoded*>(h)->n; }
int32_t fastq_max_len(void* h) {
  return static_cast<FastqDecoded*>(h)->max_len;
}
int64_t fastq_names_len(void* h) {
  return static_cast<int64_t>(static_cast<FastqDecoded*>(h)->names.size());
}

void fastq_copy(void* h, int8_t* seq, uint8_t* qual, int32_t* lens,
                uint64_t* hashes, int32_t* name_off, char* names) {
  auto* d = static_cast<FastqDecoded*>(h);
  memcpy(seq, d->seq.data(), d->seq.size());
  memcpy(qual, d->qual.data(), d->qual.size());
  memcpy(lens, d->lens.data(), d->lens.size() * 4);
  memcpy(hashes, d->hashes.data(), d->hashes.size() * 8);
  memcpy(name_off, d->name_off.data(), d->name_off.size() * 4);
  memcpy(names, d->names.data(), d->names.size());
}

void fastq_close(void* h) { delete static_cast<FastqDecoded*>(h); }

// ---------------- writers ----------------
// BAM writer with PARALLEL BGZF deflate: the uncompressed byte stream
// is split into <=64KB segments compressed across threads, then the
// framed blocks are written in order + the fixed EOF block. This is
// the write-side counterpart of bgzf_inflate_all (the reference has no
// BAM writer; samtools sort/view produce its BAMs — here emitting
// standard BAM keeps samtools interop without shelling out).

static const uint8_t kBgzfEof[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
    0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};

static bool bgzf_deflate_write(const std::vector<uint8_t>& payload, FILE* f) {
  constexpr size_t CHUNK = 0xFF00;
  size_t nblocks = (payload.size() + CHUNK - 1) / CHUNK;
  std::vector<std::vector<uint8_t>> blocks(nblocks);
  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 2;
  nthreads = std::min<unsigned>(nthreads, 16);
  nthreads = std::max<unsigned>(1, std::min<size_t>(nthreads, nblocks));
  std::vector<std::thread> threads;
  std::vector<int> ok(nthreads, 1);
  size_t per = nblocks ? (nblocks + nthreads - 1) / nthreads : 0;
  for (unsigned t = 0; t < nthreads && nblocks; ++t) {
    threads.emplace_back([&, t]() {
      for (size_t i = t * per; i < std::min(nblocks, (t + 1) * per); ++i) {
        size_t lo = i * CHUNK;
        size_t len = std::min(CHUNK, payload.size() - lo);
        z_stream zs{};
        if (deflateInit2(&zs, 6, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK) { ok[t] = 0; return; }
        std::vector<uint8_t> cdata(deflateBound(&zs, len) + 1);
        zs.next_in = const_cast<Bytef*>(&payload[lo]);
        zs.avail_in = static_cast<uInt>(len);
        zs.next_out = cdata.data();
        zs.avail_out = static_cast<uInt>(cdata.size());
        int rc = deflate(&zs, Z_FINISH);
        size_t clen = zs.total_out;
        deflateEnd(&zs);
        if (rc != Z_STREAM_END || clen + 26 > 0xFFFF) { ok[t] = 0; return; }
        std::vector<uint8_t>& b = blocks[i];
        uint16_t bsize = static_cast<uint16_t>(clen + 12 + 6 + 8);
        b.resize(18 + clen + 8);
        const uint8_t head[12] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0,
                                  0, 0xff, 6, 0};
        memcpy(b.data(), head, 12);
        b[12] = 'B'; b[13] = 'C'; b[14] = 2; b[15] = 0;
        uint16_t bs1 = bsize - 1;
        memcpy(&b[16], &bs1, 2);
        memcpy(&b[18], cdata.data(), clen);
        uint32_t crc = crc32(0, &payload[lo], static_cast<uInt>(len));
        uint32_t isz = static_cast<uint32_t>(len);
        memcpy(&b[18 + clen], &crc, 4);
        memcpy(&b[18 + clen + 4], &isz, 4);
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int o : ok) if (!o) return false;
  for (auto& b : blocks)
    if (fwrite(b.data(), 1, b.size(), f) != b.size()) return false;
  return fwrite(kBgzfEof, 1, 28, f) == 28;
}

static void put_i32(std::vector<uint8_t>* v, int32_t x) {
  size_t o = v->size();
  v->resize(o + 4);
  memcpy(&(*v)[o], &x, 4);
}

// Columnar BAM writer. names = concatenated name bytes with name_off
// [n+1] offsets; refs = '\n'-joined reference names with ref_lens.
// CIGAR is synthesized from (lclip, rclip, read_len) as
// [lclip S][mid M][rclip S] for mapped records — the inverse of the
// collapsed columns the readers produce. seq: int8 codes [n, stride]
// (0..3 ACGT, else N); qual: phred+33 bytes or null (-> 0xFF missing).
// Returns 1 on success.
int32_t bam_write(const char* path, const char* refs,
                  const int32_t* ref_lens, int32_t n_refs, int64_t n,
                  const char* names, const int32_t* name_off,
                  const int32_t* tid, const int32_t* pos,
                  const int32_t* flag, const int32_t* mapq,
                  const int32_t* mtid, const int32_t* mpos,
                  const int32_t* tlen, const int32_t* lclip,
                  const int32_t* rclip, const int8_t* seq,
                  int32_t seq_stride, const int32_t* lens,
                  const uint8_t* qual) {
  std::vector<uint8_t> out;
  out.reserve(1 << 20);
  // header: magic, SAM text (@SQ lines), reference dictionary
  std::string text;
  {
    const char* p = refs;
    for (int r = 0; r < n_refs; ++r) {
      const char* e = strchr(p, '\n');
      size_t nl = e ? static_cast<size_t>(e - p) : strlen(p);
      text += "@SQ\tSN:" + std::string(p, nl) + "\tLN:" +
              std::to_string(ref_lens[r]) + "\n";
      p += nl + (e ? 1 : 0);
    }
  }
  out.insert(out.end(), {'B', 'A', 'M', 1});
  put_i32(&out, static_cast<int32_t>(text.size()));
  out.insert(out.end(), text.begin(), text.end());
  put_i32(&out, n_refs);
  {
    const char* p = refs;
    for (int r = 0; r < n_refs; ++r) {
      const char* e = strchr(p, '\n');
      size_t nl = e ? static_cast<size_t>(e - p) : strlen(p);
      put_i32(&out, static_cast<int32_t>(nl + 1));
      out.insert(out.end(), p, p + nl);
      out.push_back(0);
      put_i32(&out, ref_lens[r]);
      p += nl + (e ? 1 : 0);
    }
  }
  static const uint8_t nib[5] = {1, 2, 4, 8, 15};  // A C G T N
  for (int64_t i = 0; i < n; ++i) {
    int32_t nm_len = name_off[i + 1] - name_off[i];
    // l_read_name is a uint8 incl. NUL: clamp QNAME to 254 bytes
    // (samtools' limit) instead of silently wrapping the field.
    if (nm_len > 254) nm_len = 254;
    int32_t l_seq = lens[i];
    uint32_t cig[3];
    int n_cig = 0;
    if (!(flag[i] & 4) && l_seq > 0) {
      int32_t mid = l_seq - lclip[i] - rclip[i];
      if (lclip[i] > 0) cig[n_cig++] = (static_cast<uint32_t>(lclip[i]) << 4) | 4;
      if (mid > 0) cig[n_cig++] = (static_cast<uint32_t>(mid) << 4) | 0;
      if (rclip[i] > 0) cig[n_cig++] = (static_cast<uint32_t>(rclip[i]) << 4) | 4;
    }
    int32_t bsz = 32 + (nm_len + 1) + 4 * n_cig + (l_seq + 1) / 2 + l_seq;
    put_i32(&out, bsz);
    put_i32(&out, tid[i]);
    put_i32(&out, pos[i]);
    out.push_back(static_cast<uint8_t>(nm_len + 1));
    out.push_back(static_cast<uint8_t>(mapq[i]));
    out.push_back(0); out.push_back(0);            // bin (unused)
    out.push_back(static_cast<uint8_t>(n_cig)); out.push_back(0);
    uint16_t fl = static_cast<uint16_t>(flag[i]);
    out.push_back(fl & 0xFF); out.push_back(fl >> 8);
    put_i32(&out, l_seq);
    put_i32(&out, mtid[i]);
    put_i32(&out, mpos[i]);
    put_i32(&out, tlen[i]);
    out.insert(out.end(), names + name_off[i], names + name_off[i] + nm_len);
    out.push_back(0);
    for (int c = 0; c < n_cig; ++c) {
      size_t o = out.size();
      out.resize(o + 4);
      memcpy(&out[o], &cig[c], 4);
    }
    const int8_t* s = seq + i * static_cast<int64_t>(seq_stride);
    for (int32_t b = 0; b < l_seq; b += 2) {
      uint8_t hi = nib[(s[b] >= 0 && s[b] < 4) ? s[b] : 4];
      uint8_t lo = 0;
      if (b + 1 < l_seq)
        lo = nib[(s[b + 1] >= 0 && s[b + 1] < 4) ? s[b + 1] : 4];
      out.push_back(static_cast<uint8_t>((hi << 4) | lo));
    }
    if (qual) {
      const uint8_t* q = qual + i * static_cast<int64_t>(seq_stride);
      for (int32_t b = 0; b < l_seq; ++b)
        out.push_back(q[b] >= 33 ? q[b] - 33 : 0xFF);
    } else {
      out.insert(out.end(), l_seq, 0xFF);
    }
  }
  FILE* f = fopen(path, "wb");
  if (!f) return 0;
  bool ok = bgzf_deflate_write(out, f);
  fclose(f);
  return ok ? 1 : 0;
}

// Buffered FASTQ writer: rows selects + orders records; suffix is
// appended to each name (the reference's '<id>_1'/'<id>_2' renaming,
// run_multi_threads_discordant.py:221,296). append != 0 opens in
// append mode (per-gap fastq accumulation). Returns 1 on success.
int32_t fastq_write(const char* path, int32_t append, int64_t n_rows,
                    const int64_t* rows, const char* names,
                    const int32_t* name_off, const char* suffix,
                    const int8_t* seq, int32_t stride,
                    const int32_t* lens, const uint8_t* qual) {
  FILE* f = fopen(path, append ? "ab" : "wb");
  if (!f) return 0;
  static const char dec[5] = {'A', 'C', 'G', 'T', 'N'};
  size_t suf_len = strlen(suffix);
  std::string buf;
  buf.reserve(1 << 22);
  std::string sline;
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t i = rows ? rows[r] : r;
    int32_t ln = lens[i];
    buf.push_back('@');
    buf.append(names + name_off[i], names + name_off[i + 1]);
    buf.append(suffix, suf_len);
    buf.push_back('\n');
    const int8_t* s = seq + i * static_cast<int64_t>(stride);
    sline.resize(ln);
    for (int32_t b = 0; b < ln; ++b)
      sline[b] = dec[(s[b] >= 0 && s[b] < 4) ? s[b] : 4];
    buf += sline;
    buf.append("\n+\n", 3);
    if (qual) {
      buf.append(reinterpret_cast<const char*>(
                     qual + i * static_cast<int64_t>(stride)),
                 ln);
    } else {
      buf.append(ln, '5');
    }
    buf.push_back('\n');
    if (buf.size() >= (1 << 22)) {
      if (fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
        fclose(f);
        return 0;
      }
      buf.clear();
    }
  }
  bool ok = fwrite(buf.data(), 1, buf.size(), f) == buf.size();
  fclose(f);
  return ok ? 1 : 0;
}

}  // extern "C"
