// Native read-ingest hot loop: FASTA block parsing, batched MD5 dedup
// keys, and padded-matrix fill.
//
// The reference streams reads one at a time through FASTAPointer and
// hashes each with java.security.MessageDigest
// (PlacementProcess.java:568-596) -- fine at its ~500 reads/s; at the
// 1M reads/s device rate every per-read python byte-op in the host loop
// is the whole budget (VERDICT r3 item 6).  Here a whole ~8 MB block of
// records is parsed in one call and the per-read python work shrinks to
// dict bookkeeping.
//
// MD5 is the RFC 1321 algorithm (public domain reference construction);
// the digest must be md5 exactly because the dedup key semantics are
// part of the reference's observable behavior (identical reads join an
// "nm" list in first-occurrence order, duplicates of unplaced reads are
// re-listed per occurrence).  Gap characters '-' are stripped before
// hashing, matching Fasta.java:34-39 (getSequence(true)).
//
// Layout contract (shared with rappas_tpu_torch.native.parse_fasta_block):
//   ig_count(data, n)          -> record count (lines starting '>')
//   ig_parse(data, n, ...)     -> header/sequence byte buffers + int64
//                                 offsets; multi-line sequences are
//                                 compacted; '\r' and '#' comment lines
//                                 are tolerated; returns 0 on success
//   ig_md5(seq_buf, off, n, out) -> 16 bytes per record, '-' stripped
//   ig_fill(seq_buf, off, idx, nidx, L, mat) -> mat[i,:len]=seq, pad 0xFF

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------- //
// MD5 (RFC 1321)
// ---------------------------------------------------------------- //

struct MD5 {
    uint32_t a0 = 0x67452301, b0 = 0xefcdab89,
             c0 = 0x98badcfe, d0 = 0x10325476;
    uint64_t total = 0;
    unsigned char buf[64];
    int buflen = 0;

    static uint32_t rotl(uint32_t x, int c) {
        return (x << c) | (x >> (32 - c));
    }

    void block(const unsigned char* p) {
        static const uint32_t K[64] = {
            0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf,
            0x4787c62a, 0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af,
            0xffff5bb1, 0x895cd7be, 0x6b901122, 0xfd987193, 0xa679438e,
            0x49b40821, 0xf61e2562, 0xc040b340, 0x265e5a51, 0xe9b6c7aa,
            0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8, 0x21e1cde6,
            0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
            0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122,
            0xfde5380c, 0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70,
            0x289b7ec6, 0xeaa127fa, 0xd4ef3085, 0x04881d05, 0xd9d4d039,
            0xe6db99e5, 0x1fa27cf8, 0xc4ac5665, 0xf4292244, 0x432aff97,
            0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92, 0xffeff47d,
            0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
            0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
        static const int S[64] = {
            7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
            5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20,
            4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
            6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};
        uint32_t M[16];
        for (int i = 0; i < 16; i++)
            std::memcpy(&M[i], p + 4 * i, 4);   // little-endian hosts
        uint32_t A = a0, B = b0, C = c0, D = d0;
        for (int i = 0; i < 64; i++) {
            uint32_t F;
            int g;
            if (i < 16)      { F = (B & C) | (~B & D); g = i; }
            else if (i < 32) { F = (D & B) | (~D & C); g = (5 * i + 1) & 15; }
            else if (i < 48) { F = B ^ C ^ D;          g = (3 * i + 5) & 15; }
            else             { F = C ^ (B | ~D);       g = (7 * i) & 15; }
            F += A + K[i] + M[g];
            A = D; D = C; C = B;
            B += rotl(F, S[i]);
        }
        a0 += A; b0 += B; c0 += C; d0 += D;
    }

    void update(const unsigned char* p, int64_t n) {
        total += n;
        if (buflen) {
            while (n > 0 && buflen < 64) { buf[buflen++] = *p++; n--; }
            if (buflen == 64) { block(buf); buflen = 0; }
        }
        while (n >= 64) { block(p); p += 64; n -= 64; }
        while (n > 0) { buf[buflen++] = *p++; n--; }
    }

    void final(unsigned char* out) {
        uint64_t bits = total * 8;
        unsigned char pad = 0x80;
        update(&pad, 1);
        unsigned char zero = 0;
        while (buflen != 56) update(&zero, 1);
        total = 0;  // length bytes must not re-count
        unsigned char lenb[8];
        std::memcpy(lenb, &bits, 8);
        update(lenb, 8);
        std::memcpy(out + 0, &a0, 4);
        std::memcpy(out + 4, &b0, 4);
        std::memcpy(out + 8, &c0, 4);
        std::memcpy(out + 12, &d0, 4);
    }
};

}  // namespace

extern "C" {

long long ig_count(const char* data, long long n) {
    long long cnt = 0;
    long long i = 0;
    while (i < n) {
        if (data[i] == '>') cnt++;
        const char* nl = static_cast<const char*>(
            std::memchr(data + i, '\n', n - i));
        if (!nl) break;
        i = (nl - data) + 1;
    }
    return cnt;
}

// Parse a block of complete FASTA records.  hdr/seq buffers must hold
// at least n bytes each (the block itself is an upper bound); offset
// arrays hold nrec+1 int64.  Returns the record count actually parsed
// (may be < nrec if the block is malformed), or -1 on overflow.
long long ig_parse(const char* data, long long n,
                   char* hdr_buf, long long* hdr_off,
                   char* seq_buf, long long* seq_off,
                   long long nrec) {
    long long r = -1;                 // current record
    long long hp = 0, sp = 0;
    long long i = 0;
    while (i < n) {
        const char* nl = static_cast<const char*>(
            std::memchr(data + i, '\n', n - i));
        long long eol = nl ? nl - data : n;
        long long end = eol;
        if (end > i && data[end - 1] == '\r') end--;
        if (end > i && data[i] == '>') {
            if (r + 1 >= nrec) return -1;
            r++;
            hdr_off[r] = hp;
            seq_off[r] = sp;
            std::memcpy(hdr_buf + hp, data + i + 1, end - i - 1);
            hp += end - i - 1;
        } else if (end > i && data[i] != '#' && r >= 0) {
            std::memcpy(seq_buf + sp, data + i, end - i);
            sp += end - i;
        }
        i = eol + 1;
    }
    hdr_off[r + 1] = hp;
    seq_off[r + 1] = sp;
    return r + 1;
}

// 16-byte MD5 per record over seq bytes with '-' stripped.
void ig_md5(const char* seq_buf, const long long* seq_off,
            long long nrec, unsigned char* out) {
    for (long long r = 0; r < nrec; r++) {
        const char* p = seq_buf + seq_off[r];
        long long len = seq_off[r + 1] - seq_off[r];
        MD5 h;
        long long run = 0;
        for (long long j = 0; j < len; j++) {
            if (p[j] == '-') {
                if (run) h.update(
                    reinterpret_cast<const unsigned char*>(p + j - run),
                    run);
                run = 0;
            } else {
                run++;
            }
        }
        if (run) h.update(
            reinterpret_cast<const unsigned char*>(p + len - run), run);
        h.final(out + 16 * r);
    }
}

// Padded uint8 matrix fill: mat[i, :len(idx[i])] = seq bytes, rest 0xFF.
void ig_fill(const char* seq_buf, const long long* seq_off,
             const long long* idx, long long nidx,
             long long L, unsigned char* mat) {
    for (long long i = 0; i < nidx; i++) {
        long long r = idx[i];
        long long len = seq_off[r + 1] - seq_off[r];
        if (len > L) len = L;
        std::memcpy(mat + i * L, seq_buf + seq_off[r], len);
        std::memset(mat + i * L + len, 0xFF, L - len);
    }
}

}  // extern "C"

// ---------------------------------------------------------------- //
// dedup map: md5 digest -> first-occurrence order
// ---------------------------------------------------------------- //

#include <unordered_map>

namespace {

struct K128 {
    uint64_t a, b;
    bool operator==(const K128& o) const { return a == o.a && b == o.b; }
};

struct K128Hash {
    size_t operator()(const K128& k) const {
        // md5 output is already uniform; fold the halves
        return static_cast<size_t>(k.a ^ (k.b * 0x9e3779b97f4a7c15ULL));
    }
};

using DedupMap = std::unordered_map<K128, long long, K128Hash>;

}  // namespace

extern "C" {

void* dd_new() { return new DedupMap(); }

void dd_free(void* p) { delete static_cast<DedupMap*>(p); }

// For each digest: emplace (digest -> orders[i]) if unseen and write
// -1 (fresh); else write the stored first-occurrence order.
void dd_lookup(void* p, const unsigned char* md5s, long long n,
               const long long* orders, long long* out_first) {
    auto* m = static_cast<DedupMap*>(p);
    for (long long i = 0; i < n; i++) {
        K128 k;
        std::memcpy(&k.a, md5s + 16 * i, 8);
        std::memcpy(&k.b, md5s + 16 * i + 8, 8);
        auto r = m->try_emplace(k, orders[i]);
        out_first[i] = r.second ? -1 : r.first->second;
    }
}

}  // extern "C"
