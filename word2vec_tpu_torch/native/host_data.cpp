// Native host-side data layer (copy of word2vec_tpu/native/host_data.cpp
// for the PyTorch port).
//
// Equivalent of the reference's C++ data layer (main.cpp:63-92 text8
// reader, Word2Vec.cpp:132-169 vocab count, Word2Vec.cpp:212-230
// string->index encoding), redesigned for a streaming, array-oriented host:
// the host's only jobs are (a) counting words, (b) turning the corpus into
// one flat int32 id stream, (c) filling fixed-shape [B, L] batch buffers.
// Everything else lives on the device.
//
// Exposed as a plain C ABI consumed via ctypes
// (word2vec_tpu_torch/native/__init__.py); the Python implementations
// remain as always-available fallbacks.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC host_data.cpp -o libw2vhost.so
// (the loader builds it into build/native/ under a name keyed by a hash of
// this file).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline uint64_t hash_bytes(const char* s, size_t n) {
    // FNV-1a
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < n; ++i) {
        h ^= (unsigned char)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

// Open-addressing (linear probe) map from byte-string -> int64 value.
// Keys point into an arena or into the mmap'd corpus; the map never owns them.
struct StrMap {
    struct Ent {
        const char* p = nullptr;
        uint32_t len = 0;
        int64_t val = 0;
    };
    std::vector<Ent> slots;
    size_t mask = 0;
    size_t used = 0;

    explicit StrMap(size_t expected) {
        size_t cap = 64;
        while (cap < expected * 2) cap <<= 1;
        slots.resize(cap);
        mask = cap - 1;
    }

    void grow() {
        std::vector<Ent> old = std::move(slots);
        slots.clear();
        slots.resize(old.size() * 2);
        mask = slots.size() - 1;
        used = 0;
        for (const Ent& e : old)
            if (e.p) *insert_slot(e.p, e.len) = e;
    }

    Ent* insert_slot(const char* p, uint32_t len) {
        size_t i = hash_bytes(p, len) & mask;
        while (slots[i].p) {
            if (slots[i].len == len && memcmp(slots[i].p, p, len) == 0)
                return &slots[i];
            i = (i + 1) & mask;
        }
        ++used;
        slots[i].p = p;
        slots[i].len = len;
        return &slots[i];
    }

    // Returns slot for key, inserting with val=0 if absent. May grow.
    Ent* upsert(const char* p, uint32_t len) {
        if (used * 3 > slots.size() * 2) grow();
        return insert_slot(p, len);
    }

    const Ent* lookup(const char* p, uint32_t len) const {
        size_t i = hash_bytes(p, len) & mask;
        while (slots[i].p) {
            if (slots[i].len == len && memcmp(slots[i].p, p, len) == 0)
                return &slots[i];
            i = (i + 1) & mask;
        }
        return nullptr;
    }
};

struct MappedFile {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool mapped = false;
    std::vector<char> fallback;

    bool open(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0) {
            ::close(fd);
            return false;
        }
        size = (size_t)st.st_size;
        if (size == 0) {
            data = "";
            return true;
        }
        void* m = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (m != MAP_FAILED) {
            data = (const char*)m;
            mapped = true;
            madvise(m, size, MADV_SEQUENTIAL);
            return true;
        }
        fallback.resize(size);
        ssize_t got = pread(fd, fallback.data(), size, 0);
        if ((size_t)got != size) {
            ::close(fd);
            return false;
        }
        data = fallback.data();
        return true;
    }

    ~MappedFile() {
        if (mapped) munmap((void*)data, size);
        if (fd >= 0) ::close(fd);
    }
};

inline bool is_space(char c) {
    return c == ' ' || c == '\n' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

struct Counter {
    // words stored contiguously in an arena; entries reference it
    std::vector<char> arena;
    struct Word {
        size_t ofs;
        uint32_t len;
        int64_t count;
    };
    std::vector<Word> words;
    long long total = 0;
};

struct VocabHandle {
    std::vector<char> arena;
    StrMap map;
    explicit VocabHandle(size_t n) : map(n) {}
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- counting
// Tokenize `path` by whitespace and count distinct words.
// Returns an opaque Counter*, or nullptr on I/O error.
void* w2v_count_file(const char* path) {
    MappedFile f;
    if (!f.open(path)) return nullptr;

    // First pass: count with keys pointing into the mmap.
    StrMap map(1 << 16);
    const char* p = f.data;
    const char* end = f.data + f.size;
    long long total = 0;
    while (p < end) {
        while (p < end && is_space(*p)) ++p;
        const char* w = p;
        while (p < end && !is_space(*p)) ++p;
        if (p > w) {
            map.upsert(w, (uint32_t)(p - w))->val += 1;
            ++total;
        }
    }

    // Copy surviving keys into an arena that outlives the mmap.
    Counter* c = new Counter();
    c->total = total;
    size_t bytes = 0;
    for (const auto& e : map.slots)
        if (e.p) bytes += e.len;
    c->arena.resize(bytes);
    size_t ofs = 0;
    for (const auto& e : map.slots) {
        if (!e.p) continue;
        memcpy(c->arena.data() + ofs, e.p, e.len);
        c->words.push_back({ofs, e.len, e.val});
        ofs += e.len;
    }
    return c;
}

long long w2v_counter_size(void* h) { return (long long)((Counter*)h)->words.size(); }
long long w2v_counter_total(void* h) { return ((Counter*)h)->total; }

// Copy entry i's word bytes into buf (cap bytes incl. NUL); returns count,
// or -1 if i out of range / buf too small.
long long w2v_counter_entry(void* h, long long i, char* buf, long long cap) {
    Counter* c = (Counter*)h;
    if (i < 0 || (size_t)i >= c->words.size()) return -1;
    const Counter::Word& w = c->words[(size_t)i];
    if ((long long)w.len + 1 > cap) return -1;
    memcpy(buf, c->arena.data() + w.ofs, w.len);
    buf[w.len] = '\0';
    return w.count;
}

void w2v_counter_free(void* h) { delete (Counter*)h; }

// ----------------------------------------------------------------- vocab
// Build a word->id lookup from `n` NUL-terminated words (id = position).
void* w2v_vocab_create(const char** words, long long n) {
    VocabHandle* v = new VocabHandle((size_t)n);
    size_t bytes = 0;
    for (long long i = 0; i < n; ++i) bytes += strlen(words[i]);
    v->arena.resize(bytes);
    size_t ofs = 0;
    for (long long i = 0; i < n; ++i) {
        size_t len = strlen(words[i]);
        memcpy(v->arena.data() + ofs, words[i], len);
        auto* e = v->map.upsert(v->arena.data() + ofs, (uint32_t)len);
        e->val = i;
        ofs += len;
    }
    return v;
}

void w2v_vocab_free(void* h) { delete (VocabHandle*)h; }

// ----------------------------------------------------------------- encode
// Stream-tokenize `path`, mapping tokens to int32 ids (OOV dropped, matching
// Word2Vec.cpp:223). mode 0: plain stream (text8); mode 1: emit -1 at each
// newline run (line_docs sentence boundary, Word2Vec.cpp:19-30).
// Writes at most `cap` ids to `out`; returns number written, or -1 on error.
long long w2v_encode_file(const char* path, void* vocab, int mode,
                          int32_t* out, long long cap) {
    VocabHandle* v = (VocabHandle*)vocab;
    MappedFile f;
    if (!f.open(path)) return -1;
    const char* p = f.data;
    const char* end = f.data + f.size;
    long long n = 0;
    bool pending_break = false;
    while (p < end) {
        while (p < end && is_space(*p)) {
            if (mode == 1 && *p == '\n') pending_break = true;
            ++p;
        }
        const char* w = p;
        while (p < end && !is_space(*p)) ++p;
        if (p > w) {
            if (pending_break && n > 0 && n < cap) out[n++] = -1;
            pending_break = false;
            const auto* e = v->map.lookup(w, (uint32_t)(p - w));
            if (e) {
                if (n >= cap) return n;  // caller sized the buffer; stop clean
                out[n++] = (int32_t)e->val;
            }
        }
    }
    return n;
}

// ------------------------------------------------------------- batch fill
// Fill a [B, L] int32 batch (pad -1) from the packed corpus
// (flat ids + row table) following `order[pos : pos+B]`. Rows past the end
// of `order` stay fully padded. Returns the number of real tokens written.
long long w2v_fill_batch(const int32_t* flat, const int64_t* starts,
                         const int32_t* lens, const int64_t* order,
                         long long num_rows, long long pos, long long B,
                         long long L, int32_t* out) {
    long long words = 0;
    for (long long r = 0; r < B; ++r) {
        int32_t* dst = out + r * L;
        long long oi = pos + r;
        if (oi >= num_rows) {
            for (long long j = 0; j < L; ++j) dst[j] = -1;
            continue;
        }
        int64_t row = order[oi];
        int64_t s = starts[row];
        int32_t n = lens[row];
        if (n > L) n = (int32_t)L;
        memcpy(dst, flat + s, (size_t)n * sizeof(int32_t));
        for (long long j = n; j < L; ++j) dst[j] = -1;
        words += n;
    }
    return words;
}

}  // extern "C"
