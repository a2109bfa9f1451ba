// Buffered FASTA/FASTQ reader reproducing the exact character-level
// semantics of the *old* kseq the reference vendors
// (behavioral spec: src/kseq.h:170-208):
//   - skip bytes until a '>'/'@' CHARACTER (anywhere, not just line starts);
//   - name to the first whitespace; comment is the rest of that line;
//   - sequence bytes until the next '>'/'+'/'@' character anywhere,
//     keeping only isgraph() bytes (33..126);
//   - '+' opens a quality block: skip the rest of the '+' line, then bytes
//     33..127 count toward the quality until it reaches the sequence
//     length, after which exactly one extra byte is consumed;
//   - truncated '+'-line or quality (EOF first) is kseq's -2: the stream
//     ends there, like the reference CLI's `while (kseq_read >= 0)` loop.
// Gzip input through zlib like the reference's KSEQ_INIT(gzFile, gzread).
//
// Batch-oriented C ABI: records stream into one arena per batch so Python
// pays one ctypes round-trip per thousands of records.

#include <zlib.h>

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
    gzFile gz = nullptr;
    std::string buf;
    size_t pos = 0;
    bool eof = false;
    int last_char = 0;   // kseq's pending header char
    bool done = false;   // kseq returned -1/-2

    // batch arena
    std::string arena;                 // name|comment|seq|qual packed
    std::vector<int64_t> offsets;      // 8 per record: off/len x 4 fields
    int64_t n_records = 0;

    bool fill() {
        if (pos < buf.size()) return true;
        if (eof) return false;
        buf.resize(1 << 16);
        int got = gzread(gz, &buf[0], int(buf.size()));
        if (got <= 0) {
            eof = true;
            buf.clear();
            pos = 0;
            return false;
        }
        buf.resize(size_t(got));
        pos = 0;
        return true;
    }

    int getc() {
        if (!fill()) return -1;
        return (unsigned char)buf[pos++];
    }
};

void push_field(Reader* r, const std::string& s) {
    r->offsets.push_back(int64_t(r->arena.size()));
    r->offsets.push_back(int64_t(s.size()));
    r->arena.append(s);
}

// read one record into the arena; returns false when the stream is done
bool next_record(Reader* r) {
    if (r->done) return false;
    int c;
    if (r->last_char == 0) {  // scan to the next header char, anywhere
        while ((c = r->getc()) != -1 && c != '>' && c != '@') {}
        if (c == -1) { r->done = true; return false; }
        r->last_char = c;
    }
    r->last_char = 0;
    // name: to first whitespace (kseq returns -1 when EOF follows the
    // header char immediately -> no record)
    std::string name, comment, seq, qual;
    int stop = 0;
    while ((c = r->getc()) != -1) {
        if (std::isspace(c)) { stop = c; break; }
        name.push_back(char(c));
    }
    if (c == -1 && name.empty()) { r->done = true; return false; }
    if (c != -1 && stop != '\n') {  // comment: rest of the line, incl. any
        // trailing '\r' — the vendored old kseq stops at the literal '\n'
        // and does not strip CR (ref: src/kseq.h:108,180)
        while ((c = r->getc()) != -1 && c != '\n')
            comment.push_back(char(c));
    }
    // sequence: until '>'/'+'/'@' anywhere; keep isgraph() only
    int term = -1;
    while ((c = r->getc()) != -1) {
        if (c == '>' || c == '+' || c == '@') { term = c; break; }
        if (c >= 33 && c <= 126) seq.push_back(char(c));
    }
    if (term == '>' || term == '@') r->last_char = term;
    bool has_qual = false;
    if (term == '+') {
        // skip the rest of the '+' line; EOF here is kseq's -2
        while ((c = r->getc()) != -1 && c != '\n') {}
        if (c == -1) { r->done = true; return false; }
        // quality: bytes 33..127 count until seq length, then the loop's
        // final iteration consumes one extra byte
        while ((c = r->getc()) != -1 && qual.size() < seq.size())
            if (c >= 33 && c <= 127) qual.push_back(char(c));
        if (qual.size() != seq.size()) { r->done = true; return false; }
        has_qual = true;
    } else if (term == -1) {
        r->done = true;  // final FASTA record, then EOF
    }
    push_field(r, name);
    push_field(r, comment);
    push_field(r, seq);
    if (has_qual) {
        push_field(r, qual);
    } else {
        r->offsets.push_back(-1);  // qual absent marker
        r->offsets.push_back(0);
    }
    ++r->n_records;
    return true;
}

}  // namespace

extern "C" {

void* sswtpu_fastx_open(const char* path) {
    gzFile gz = gzopen(path, "rb");
    if (!gz) return nullptr;
    gzbuffer(gz, 1 << 20);
    Reader* r = new Reader();
    r->gz = gz;
    return r;
}

// Parse up to max_records; returns number parsed (0 = EOF).  The arena and
// offsets stay valid until the next call on this handle.
int64_t sswtpu_fastx_batch(void* h, int64_t max_records) {
    Reader* r = static_cast<Reader*>(h);
    r->arena.clear();
    r->offsets.clear();
    r->n_records = 0;
    while (r->n_records < max_records) {
        if (!next_record(r)) break;
    }
    return r->n_records;
}

const char* sswtpu_fastx_arena(void* h) {
    return static_cast<Reader*>(h)->arena.data();
}

int64_t sswtpu_fastx_arena_size(void* h) {
    return int64_t(static_cast<Reader*>(h)->arena.size());
}

const int64_t* sswtpu_fastx_offsets(void* h) {
    return static_cast<Reader*>(h)->offsets.data();
}

void sswtpu_fastx_close(void* h) {
    Reader* r = static_cast<Reader*>(h);
    if (r->gz) gzclose(r->gz);
    delete r;
}

}  // extern "C"
