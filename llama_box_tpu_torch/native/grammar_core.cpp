// GBNF pushdown-matcher core (counterpart of native/grammar_core.cpp in
// the JAX package; the reference's grammar engine is llama.cpp C++). This
// is the host hot path when grammar-constrained sampling scans token
// candidates. Exact-semantics mirror of the pure-Python matcher in
// llama_box_tpu_torch/grammar.py: state = set of stacks of (rule, alt,
// item) frames, normalized so every top item is a char matcher; partial
// UTF-8 held across token boundaries with reachable-range checking
// (llama.cpp partial_utf8).
//
// Serialized grammar format (int32 stream, see grammar.py _serialize):
//   [n_rules] then per rule: [n_alts] per alt: [n_items] per item:
//     [0, rule_id]                                   (ref)
//     [1, negated, n_ranges, lo0, hi0, lo1, hi1 ...] (char)
//
// Built at first use into build/torch_native/ by gguf/native.py (plain
// C interface, loaded with ctypes). The Python matcher is its plain
// version, held against it by the tests.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <set>
#include <string>
#include <vector>

namespace {

struct CharItem {
    int32_t negated;
    std::vector<std::pair<int32_t, int32_t>> ranges;         // as written
    std::vector<std::pair<int32_t, int32_t>> sorted_ranges;  // by lo
};

struct Item {
    int32_t kind;  // 0 = ref, 1 = char
    int32_t ref;   // rule id (kind 0)
    int32_t chr;   // index into Gram::chars (kind 1)
};

struct Gram {
    std::vector<std::vector<std::vector<Item>>> rules;  // [rule][alt][item]
    std::vector<CharItem> chars;
    int32_t root;
};

struct Frame {
    int32_t r, a, i;
    bool operator<(const Frame& o) const {
        if (r != o.r) return r < o.r;
        if (a != o.a) return a < o.a;
        return i < o.i;
    }
    bool operator==(const Frame& o) const {
        return r == o.r && a == o.a && i == o.i;
    }
};

using Stack = std::vector<Frame>;
using StackSet = std::set<Stack>;

struct State {
    StackSet stacks;
    std::string pending;  // partial UTF-8 tail
};

bool char_match(const CharItem& c, int32_t cp) {
    bool hit = false;
    for (auto& r : c.ranges)
        if (r.first <= cp && cp <= r.second) { hit = true; break; }
    return hit != (c.negated != 0);
}

// could ANY codepoint in [lo, hi] match? (partial UTF-8 tails)
bool char_match_range(const CharItem& c, int32_t lo, int32_t hi) {
    if (!c.negated) {
        for (auto& r : c.ranges)
            if (r.first <= hi && lo <= r.second) return true;
        return false;
    }
    int64_t cur = lo;
    for (auto& r : c.sorted_ranges) {
        if (r.first > cur) break;
        cur = std::max<int64_t>(cur, (int64_t)r.second + 1);
        if (cur > hi) return false;
    }
    return true;
}

// expand refs / pop completed frames until the top item is a char
// matcher (empty stack = accept); branches over ref alternates
void normalize(const Gram& g, Stack stack, StackSet& out, int depth) {
    if (depth > 256) return;  // matches the Python nesting guard
    for (;;) {
        if (stack.empty()) { out.insert(stack); return; }
        Frame& top = stack.back();
        const auto& seq = g.rules[top.r][top.a];
        if (top.i >= (int32_t)seq.size()) {
            stack.pop_back();
            if (!stack.empty()) stack.back().i += 1;
            continue;
        }
        const Item& item = seq[top.i];
        if (item.kind == 1) { out.insert(stack); return; }
        int32_t tgt = item.ref;
        for (int32_t a = 0; a < (int32_t)g.rules[tgt].size(); a++) {
            Stack ns = stack;
            ns.push_back(Frame{tgt, a, 0});
            normalize(g, std::move(ns), out, depth + 1);
        }
        return;
    }
}

StackSet advance(const Gram& g, const StackSet& stacks, int32_t cp) {
    StackSet out;
    for (const auto& stack : stacks) {
        if (stack.empty()) continue;  // complete; cannot consume more
        const Frame& top = stack.back();
        const Item& item = g.rules[top.r][top.a][top.i];
        if (item.kind == 1 && char_match(g.chars[item.chr], cp)) {
            Stack ns = stack;
            ns.back().i += 1;
            normalize(g, std::move(ns), out, 0);
        }
    }
    return out;
}

// codepoint range reachable by completing partial sequence `tail`
void utf8_partial_range(const uint8_t* tail, int64_t ntail, int ln,
                        int32_t* lo, int32_t* hi) {
    static const int32_t mask[5] = {0, 0, 0x1F, 0x0F, 0x07};
    static const int32_t min_cp[5] = {0, 0, 0x80, 0x800, 0x10000};
    int64_t v = tail[0] & mask[ln];
    for (int64_t i = 1; i < ntail; i++) v = (v << 6) | (tail[i] & 0x3F);
    int rem = ln - (int)ntail;
    int64_t l = v << (6 * rem);
    int64_t h = ((v + 1) << (6 * rem)) - 1;
    if (l < min_cp[ln]) l = min_cp[ln];
    if (h > 0x10FFFF) h = 0x10FFFF;
    *lo = (int32_t)l;
    *hi = (int32_t)h;
}

// mirror of Grammar.accept_bytes: advance over UTF-8 bytes, holding a
// partial trailing sequence; returns false on any mismatch (state may
// be partially advanced then, exactly like the Python matcher — callers
// validate on a copy first)
bool accept_bytes(const Gram& g, State& st, const uint8_t* data,
                  int64_t n) {
    std::string buf = st.pending;
    buf.append((const char*)data, (size_t)n);
    size_t i = 0, len = buf.size();
    while (i < len) {
        uint8_t b0 = (uint8_t)buf[i];
        int ln;
        if (b0 < 0x80) ln = 1;
        else if (b0 < 0xC0) return false;  // stray continuation
        else if (b0 < 0xE0) ln = 2;
        else if (b0 < 0xF0) ln = 3;
        else if (b0 < 0xF8) ln = 4;
        else return false;
        if (i + (size_t)ln > len) {
            for (size_t j = i + 1; j < len; j++) {
                uint8_t b = (uint8_t)buf[j];
                if (b < 0x80 || b >= 0xC0) return false;
            }
            int32_t lo, hi;
            utf8_partial_range((const uint8_t*)buf.data() + i,
                               (int64_t)(len - i), ln, &lo, &hi);
            bool ok = false;
            for (const auto& stack : st.stacks) {
                if (stack.empty()) continue;
                const Frame& top = stack.back();
                const Item& item = g.rules[top.r][top.a][top.i];
                if (item.kind == 1
                        && char_match_range(g.chars[item.chr], lo, hi)) {
                    ok = true;
                    break;
                }
            }
            if (!ok) return false;
            break;
        }
        // decode (validate continuations + overlong + surrogates like
        // Python's utf-8 decode)
        int32_t cp;
        if (ln == 1) {
            cp = b0;
        } else {
            static const int32_t mask[5] = {0, 0, 0x1F, 0x0F, 0x07};
            static const int32_t min_cp[5] = {0, 0, 0x80, 0x800, 0x10000};
            cp = b0 & mask[ln];
            for (int k = 1; k < ln; k++) {
                uint8_t b = (uint8_t)buf[i + k];
                if (b < 0x80 || b >= 0xC0) return false;
                cp = (cp << 6) | (b & 0x3F);
            }
            if (cp < min_cp[ln] || cp > 0x10FFFF) return false;
            if (cp >= 0xD800 && cp <= 0xDFFF) return false;
        }
        StackSet ns = advance(g, st.stacks, cp);
        if (ns.empty()) return false;
        st.stacks = std::move(ns);
        i += (size_t)ln;
    }
    st.pending = buf.substr(i);
    return true;
}

}  // namespace

extern "C" {

void* lbox_gram_new(const int32_t* buf, int64_t n, int32_t root) {
    auto* g = new Gram();
    g->root = root;
    int64_t p = 0;
    if (p >= n) { delete g; return nullptr; }
    int32_t n_rules = buf[p++];
    g->rules.resize(n_rules);
    for (int32_t r = 0; r < n_rules; r++) {
        if (p >= n) { delete g; return nullptr; }
        int32_t n_alts = buf[p++];
        g->rules[r].resize(n_alts);
        for (int32_t a = 0; a < n_alts; a++) {
            if (p >= n) { delete g; return nullptr; }
            int32_t n_items = buf[p++];
            auto& seq = g->rules[r][a];
            seq.reserve(n_items);
            for (int32_t it = 0; it < n_items; it++) {
                if (p >= n) { delete g; return nullptr; }
                int32_t kind = buf[p++];
                Item item{};
                item.kind = kind;
                if (kind == 0) {
                    if (p >= n) { delete g; return nullptr; }
                    item.ref = buf[p++];
                } else {
                    if (p + 2 > n) { delete g; return nullptr; }
                    CharItem c;
                    c.negated = buf[p++];
                    int32_t nr = buf[p++];
                    if (p + 2 * (int64_t)nr > n) { delete g; return nullptr; }
                    for (int32_t k = 0; k < nr; k++) {
                        c.ranges.emplace_back(buf[p], buf[p + 1]);
                        p += 2;
                    }
                    c.sorted_ranges = c.ranges;
                    std::sort(c.sorted_ranges.begin(),
                              c.sorted_ranges.end());
                    item.chr = (int32_t)g->chars.size();
                    g->chars.push_back(std::move(c));
                }
                seq.push_back(item);
            }
        }
    }
    return g;
}

void lbox_gram_free(void* gp) { delete (Gram*)gp; }

void* lbox_gram_state_new(void* gp) {
    auto* g = (Gram*)gp;
    auto* st = new State();
    for (int32_t a = 0; a < (int32_t)g->rules[g->root].size(); a++)
        normalize(*g, Stack{Frame{g->root, a, 0}}, st->stacks, 0);
    return st;
}

void* lbox_gram_state_copy(void* sp) { return new State(*(State*)sp); }

void lbox_gram_state_free(void* sp) { delete (State*)sp; }

int lbox_gram_accept_bytes(void* gp, void* sp, const uint8_t* data,
                           int64_t n) {
    return accept_bytes(*(Gram*)gp, *(State*)sp, data, n) ? 1 : 0;
}

int lbox_gram_try_bytes(void* gp, void* sp, const uint8_t* data,
                        int64_t n) {
    State tmp = *(State*)sp;
    return accept_bytes(*(Gram*)gp, tmp, data, n) ? 1 : 0;
}

int lbox_gram_completed(void* sp) {
    for (const auto& s : ((State*)sp)->stacks)
        if (s.empty()) return 1;
    return 0;
}

int lbox_gram_must_stop(void* sp) {
    for (const auto& s : ((State*)sp)->stacks)
        if (!s.empty()) return 0;
    return 1;
}

// batched accepts_token over candidate pieces (one ctypes crossing for
// the whole candidate list — the full-vocab fallback scan's hot path)
void lbox_gram_filter(void* gp, void* sp, const uint8_t* pieces,
                      const int64_t* offs, int64_t n_tok, uint8_t* out) {
    auto* g = (Gram*)gp;
    auto* st = (State*)sp;
    for (int64_t t = 0; t < n_tok; t++) {
        State tmp = *st;
        out[t] = accept_bytes(*g, tmp, pieces + offs[t],
                              offs[t + 1] - offs[t])
                 ? 1 : 0;
    }
}

// serialized signature of a state (stack frames + pending bytes) for
// host-side caching keys; returns bytes written, or -cap_needed if the
// buffer is too small
int64_t lbox_gram_state_sig(void* sp, uint8_t* out, int64_t cap) {
    auto* st = (State*)sp;
    int64_t need = 8;
    for (const auto& s : st->stacks) need += 8 + 12 * (int64_t)s.size();
    need += 8 + (int64_t)st->pending.size();
    if (need > cap) return -need;
    int64_t p = 0;
    auto w64 = [&](int64_t v) { std::memcpy(out + p, &v, 8); p += 8; };
    auto w32 = [&](int32_t v) { std::memcpy(out + p, &v, 4); p += 4; };
    w64((int64_t)st->stacks.size());
    for (const auto& s : st->stacks) {
        w64((int64_t)s.size());
        for (const auto& f : s) { w32(f.r); w32(f.a); w32(f.i); }
    }
    w64((int64_t)st->pending.size());
    std::memcpy(out + p, st->pending.data(), st->pending.size());
    p += (int64_t)st->pending.size();
    return p;
}

}  // extern "C"
