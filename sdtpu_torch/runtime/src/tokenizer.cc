// Native CLIP BPE tokenizer — the C++ counterpart of the reference's
// from-scratch Rust tokenizer (src/tokenizer.rs:86-203). ASCII fast path:
// non-ASCII input returns -1 and the caller falls back to the Python
// implementation (sdtpu_torch/tokenizer.py), which is the behavioural oracle.
//
// Construction mirrors tokenizer.rs exactly:
// - byte<->unicode table ordering (tokenizer.rs:7-28)
// - merges rows [1, 48895) of bpe_simple_vocab_16e6.txt (tokenizer.rs:93)
// - vocab = 256 chars + 256 chars</w> + merges + 2 specials (tokenizer.rs:59-73)
// - leftmost-first pre-tokenizer alternation: specials, contractions,
//   letter runs, single digits, punct runs (tokenizer.rs:105)
// - greedy lowest-rank merge loop (tokenizer.rs:118-173)

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    return std::hash<std::string>()(p.first) * 31 ^ std::hash<std::string>()(p.second);
  }
};

struct Tokenizer {
  std::unordered_map<std::string, uint32_t> encoder;
  std::unordered_map<std::pair<std::string, std::string>, uint32_t, PairHash> ranks;
};

// UTF-8 encode a codepoint (ASCII + BMP is enough here).
std::string utf8(uint32_t cp) {
  std::string s;
  if (cp < 0x80) {
    s += static_cast<char>(cp);
  } else if (cp < 0x800) {
    s += static_cast<char>(0xC0 | (cp >> 6));
    s += static_cast<char>(0x80 | (cp & 0x3F));
  } else {
    s += static_cast<char>(0xE0 | (cp >> 12));
    s += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    s += static_cast<char>(0x80 | (cp & 0x3F));
  }
  return s;
}

// bytes_to_unicode ordering from tokenizer.rs:7-28.
std::vector<std::string> byte_unicode_chars() {
  std::vector<int> bs;
  for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
  for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
  for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
  std::vector<uint32_t> cs(bs.begin(), bs.end());
  int n = 0;
  for (int b = 0; b < 256; ++b) {
    bool present = false;
    for (int x : bs) if (x == b) { present = true; break; }
    if (!present) {
      bs.push_back(b);
      cs.push_back(256 + n++);
    }
  }
  std::vector<std::string> chars;
  chars.reserve(256);
  for (uint32_t cp : cs) chars.push_back(utf8(cp));
  return chars;
}

const char kSOT[] = "<|startoftext|>";
const char kEOT[] = "<|endoftext|>";

bool is_ascii_letter(char c) { return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z'); }
bool is_ascii_digit(char c) { return c >= '0' && c <= '9'; }

}  // namespace

extern "C" {

void* sdtpu_tokenizer_new(const char* merges_text, uint64_t len) {
  auto* tk = new Tokenizer();

  // split into lines; rows [1, 49152-256-2+1) are merges (tokenizer.rs:93)
  std::vector<std::pair<std::string, std::string>> merges;
  merges.reserve(48894);
  const char* p = merges_text;
  const char* end = merges_text + len;
  int line_no = 0;
  const int last = 49152 - 256 - 2;  // exclusive upper row index
  while (p < end && line_no <= last) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* eol = nl ? nl : end;
    if (line_no >= 1) {
      const char* sp = static_cast<const char*>(memchr(p, ' ', eol - p));
      if (sp && sp > p && sp + 1 < eol) {
        merges.emplace_back(std::string(p, sp), std::string(sp + 1, eol));
      }
    }
    ++line_no;
    p = nl ? nl + 1 : end;
  }

  auto chars = byte_unicode_chars();
  uint32_t id = 0;
  for (const auto& c : chars) tk->encoder[c] = id++;
  for (const auto& c : chars) tk->encoder[c + "</w>"] = id++;
  for (const auto& m : merges) tk->encoder[m.first + m.second] = id++;
  tk->encoder[kSOT] = id++;
  tk->encoder[kEOT] = id++;
  for (uint32_t r = 0; r < merges.size(); ++r) tk->ranks[merges[r]] = r;
  return tk;
}

void sdtpu_tokenizer_free(void* h) { delete static_cast<Tokenizer*>(h); }

int sdtpu_tokenizer_vocab_size(void* h) {
  return static_cast<int>(static_cast<Tokenizer*>(h)->encoder.size());
}

// Returns token count, or -1 for non-ASCII input (caller uses the Python
// fallback), or -2 on capacity overflow.
int sdtpu_tokenizer_encode(void* h, const char* text, uint32_t* out, int cap) {
  auto* tk = static_cast<Tokenizer*>(h);

  // whitespace-clean + ASCII lowercase (tokenizer.rs:37-39,176)
  std::string clean;
  {
    std::string t(text);
    size_t i = 0;
    while (i < t.size()) {
      unsigned char c = t[i];
      if (c >= 0x80) return -1;  // non-ASCII: fall back
      if (isspace(c)) { ++i; continue; }
      if (!clean.empty()) clean += ' ';
      while (i < t.size() && !isspace(static_cast<unsigned char>(t[i]))) {
        unsigned char cc = t[i];
        if (cc >= 0x80 || cc < 0x20) return -1;
        clean += static_cast<char>(tolower(cc));
        ++i;
      }
    }
  }

  int n_out = 0;
  auto emit = [&](uint32_t v) -> bool {
    if (n_out >= cap) return false;
    out[n_out++] = v;
    return true;
  };

  size_t i = 0;
  const size_t n = clean.size();
  while (i < n) {
    char c = clean[i];
    if (c == ' ') { ++i; continue; }

    // leftmost-first alternation, same order as tokenizer.rs:105
    if (clean.compare(i, sizeof(kSOT) - 1, kSOT) == 0) {
      if (!emit(tk->encoder[kSOT])) return -2;
      i += sizeof(kSOT) - 1;
      continue;
    }
    if (clean.compare(i, sizeof(kEOT) - 1, kEOT) == 0) {
      if (!emit(tk->encoder[kEOT])) return -2;
      i += sizeof(kEOT) - 1;
      continue;
    }

    std::string token;
    if (c == '\'') {
      static const char* kContr[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
      for (const char* k : kContr) {
        size_t kl = strlen(k);
        if (clean.compare(i, kl, k) == 0) { token.assign(k); break; }
      }
    }
    if (token.empty()) {
      if (is_ascii_letter(c)) {
        size_t j = i;
        while (j < n && is_ascii_letter(clean[j])) ++j;
        token = clean.substr(i, j - i);
      } else if (is_ascii_digit(c)) {
        token = clean.substr(i, 1);
      } else {
        size_t j = i;
        while (j < n && clean[j] != ' ' && !is_ascii_letter(clean[j]) &&
               !is_ascii_digit(clean[j])) ++j;
        token = clean.substr(i, j - i);
      }
    }
    i += token.size();

    // BPE merge loop (tokenizer.rs:118-173)
    std::vector<std::string> word;
    word.reserve(token.size());
    for (size_t t = 0; t + 1 < token.size(); ++t) word.emplace_back(1, token[t]);
    word.push_back(std::string(1, token.back()) + "</w>");

    while (word.size() > 1) {
      uint32_t best = UINT32_MAX;
      size_t best_i = 0;
      for (size_t t = 0; t + 1 < word.size(); ++t) {
        auto it = tk->ranks.find({word[t], word[t + 1]});
        if (it != tk->ranks.end() && it->second < best) {
          best = it->second;
          best_i = t;
        }
      }
      if (best == UINT32_MAX) break;
      // merge ALL occurrences of the best pair (left to right)
      const std::string first = word[best_i], second = word[best_i + 1];
      std::vector<std::string> merged;
      merged.reserve(word.size());
      for (size_t t = 0; t < word.size();) {
        if (t + 1 < word.size() && word[t] == first && word[t + 1] == second) {
          merged.push_back(first + second);
          t += 2;
        } else {
          merged.push_back(word[t]);
          ++t;
        }
      }
      word.swap(merged);
    }

    for (const auto& piece : word) {
      auto it = tk->encoder.find(piece);
      if (it == tk->encoder.end()) return -1;  // shouldn't happen for ASCII
      if (!emit(it->second)) return -2;
    }
  }
  return n_out;
}

}  // extern "C"
