// Minimal msgpack codec for the dynamo_tpu_torch wire protocol.
//
// Implements exactly the subset the wire uses (dynamo_tpu_torch/runtime/wire.py:
// frames are 4-byte big-endian length + one msgpack value): nil, bool,
// int/uint, float64, str, bin, array, and string-keyed maps. The Python peers
// encode with use_bin_type=True (bytes -> bin, str -> str) and decode with
// raw=False, which this codec mirrors.
//
// Reference capability: lib/runtime/src/pipeline/network/codec/two_part.rs
// (the reference's native wire codec layer).

#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace dynwire {

struct Value {
  enum class T { Nil, Bool, Int, Double, Str, Bin, Arr, Map };
  T t = T::Nil;
  bool b = false;
  int64_t i = 0;  // all ints normalized to int64 (the protocol's ids/hashes
                  // that exceed int64 are re-encoded from u64 bits below)
  uint64_t u = 0; // set alongside i when decoding uint64 values
  bool is_u64 = false;
  double d = 0.0;
  std::string s;  // str or bin payload
  std::vector<Value> a;
  std::vector<std::pair<std::string, Value>> m;

  static Value nil() { return Value{}; }
  static Value boolean(bool v) { Value x; x.t = T::Bool; x.b = v; return x; }
  static Value integer(int64_t v) { Value x; x.t = T::Int; x.i = v; return x; }
  static Value u64(uint64_t v) {
    Value x; x.t = T::Int; x.u = v; x.is_u64 = true;
    x.i = static_cast<int64_t>(v); return x;
  }
  static Value real(double v) { Value x; x.t = T::Double; x.d = v; return x; }
  static Value str(std::string v) {
    Value x; x.t = T::Str; x.s = std::move(v); return x;
  }
  static Value bin(std::string v) {
    Value x; x.t = T::Bin; x.s = std::move(v); return x;
  }
  static Value arr(std::vector<Value> v = {}) {
    Value x; x.t = T::Arr; x.a = std::move(v); return x;
  }
  static Value map() { Value x; x.t = T::Map; return x; }

  Value& set(const std::string& key, Value v) {
    m.emplace_back(key, std::move(v));
    return *this;
  }
  const Value* get(const std::string& key) const {
    for (const auto& kv : m)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
  bool truthy_ok() const {  // reply {"ok": true} convention
    const Value* v = get("ok");
    return v && v->t == T::Bool && v->b;
  }
};

// ---------------------------------------------------------------- encode

inline void put_be(std::string& out, uint64_t v, int bytes) {
  for (int i = bytes - 1; i >= 0; --i)
    out.push_back(static_cast<char>((v >> (8 * i)) & 0xff));
}

inline void encode(const Value& v, std::string& out) {
  switch (v.t) {
    case Value::T::Nil:
      out.push_back('\xc0');
      break;
    case Value::T::Bool:
      out.push_back(v.b ? '\xc3' : '\xc2');
      break;
    case Value::T::Int: {
      if (v.is_u64 && v.u > static_cast<uint64_t>(INT64_MAX)) {
        out.push_back('\xcf');
        put_be(out, v.u, 8);
        break;
      }
      int64_t n = v.i;
      if (n >= 0) {
        if (n < 0x80) out.push_back(static_cast<char>(n));
        else if (n <= 0xff) { out.push_back('\xcc'); put_be(out, n, 1); }
        else if (n <= 0xffff) { out.push_back('\xcd'); put_be(out, n, 2); }
        else if (n <= 0xffffffffLL) { out.push_back('\xce'); put_be(out, n, 4); }
        else { out.push_back('\xcf'); put_be(out, n, 8); }
      } else {
        if (n >= -32) out.push_back(static_cast<char>(n));
        else if (n >= INT8_MIN) { out.push_back('\xd0'); put_be(out, static_cast<uint8_t>(n), 1); }
        else if (n >= INT16_MIN) { out.push_back('\xd1'); put_be(out, static_cast<uint16_t>(n), 2); }
        else if (n >= INT32_MIN) { out.push_back('\xd2'); put_be(out, static_cast<uint32_t>(n), 4); }
        else { out.push_back('\xd3'); put_be(out, static_cast<uint64_t>(n), 8); }
      }
      break;
    }
    case Value::T::Double: {
      out.push_back('\xcb');
      uint64_t bits;
      static_assert(sizeof(bits) == sizeof(v.d), "double must be 64-bit");
      std::memcpy(&bits, &v.d, 8);
      put_be(out, bits, 8);
      break;
    }
    case Value::T::Str: {
      size_t n = v.s.size();
      if (n < 32) out.push_back(static_cast<char>(0xa0 | n));
      else if (n <= 0xff) { out.push_back('\xd9'); put_be(out, n, 1); }
      else if (n <= 0xffff) { out.push_back('\xda'); put_be(out, n, 2); }
      else { out.push_back('\xdb'); put_be(out, n, 4); }
      out.append(v.s);
      break;
    }
    case Value::T::Bin: {
      size_t n = v.s.size();
      if (n <= 0xff) { out.push_back('\xc4'); put_be(out, n, 1); }
      else if (n <= 0xffff) { out.push_back('\xc5'); put_be(out, n, 2); }
      else { out.push_back('\xc6'); put_be(out, n, 4); }
      out.append(v.s);
      break;
    }
    case Value::T::Arr: {
      size_t n = v.a.size();
      if (n < 16) out.push_back(static_cast<char>(0x90 | n));
      else if (n <= 0xffff) { out.push_back('\xdc'); put_be(out, n, 2); }
      else { out.push_back('\xdd'); put_be(out, n, 4); }
      for (const auto& e : v.a) encode(e, out);
      break;
    }
    case Value::T::Map: {
      size_t n = v.m.size();
      if (n < 16) out.push_back(static_cast<char>(0x80 | n));
      else if (n <= 0xffff) { out.push_back('\xde'); put_be(out, n, 2); }
      else { out.push_back('\xdf'); put_be(out, n, 4); }
      for (const auto& kv : v.m) {
        encode(Value::str(kv.first), out);
        encode(kv.second, out);
      }
      break;
    }
  }
}

// ---------------------------------------------------------------- decode

struct Cursor {
  const uint8_t* p;
  size_t n;
  size_t off = 0;

  uint8_t u8() { need(1); return p[off++]; }
  uint64_t be(int bytes) {
    need(bytes);
    uint64_t v = 0;
    for (int i = 0; i < bytes; ++i) v = (v << 8) | p[off++];
    return v;
  }
  std::string bytes(size_t k) {
    need(k);
    std::string s(reinterpret_cast<const char*>(p + off), k);
    off += k;
    return s;
  }
  void need(size_t k) const {
    if (off + k > n) throw std::runtime_error("msgpack: truncated");
  }
};

inline Value decode(Cursor& c) {
  uint8_t tag = c.u8();
  if (tag < 0x80) return Value::integer(tag);                 // pos fixint
  if (tag >= 0xe0) return Value::integer(static_cast<int8_t>(tag));
  if ((tag & 0xe0) == 0xa0) return Value::str(c.bytes(tag & 0x1f));
  if ((tag & 0xf0) == 0x90) {                                 // fixarray
    Value v = Value::arr();
    for (int i = 0; i < (tag & 0x0f); ++i) v.a.push_back(decode(c));
    return v;
  }
  if ((tag & 0xf0) == 0x80) {                                 // fixmap
    Value v = Value::map();
    for (int i = 0; i < (tag & 0x0f); ++i) {
      Value k = decode(c);
      v.m.emplace_back(std::move(k.s), decode(c));
    }
    return v;
  }
  switch (tag) {
    case 0xc0: return Value::nil();
    case 0xc2: return Value::boolean(false);
    case 0xc3: return Value::boolean(true);
    case 0xcc: return Value::integer(static_cast<int64_t>(c.be(1)));
    case 0xcd: return Value::integer(static_cast<int64_t>(c.be(2)));
    case 0xce: return Value::integer(static_cast<int64_t>(c.be(4)));
    case 0xcf: return Value::u64(c.be(8));
    case 0xd0: return Value::integer(static_cast<int8_t>(c.be(1)));
    case 0xd1: return Value::integer(static_cast<int16_t>(c.be(2)));
    case 0xd2: return Value::integer(static_cast<int32_t>(c.be(4)));
    case 0xd3: return Value::integer(static_cast<int64_t>(c.be(8)));
    case 0xca: {
      uint32_t bits = static_cast<uint32_t>(c.be(4));
      float f;
      std::memcpy(&f, &bits, 4);
      return Value::real(f);
    }
    case 0xcb: {
      uint64_t bits = c.be(8);
      double d;
      std::memcpy(&d, &bits, 8);
      return Value::real(d);
    }
    case 0xd9: return Value::str(c.bytes(c.be(1)));
    case 0xda: return Value::str(c.bytes(c.be(2)));
    case 0xdb: return Value::str(c.bytes(c.be(4)));
    case 0xc4: return Value::bin(c.bytes(c.be(1)));
    case 0xc5: return Value::bin(c.bytes(c.be(2)));
    case 0xc6: return Value::bin(c.bytes(c.be(4)));
    case 0xdc: {
      size_t n = c.be(2);
      Value v = Value::arr();
      for (size_t i = 0; i < n; ++i) v.a.push_back(decode(c));
      return v;
    }
    case 0xdd: {
      size_t n = c.be(4);
      Value v = Value::arr();
      for (size_t i = 0; i < n; ++i) v.a.push_back(decode(c));
      return v;
    }
    case 0xde: {
      size_t n = c.be(2);
      Value v = Value::map();
      for (size_t i = 0; i < n; ++i) {
        Value k = decode(c);
        v.m.emplace_back(std::move(k.s), decode(c));
      }
      return v;
    }
    case 0xdf: {
      size_t n = c.be(4);
      Value v = Value::map();
      for (size_t i = 0; i < n; ++i) {
        Value k = decode(c);
        v.m.emplace_back(std::move(k.s), decode(c));
      }
      return v;
    }
    default:
      throw std::runtime_error("msgpack: unsupported tag");
  }
}

// ------------------------------------------------------------ framing
// Frame = 4-byte big-endian length || msgpack body (wire.py pack()).

constexpr size_t MAX_FRAME = 256ull * 1024 * 1024;

inline std::string frame(const Value& v) {
  std::string body;
  encode(v, body);
  std::string out;
  put_be(out, body.size(), 4);
  out += body;
  return out;
}

// Try to pop one frame from buf[start..]; returns true and sets `out` +
// advances `start` past the frame, or returns false if incomplete.
inline bool try_unframe(const std::string& buf, size_t& start, Value& out) {
  if (buf.size() - start < 4) return false;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(buf.data() + start);
  size_t n = (static_cast<size_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) |
             p[3];
  if (n > MAX_FRAME) throw std::runtime_error("frame exceeds MAX_FRAME");
  if (buf.size() - start < 4 + n) return false;
  Cursor c{p + 4, n};
  out = decode(c);
  start += 4 + n;
  return true;
}

}  // namespace dynwire
