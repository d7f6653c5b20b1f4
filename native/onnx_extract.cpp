// ONNX weight/graph extractor (dependency-free protobuf wire parser).
//
// The reference embeds ONNX Runtime in C++ to run the Spot locomotion policy
// inside its threaded rollout (mujoco_extensions/onnx_interface/
// onnx_interface.cpp:38-109). Here the policy executes as a JAX
// MLP inside the jitted rollout, so the only native job left is extracting
// the network (weights + op graph) from the .onnx protobuf — done here with
// a hand-rolled wire-format parser (no onnx/protobuf libraries exist in the
// deployment image).
//
// Exposed C API (ctypes):
//   int onnx_extract(const char* onnx_path, const char* out_path)
//
// Output: a simple binary container
//   magic "JTONNX1\0"
//   u32 n_tensors; per tensor: u32 name_len, name, u32 dtype, u32 ndims,
//       u64 dims[], u64 nbytes, raw little-endian data
//   u32 n_nodes; per node: u32 len + op_type, u32 n_in (u32 len + str)...,
//       u32 n_out (...)
//
// Build: make -C native   (produces libonnx_extract.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift >= 64) break;
    }
    ok = false;
    return 0;
  }

  // returns (field_number, wire_type); field 0 on failure/end
  std::pair<uint32_t, uint32_t> tag() {
    if (p >= end) return {0, 0};
    uint64_t t = varint();
    return {static_cast<uint32_t>(t >> 3), static_cast<uint32_t>(t & 7)};
  }

  Reader slice() {
    uint64_t len = varint();
    if (!ok || p + len > end) {
      ok = false;
      return {p, p};
    }
    Reader r{p, p + len};
    p += len;
    return r;
  }

  void skip(uint32_t wire_type) {
    switch (wire_type) {
      case 0: varint(); break;
      case 1: p += 8; break;
      case 2: { uint64_t len = varint(); p += len; break; }
      case 5: p += 4; break;
      default: ok = false;
    }
    if (p > end) ok = false;
  }

  std::string str() {
    Reader r = slice();
    return std::string(reinterpret_cast<const char*>(r.p), r.end - r.p);
  }
};

struct Tensor {
  std::string name;
  uint32_t dtype = 0;
  std::vector<uint64_t> dims;
  std::vector<uint8_t> data;
};

struct Node {
  std::string op_type;
  std::vector<std::string> inputs;
  std::vector<std::string> outputs;
};

// TensorProto fields: 1=dims(varint) 2=data_type 4=float_data(packed) 8=name 9=raw_data
Tensor parse_tensor(Reader r) {
  Tensor t;
  while (r.ok && r.p < r.end) {
    auto [field, wt] = r.tag();
    if (field == 0) break;
    if (field == 1 && wt == 0) {
      t.dims.push_back(r.varint());
    } else if (field == 1 && wt == 2) {  // packed dims
      Reader s = r.slice();
      while (s.ok && s.p < s.end) t.dims.push_back(s.varint());
    } else if (field == 2 && wt == 0) {
      t.dtype = static_cast<uint32_t>(r.varint());
    } else if (field == 4 && wt == 2) {  // packed float_data
      Reader s = r.slice();
      t.data.assign(s.p, s.end);
    } else if (field == 8 && wt == 2) {
      t.name = r.str();
    } else if (field == 9 && wt == 2) {
      Reader s = r.slice();
      t.data.assign(s.p, s.end);
    } else {
      r.skip(wt);
    }
  }
  return t;
}

// NodeProto fields: 1=input 2=output 3=name 4=op_type
Node parse_node(Reader r) {
  Node n;
  while (r.ok && r.p < r.end) {
    auto [field, wt] = r.tag();
    if (field == 0) break;
    if (field == 1 && wt == 2) n.inputs.push_back(r.str());
    else if (field == 2 && wt == 2) n.outputs.push_back(r.str());
    else if (field == 4 && wt == 2) n.op_type = r.str();
    else r.skip(wt);
  }
  return n;
}

// GraphProto fields: 1=node 5=initializer
void parse_graph(Reader r, std::vector<Tensor>& tensors, std::vector<Node>& nodes) {
  while (r.ok && r.p < r.end) {
    auto [field, wt] = r.tag();
    if (field == 0) break;
    if (field == 1 && wt == 2) nodes.push_back(parse_node(r.slice()));
    else if (field == 5 && wt == 2) tensors.push_back(parse_tensor(r.slice()));
    else r.skip(wt);
  }
}

void put_u32(FILE* f, uint32_t v) { fwrite(&v, 4, 1, f); }
void put_u64(FILE* f, uint64_t v) { fwrite(&v, 8, 1, f); }
void put_str(FILE* f, const std::string& s) {
  put_u32(f, static_cast<uint32_t>(s.size()));
  fwrite(s.data(), 1, s.size(), f);
}

}  // namespace

extern "C" int onnx_extract(const char* onnx_path, const char* out_path) {
  FILE* in = fopen(onnx_path, "rb");
  if (!in) return 1;
  fseek(in, 0, SEEK_END);
  long size = ftell(in);
  fseek(in, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (fread(buf.data(), 1, size, in) != static_cast<size_t>(size)) {
    fclose(in);
    return 2;
  }
  fclose(in);

  std::vector<Tensor> tensors;
  std::vector<Node> nodes;
  Reader r{buf.data(), buf.data() + buf.size()};
  // ModelProto: field 7 = graph
  while (r.ok && r.p < r.end) {
    auto [field, wt] = r.tag();
    if (field == 0) break;
    if (field == 7 && wt == 2) parse_graph(r.slice(), tensors, nodes);
    else r.skip(wt);
  }
  if (!r.ok) return 3;

  FILE* out = fopen(out_path, "wb");
  if (!out) return 4;
  fwrite("JTONNX1\0", 1, 8, out);
  put_u32(out, static_cast<uint32_t>(tensors.size()));
  for (const auto& t : tensors) {
    put_str(out, t.name);
    put_u32(out, t.dtype);
    put_u32(out, static_cast<uint32_t>(t.dims.size()));
    for (uint64_t d : t.dims) put_u64(out, d);
    put_u64(out, t.data.size());
    fwrite(t.data.data(), 1, t.data.size(), out);
  }
  put_u32(out, static_cast<uint32_t>(nodes.size()));
  for (const auto& n : nodes) {
    put_str(out, n.op_type);
    put_u32(out, static_cast<uint32_t>(n.inputs.size()));
    for (const auto& s : n.inputs) put_str(out, s);
    put_u32(out, static_cast<uint32_t>(n.outputs.size()));
    for (const auto& s : n.outputs) put_str(out, s);
  }
  fclose(out);
  return 0;
}
