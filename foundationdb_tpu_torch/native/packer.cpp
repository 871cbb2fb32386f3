// Native batch packer: list[TxnRequest] -> ResolveBatch arrays, one C pass.
//
// The commit proxy's host-side serialization (resolver/packing.py
// BatchPacker.pack) is the largest host share of a resolve: the card's
// compiled step takes well under a millisecond a 1024-txn batch, and the
// numpy packer walks every txn as Python objects. This extension does the
// whole walk in C: per-txn op counts, conflict-range gather, big-endian
// limb encode, FNV-style hashing and coarse bucketing, writing directly
// into the preallocated numpy arrays.
//
// Ref parity: the role of CommitProxyServer.actor.cpp's batch
// serialization toward ResolveTransactionBatchRequest (the reference also
// does this in C++). The limb encoding and hash MUST stay in lockstep
// with foundationdb_tpu_torch/core/keys.py KeyCodec and
// foundationdb_tpu_torch/ops/intervals.py fnv_hash; differential test:
// tests/test_torch_native.py.
//
// Contract (trusted internal ABI -- the Python caller allocates every
// array with the right shape/dtype; no shape checks here):
//   pack_into(txns, base_version, (PR, PW, RR, RW), num_limbs,
//             bucket_bits, arrays20) -> 0 ok | 1 overflow (caller
//             falls back to the numpy path, which normalizes)
// arrays20 (C-contiguous): rv u32[T]; txn_mask bool[T];
//   pr_key u32[T,PR,W], pr_hash u32[T,PR], pr_bucket i32[T,PR],
//   pr_mask bool[T,PR]; pw_* likewise; rr_b/rr_e u32[T,RR,W],
//   rr_lo/rr_hi i32[T,RR], rr_mask bool[T,RR]; rw_* likewise.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

struct Lane {
  uint32_t* key = nullptr;   // [T, N, W] (or begin for ranges)
  uint32_t* end = nullptr;   // [T, N, W] (ranges only)
  uint32_t* hash = nullptr;  // [T, N] (points only)
  int32_t* lo = nullptr;     // [T, N] bucket (ranges: begin bucket)
  int32_t* hi = nullptr;     // [T, N] bucket (ranges: end bucket)
  uint8_t* mask = nullptr;   // [T, N]
  Py_ssize_t cap = 0;        // N
};

// fnv_hash twin (ops/intervals.py fnv_hash, resolver/packing.py fnv_hash_np)
inline uint32_t fnv_hash(const uint32_t* limbs, int w) {
  uint32_t h = 2166136261u;
  for (int i = 0; i < w; i++) h = (h ^ limbs[i]) * 16777619u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return h;
}

// KeyCodec.encode_lower: big-endian 4-byte limbs, zero pad, length limb.
inline void encode_lower(const uint8_t* d, Py_ssize_t len, int L,
                         uint32_t* out) {
  const Py_ssize_t cap = 4 * (Py_ssize_t)L;
  const Py_ssize_t n = len < cap ? len : cap;
  for (int i = 0; i < L; i++) {
    Py_ssize_t b = 4 * (Py_ssize_t)i;
    uint32_t v = 0;
    if (b < n) {
      v |= (uint32_t)d[b] << 24;
      if (b + 1 < n) v |= (uint32_t)d[b + 1] << 16;
      if (b + 2 < n) v |= (uint32_t)d[b + 2] << 8;
      if (b + 3 < n) v |= (uint32_t)d[b + 3];
    }
    out[i] = v;
  }
  out[L] = (uint32_t)n;
}

// KeyCodec.encode_upper: same for in-capacity keys; over-capacity upper
// bounds round up to the prefix successor (conservative widening).
inline void encode_upper(const uint8_t* d, Py_ssize_t len, int L,
                         uint32_t* out) {
  const Py_ssize_t cap = 4 * (Py_ssize_t)L;
  encode_lower(d, len, L, out);
  if (len <= cap) return;
  for (int i = L - 1; i >= 0; i--) {
    if (out[i] != 0xFFFFFFFFu) {
      out[i] += 1;
      for (int j = i + 1; j < L; j++) out[j] = 0;
      out[L] = 0;
      return;
    }
    out[i] = 0;
  }
  for (int i = 0; i < L; i++) out[i] = 0xFFFFFFFFu;
  out[L] = (uint32_t)(cap + 1);
}

inline int32_t bucket_of(uint32_t first_limb, int bucket_bits) {
  return (int32_t)(first_limb >> (32 - bucket_bits));
}

struct Names {
  PyObject* read_version;
  PyObject* point_reads;
  PyObject* point_writes;
  PyObject* range_reads;
  PyObject* range_writes;
};

// Borrowed-ref sequence item access tolerating list or tuple.
inline PyObject* seq_item(PyObject* s, Py_ssize_t i) {
  if (PyList_Check(s)) return PyList_GET_ITEM(s, i);
  if (PyTuple_Check(s)) return PyTuple_GET_ITEM(s, i);
  return nullptr;
}

inline Py_ssize_t seq_len(PyObject* s) {
  if (PyList_Check(s)) return PyList_GET_SIZE(s);
  if (PyTuple_Check(s)) return PyTuple_GET_SIZE(s);
  return -1;
}

// Fill one point op slot. Returns false on type error (exception set).
inline bool fill_point(PyObject* key, Lane& lane, Py_ssize_t t,
                       Py_ssize_t slot, int L, int W, int bucket_bits) {
  char* d;
  Py_ssize_t len;
  if (PyBytes_AsStringAndSize(key, &d, &len) < 0) return false;
  uint32_t* out = lane.key + (t * lane.cap + slot) * W;
  encode_lower((const uint8_t*)d, len, L, out);
  lane.hash[t * lane.cap + slot] = fnv_hash(out, W);
  lane.lo[t * lane.cap + slot] = bucket_of(out[0], bucket_bits);
  lane.mask[t * lane.cap + slot] = 1;
  return true;
}

inline bool fill_range(PyObject* pair, Lane& lane, Py_ssize_t t,
                       Py_ssize_t slot, int L, int W, int bucket_bits) {
  if (!pair || seq_len(pair) < 2) {
    PyErr_SetString(PyExc_TypeError, "range must be a (begin, end) pair");
    return false;
  }
  PyObject* kb = seq_item(pair, 0);
  PyObject* ke = seq_item(pair, 1);
  char *db, *de;
  Py_ssize_t lb, le;
  if (PyBytes_AsStringAndSize(kb, &db, &lb) < 0) return false;
  if (PyBytes_AsStringAndSize(ke, &de, &le) < 0) return false;
  uint32_t* ob = lane.key + (t * lane.cap + slot) * W;
  uint32_t* oe = lane.end + (t * lane.cap + slot) * W;
  encode_lower((const uint8_t*)db, lb, L, ob);
  encode_upper((const uint8_t*)de, le, L, oe);
  lane.lo[t * lane.cap + slot] = bucket_of(ob[0], bucket_bits);
  lane.hi[t * lane.cap + slot] = bucket_of(oe[0], bucket_bits);
  lane.mask[t * lane.cap + slot] = 1;
  return true;
}

struct Bufs {
  Py_buffer views[20];
  int n = 0;
  ~Bufs() {
    for (int i = 0; i < n; i++) PyBuffer_Release(&views[i]);
  }
  void* get(PyObject* arrays, int i) {
    PyObject* o = PyTuple_GET_ITEM(arrays, i);
    if (PyObject_GetBuffer(o, &views[n], PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) <
        0)
      return nullptr;
    return views[n++].buf;
  }
};

PyObject* pack_into(PyObject*, PyObject* args) {
  static Names names = {
      PyUnicode_InternFromString("read_version"),
      PyUnicode_InternFromString("point_reads"),
      PyUnicode_InternFromString("point_writes"),
      PyUnicode_InternFromString("range_reads"),
      PyUnicode_InternFromString("range_writes"),
  };
  PyObject* txns;
  long long base_version;
  int pr_cap, pw_cap, rr_cap, rw_cap, num_limbs, bucket_bits;
  PyObject* arrays;
  if (!PyArg_ParseTuple(args, "OL(iiii)iiO!", &txns, &base_version, &pr_cap,
                        &pw_cap, &rr_cap, &rw_cap, &num_limbs, &bucket_bits,
                        &PyTuple_Type, &arrays))
    return nullptr;
  if (!PyList_Check(txns)) {
    PyErr_SetString(PyExc_TypeError, "txns must be a list");
    return nullptr;
  }
  if (PyTuple_GET_SIZE(arrays) != 20) {
    PyErr_SetString(PyExc_TypeError, "arrays must be a 20-tuple");
    return nullptr;
  }
  const int L = num_limbs, W = num_limbs + 1;
  const Py_ssize_t n = PyList_GET_SIZE(txns);

  Bufs bufs;
  uint32_t* rv = (uint32_t*)bufs.get(arrays, 0);
  uint8_t* txn_mask = (uint8_t*)bufs.get(arrays, 1);
  Lane pr, pw, rr, rw;
  pr.cap = pr_cap;
  pr.key = (uint32_t*)bufs.get(arrays, 2);
  pr.hash = (uint32_t*)bufs.get(arrays, 3);
  pr.lo = (int32_t*)bufs.get(arrays, 4);
  pr.mask = (uint8_t*)bufs.get(arrays, 5);
  pw.cap = pw_cap;
  pw.key = (uint32_t*)bufs.get(arrays, 6);
  pw.hash = (uint32_t*)bufs.get(arrays, 7);
  pw.lo = (int32_t*)bufs.get(arrays, 8);
  pw.mask = (uint8_t*)bufs.get(arrays, 9);
  rr.cap = rr_cap;
  rr.key = (uint32_t*)bufs.get(arrays, 10);
  rr.end = (uint32_t*)bufs.get(arrays, 11);
  rr.lo = (int32_t*)bufs.get(arrays, 12);
  rr.hi = (int32_t*)bufs.get(arrays, 13);
  rr.mask = (uint8_t*)bufs.get(arrays, 14);
  rw.cap = rw_cap;
  rw.key = (uint32_t*)bufs.get(arrays, 15);
  rw.end = (uint32_t*)bufs.get(arrays, 16);
  rw.lo = (int32_t*)bufs.get(arrays, 17);
  rw.hi = (int32_t*)bufs.get(arrays, 18);
  rw.mask = (uint8_t*)bufs.get(arrays, 19);
  if (PyErr_Occurred()) return nullptr;

  // Inactive point slots carry the hash of the all-zero key (the numpy
  // path hashes the whole array); the caller pre-fills hash arrays with
  // that constant, so this pass only writes active slots.
  for (Py_ssize_t t = 0; t < n; t++) {
    PyObject* txn = PyList_GET_ITEM(txns, t);
    PyObject* rv_obj = PyObject_GetAttr(txn, names.read_version);
    if (!rv_obj) return nullptr;
    long long v = PyLong_AsLongLong(rv_obj);
    Py_DECREF(rv_obj);
    if (v == -1 && PyErr_Occurred()) return nullptr;
    long long off = v - base_version;
    if (off < 0) off = 0;
    if (off > 0xFFFFFFFFll) off = 0xFFFFFFFFll;
    rv[t] = (uint32_t)off;
    txn_mask[t] = 1;

    PyObject* lists[4];
    static PyObject** lnames[4] = {&names.point_reads, &names.point_writes,
                                   &names.range_reads, &names.range_writes};
    const Py_ssize_t caps[4] = {pr_cap, pw_cap, rr_cap, rw_cap};
    Lane* lanes[4] = {&pr, &pw, &rr, &rw};
    for (int k = 0; k < 4; k++) {
      lists[k] = PyObject_GetAttr(txn, *lnames[k]);
      if (!lists[k]) {
        for (int j = 0; j < k; j++) Py_DECREF(lists[j]);
        return nullptr;
      }
    }
    bool ok = true, overflow = false;
    for (int k = 0; k < 4 && ok; k++) {
      Py_ssize_t cnt = seq_len(lists[k]);
      if (cnt < 0) {
        PyErr_SetString(PyExc_TypeError, "op lists must be list or tuple");
        ok = false;
        break;
      }
      if (cnt > caps[k]) {
        overflow = true;  // caller's numpy path normalizes (spill/coalesce)
        break;
      }
      for (Py_ssize_t i = 0; i < cnt && ok; i++) {
        PyObject* item = seq_item(lists[k], i);
        ok = (k < 2)
                 ? fill_point(item, *lanes[k], t, i, L, W, bucket_bits)
                 : fill_range(item, *lanes[k], t, i, L, W, bucket_bits);
      }
    }
    for (int k = 0; k < 4; k++) Py_DECREF(lists[k]);
    if (!ok) return nullptr;
    if (overflow) return PyLong_FromLong(1);
  }
  return PyLong_FromLong(0);
}

PyMethodDef methods[] = {
    {"pack_into", pack_into, METH_VARARGS,
     "Pack TxnRequests into preallocated ResolveBatch arrays; 0 ok, 1 "
     "overflow (fall back to the numpy path)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "fdbtorch_packer",
                      "Native ResolveBatch packer", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_fdbtorch_packer(void) { return PyModule_Create(&module); }
