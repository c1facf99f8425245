// Device-runtime bridge: handle-model C ABI over a CPython interpreter
// that owns the PyTorch/CUDA runtime, the layer that lets a JVM (or any
// native caller) drive the device the way the reference's JNI drives
// CUDA/libcudf. The same extern "C" tpudf_rt_* symbols, handle model,
// GIL discipline, error contract and init-retry behaviour as the
// reference's src/native/src/rt_bridge.cpp; only the Python module it
// fronts differs, and that name comes from TPUDF_RT_BRIDGE_MODULE.
//
// Handles are int64 keys of owned Python references (Column / Table /
// RowsColumn). Threading: every entry point takes the GIL through
// PyGILState_Ensure, so concurrent caller threads serialize into the one
// interpreter. The library works both ways: a C program that calls
// tpudf_rt_init first owns a new interpreter (link libpython), and a
// Python process that loads it with ctypes (which releases the GIL
// around each foreign call) shares its own.
//
// Error contract: functions return -1 (or nonzero) and keep a message
// for tpudf_rt_last_error(), per calling thread.

#ifndef TPUDF_RT_BRIDGE_MODULE
#define TPUDF_RT_BRIDGE_MODULE "spark_rapids_jni_tpu_torch.runtime.bridge"
#endif

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>

namespace {

std::mutex g_mutex;
std::unordered_map<int64_t, PyObject*> g_handles;  // owned references
int64_t g_next_handle = 1;
thread_local std::string g_last_error;
PyObject* g_bridge = nullptr;  // the TPUDF_RT_BRIDGE_MODULE module
bool g_we_initialized_python = false;

int64_t store_handle(PyObject* obj) {  // steals the reference
  std::lock_guard<std::mutex> lock(g_mutex);
  int64_t h = g_next_handle++;
  g_handles[h] = obj;
  return h;
}

PyObject* get_handle(int64_t h) {  // borrowed reference
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_handles.find(h);
  return it == g_handles.end() ? nullptr : it->second;
}

void set_python_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      char const* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// RAII GIL hold for every entry point.
struct Gil {
  PyGILState_STATE state;
  Gil() : state(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state); }
};

// Pre-GIL guard: PyGILState_Ensure on an uninitialized interpreter is a
// fatal abort, so every entry point must check this BEFORE taking the GIL
// (the benign unlocked read of g_bridge is a monotonic pointer set once
// under tpudf_rt_init's mutex).
bool rt_ready() {
  if (!Py_IsInitialized() || g_bridge == nullptr) {
    g_last_error = "tpudf_rt_init was not called";
    return false;
  }
  return true;
}

// Call bridge.<fn>(args...) returning a new reference or nullptr (+error).
PyObject* bridge_call(char const* fn, PyObject* args) {  // steals args
  if (g_bridge == nullptr) {
    Py_XDECREF(args);
    g_last_error = "tpudf_rt_init was not called";
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(g_bridge, fn);
  if (f == nullptr) {
    Py_XDECREF(args);
    set_python_error();
    return nullptr;
  }
  PyObject* out = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (out == nullptr) set_python_error();
  return out;
}

}  // namespace

extern "C" {

char const* tpudf_rt_last_error() { return g_last_error.c_str(); }

// Initialize the embedded runtime. sys_path entries (':'-separated) are
// prepended to sys.path (the packaged wheel/jar resource dir); platform ""
// selects the CUDA device (init fails without one), "cpu" the CPU.
int32_t tpudf_rt_init(char const* sys_path, char const* platform) {
  // serialize concurrent initializers (the GIL can't do it: it may not
  // exist yet); everything after interpreter creation runs under the GIL
  static std::mutex init_mutex;
  std::lock_guard<std::mutex> init_lock(init_mutex);
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized_python = true;
  }
  int32_t rc = [&]() -> int32_t {
    Gil gil;
    if (g_bridge != nullptr) return 0;  // already initialized
    if (sys_path != nullptr && sys_path[0] != '\0') {
      PyObject* sys_path_list = PySys_GetObject("path");  // borrowed
      std::string paths(sys_path);
      size_t start = 0;
      while (start <= paths.size()) {
        size_t end = paths.find(':', start);
        if (end == std::string::npos) end = paths.size();
        if (end > start) {
          PyObject* p =
              PyUnicode_FromStringAndSize(paths.data() + start, end - start);
          if (p == nullptr || PyList_Insert(sys_path_list, 0, p) != 0) {
            Py_XDECREF(p);
            set_python_error();
            return -1;
          }
          Py_DECREF(p);
        }
        start = end + 1;
      }
    }
    PyObject* mod = PyImport_ImportModule(TPUDF_RT_BRIDGE_MODULE);
    if (mod == nullptr) {
      set_python_error();
      return -1;
    }
    PyObject* ok = PyObject_CallMethod(
        mod, "init_platform", "(s)", platform == nullptr ? "" : platform);
    if (ok == nullptr) {
      // keep the module unset so callers can retry init
      set_python_error();
      Py_DECREF(mod);
      return -1;
    }
    Py_DECREF(ok);
    g_bridge = mod;
    return 0;
  }();
  if (g_we_initialized_python) {
    // Release the GIL acquired by Py_InitializeEx so any thread can enter.
    // Must run on FAILURE too: returning with the GIL held would deadlock
    // every later bridge call (including an init retry).
    static PyThreadState* main_state = nullptr;
    if (main_state == nullptr) main_state = PyEval_SaveThread();
  }
  return rc;
}

// Build a device column from host bytes. validity: 1 byte per row (0 =
// null) or nullptr for all-valid. Returns a handle or -1.
int64_t tpudf_rt_column_from_host(int32_t type_id, int32_t scale, int64_t n,
                                  uint8_t const* data, int64_t data_len,
                                  uint8_t const* validity) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* vbytes;
  if (validity == nullptr) {
    vbytes = Py_None;
    Py_INCREF(Py_None);
  } else {
    vbytes = PyBytes_FromStringAndSize(
        reinterpret_cast<char const*>(validity), n);
  }
  PyObject* args = Py_BuildValue(
      "(iiLy#N)", type_id, scale, static_cast<long long>(n),
      reinterpret_cast<char const*>(data), static_cast<Py_ssize_t>(data_len),
      vbytes);
  PyObject* col = bridge_call("column_from_host", args);
  if (col == nullptr) return -1;
  return store_handle(col);
}

int64_t tpudf_rt_table_create(int64_t const* cols, int32_t ncols) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* list = PyList_New(ncols);
  for (int32_t i = 0; i < ncols; ++i) {
    PyObject* c = get_handle(cols[i]);
    if (c == nullptr) {
      Py_DECREF(list);
      g_last_error = "invalid column handle";
      return -1;
    }
    Py_INCREF(c);
    PyList_SET_ITEM(list, i, c);
  }
  PyObject* args = Py_BuildValue("(N)", list);
  PyObject* tbl = bridge_call("table_create", args);
  if (tbl == nullptr) return -1;
  return store_handle(tbl);
}

static int64_t call_int(char const* fn, int64_t handle) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* obj = get_handle(handle);
  if (obj == nullptr) {
    g_last_error = "invalid handle";
    return -1;
  }
  Py_INCREF(obj);
  PyObject* args = Py_BuildValue("(N)", obj);
  PyObject* out = bridge_call(fn, args);
  if (out == nullptr) return -1;
  int64_t v = PyLong_AsLongLong(out);
  Py_DECREF(out);
  if (v == -1 && PyErr_Occurred()) {
    set_python_error();  // also clears the pending exception
    return -1;
  }
  return v;
}

int32_t tpudf_rt_table_num_columns(int64_t tbl) {
  return static_cast<int32_t>(call_int("table_num_columns", tbl));
}

int64_t tpudf_rt_table_num_rows(int64_t tbl) {
  return call_int("table_num_rows", tbl);
}

int64_t tpudf_rt_table_column(int64_t tbl, int32_t i) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* obj = get_handle(tbl);
  if (obj == nullptr) {
    g_last_error = "invalid handle";
    return -1;
  }
  Py_INCREF(obj);
  PyObject* args = Py_BuildValue("(Ni)", obj, i);
  PyObject* col = bridge_call("table_column", args);
  if (col == nullptr) return -1;
  return store_handle(col);
}

int32_t tpudf_rt_column_info(int64_t col, int32_t* type_id, int32_t* scale,
                             int64_t* num_rows) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* obj = get_handle(col);
  if (obj == nullptr) {
    g_last_error = "invalid handle";
    return -1;
  }
  Py_INCREF(obj);
  PyObject* args = Py_BuildValue("(N)", obj);
  PyObject* out = bridge_call("column_info", args);
  if (out == nullptr) return -1;
  long long t = 0, s = 0, n = 0;
  if (!PyArg_ParseTuple(out, "LLL", &t, &s, &n)) {
    set_python_error();
    Py_DECREF(out);
    return -1;
  }
  Py_DECREF(out);
  *type_id = static_cast<int32_t>(t);
  *scale = static_cast<int32_t>(s);
  *num_rows = n;
  return 0;
}

// Copy a device column to host: data_out receives n*size_bytes, validity_out
// one byte per row. Either may be nullptr to skip.
int32_t tpudf_rt_column_to_host(int64_t col, uint8_t* data_out,
                                int64_t data_cap, uint8_t* validity_out,
                                int64_t validity_cap) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* obj = get_handle(col);
  if (obj == nullptr) {
    g_last_error = "invalid handle";
    return -1;
  }
  Py_INCREF(obj);
  PyObject* args = Py_BuildValue("(N)", obj);
  PyObject* out = bridge_call("column_to_host", args);
  if (out == nullptr) return -1;
  PyObject *data = nullptr, *valid = nullptr;
  if (!PyArg_ParseTuple(out, "SS", &data, &valid)) {
    set_python_error();
    Py_DECREF(out);
    return -1;
  }
  if (data_out != nullptr) {
    Py_ssize_t len = PyBytes_GET_SIZE(data);
    if (len > data_cap) {
      g_last_error = "data buffer too small";
      Py_DECREF(out);
      return -1;
    }
    std::memcpy(data_out, PyBytes_AS_STRING(data), len);
  }
  if (validity_out != nullptr) {
    Py_ssize_t len = PyBytes_GET_SIZE(valid);
    if (len > validity_cap) {
      g_last_error = "validity buffer too small";
      Py_DECREF(out);
      return -1;
    }
    std::memcpy(validity_out, PyBytes_AS_STRING(valid), len);
  }
  Py_DECREF(out);
  return 0;
}

// Device row conversion: table handle -> batches of packed-rows columns.
// out receives up to cap handles; *n_out the true batch count.
int32_t tpudf_rt_convert_to_rows(int64_t tbl, int64_t* out, int32_t cap,
                                 int32_t* n_out) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* obj = get_handle(tbl);
  if (obj == nullptr) {
    g_last_error = "invalid handle";
    return -1;
  }
  Py_INCREF(obj);
  PyObject* args = Py_BuildValue("(N)", obj);
  PyObject* batches = bridge_call("convert_to_rows", args);
  if (batches == nullptr) return -1;
  Py_ssize_t n = PyList_Size(batches);
  *n_out = static_cast<int32_t>(n);
  if (n > cap) {
    g_last_error = "batch output array too small";
    Py_DECREF(batches);
    return -1;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* b = PyList_GET_ITEM(batches, i);  // borrowed
    Py_INCREF(b);
    out[i] = store_handle(b);
  }
  Py_DECREF(batches);
  return 0;
}

int64_t tpudf_rt_convert_from_rows(int64_t rows, int32_t const* type_ids,
                                   int32_t const* scales, int32_t ncols) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* obj = get_handle(rows);
  if (obj == nullptr) {
    g_last_error = "invalid handle";
    return -1;
  }
  PyObject* tlist = PyList_New(ncols);
  PyObject* slist = PyList_New(ncols);
  for (int32_t i = 0; i < ncols; ++i) {
    PyList_SET_ITEM(tlist, i, PyLong_FromLong(type_ids[i]));
    PyList_SET_ITEM(slist, i, PyLong_FromLong(scales[i]));
  }
  Py_INCREF(obj);
  PyObject* args = Py_BuildValue("(NNN)", obj, tlist, slist);
  PyObject* tbl = bridge_call("convert_from_rows", args);
  if (tbl == nullptr) return -1;
  return store_handle(tbl);
}

int32_t tpudf_rt_rows_info(int64_t rows, int64_t* num_rows,
                           int64_t* row_size) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* obj = get_handle(rows);
  if (obj == nullptr) {
    g_last_error = "invalid handle";
    return -1;
  }
  Py_INCREF(obj);
  PyObject* args = Py_BuildValue("(N)", obj);
  PyObject* out = bridge_call("rows_info", args);
  if (out == nullptr) return -1;
  long long n = 0, sz = 0;
  if (!PyArg_ParseTuple(out, "LL", &n, &sz)) {
    set_python_error();
    Py_DECREF(out);
    return -1;
  }
  Py_DECREF(out);
  *num_rows = n;
  *row_size = sz;
  return 0;
}

int32_t tpudf_rt_rows_to_host(int64_t rows, uint8_t* out, int64_t cap) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* obj = get_handle(rows);
  if (obj == nullptr) {
    g_last_error = "invalid handle";
    return -1;
  }
  Py_INCREF(obj);
  PyObject* args = Py_BuildValue("(N)", obj);
  PyObject* data = bridge_call("rows_to_host", args);
  if (data == nullptr) return -1;
  Py_ssize_t len = PyBytes_GET_SIZE(data);
  if (len > cap) {
    g_last_error = "rows buffer too small";
    Py_DECREF(data);
    return -1;
  }
  std::memcpy(out, PyBytes_AS_STRING(data), len);
  Py_DECREF(data);
  return 0;
}

int64_t tpudf_rt_rows_from_host(int64_t num_rows, int64_t row_size,
                                uint8_t const* data) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LLy#)", static_cast<long long>(num_rows),
      static_cast<long long>(row_size), reinterpret_cast<char const*>(data),
      static_cast<Py_ssize_t>(num_rows * row_size));
  PyObject* rows = bridge_call("rows_from_host", args);
  if (rows == nullptr) return -1;
  return store_handle(rows);
}

int32_t tpudf_rt_free(int64_t handle) {
  if (!rt_ready()) return -1;
  Gil gil;
  PyObject* obj = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    auto it = g_handles.find(handle);
    if (it == g_handles.end()) {
      g_last_error = "invalid handle";
      return -1;
    }
    obj = it->second;
    g_handles.erase(it);
  }
  // Drop the reference outside g_mutex: a deallocation can run Python
  // code that releases the GIL, and a thread that then takes the GIL
  // would wait for g_mutex forever.
  Py_DECREF(obj);
  return 0;
}

}  // extern "C"
