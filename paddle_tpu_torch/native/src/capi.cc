// C inference API implementation: embeds CPython and drives
// paddle_tpu_torch.inference.capi_bridge.
//
// Role parity: paddle/fluid/inference/capi_exp/pd_inference_api.cc — the
// reference's C API wraps its C++ AnalysisPredictor; here the predictor IS
// an AOT XLA program reachable through Python, so the C ABI layer's job is
// interpreter lifecycle + GIL discipline + buffer marshalling (PyBytes in,
// malloc'd C buffers out). No NumPy C API dependency: the bridge speaks
// (bytes, shape, dtype-code) triples.
//
// Works both embedded in a C program (initializes the interpreter on first
// use, then releases the GIL so any thread can call in) and loaded inside
// an existing Python process via ctypes (Py_IsInitialized short-circuits).

#include "paddle_tpu_capi.h"

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

// Ensure the interpreter exists. When this library bootstraps the
// interpreter itself (pure C host), the bootstrapping thread releases the
// GIL afterwards so that every API call can use PyGILState_Ensure
// uniformly regardless of calling thread.
bool ensure_interpreter() {
  if (Py_IsInitialized()) return true;
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  PyStatus status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    set_error("failed to initialize embedded Python");
    return false;
  }
  PyEval_SaveThread();  // release the GIL taken by initialization
  return true;
}

class GilGuard {
 public:
  GilGuard() : state_(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

PyObject *bridge() {
  static PyObject *mod = nullptr;  // GIL-protected
  if (mod == nullptr) {
    mod = PyImport_ImportModule("paddle_tpu_torch.inference.capi_bridge");
    if (mod == nullptr) set_error_from_python();
  }
  return mod;
}

// call bridge.<fn>(args...); returns new ref or nullptr (error set)
PyObject *bridge_call(const char *fn, PyObject *args) {
  PyObject *mod = bridge();
  if (mod == nullptr) {
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *f = PyObject_GetAttrString(mod, fn);
  if (f == nullptr) {
    set_error_from_python();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (r == nullptr) set_error_from_python();
  return r;
}

int bridge_call_int(const char *fn, PyObject *args) {
  PyObject *r = bridge_call(fn, args);
  if (r == nullptr) return -1;
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  if (v == -1 && PyErr_Occurred()) {
    set_error_from_python();
    return -1;
  }
  return static_cast<int>(v);
}

int io_name_impl(int handle, int is_input, int idx, char *buf,
                 size_t buflen) {
  if (!ensure_interpreter()) return -1;
  GilGuard gil;
  PyObject *r = bridge_call(
      "io_name", Py_BuildValue("(iii)", handle, is_input, idx));
  if (r == nullptr) return -1;
  Py_ssize_t len = 0;
  const char *s = PyUnicode_AsUTF8AndSize(r, &len);
  if (s == nullptr) {
    Py_DECREF(r);
    set_error_from_python();
    return -1;
  }
  if (buf != nullptr && buflen > 0) {
    size_t n = static_cast<size_t>(len) < buflen - 1
                   ? static_cast<size_t>(len)
                   : buflen - 1;
    std::memcpy(buf, s, n);
    buf[n] = '\0';
  }
  Py_DECREF(r);
  return static_cast<int>(len);
}

}  // namespace

extern "C" {

const char *PD_LastError(void) { return g_last_error.c_str(); }

int PD_PredictorCreate(const char *path_prefix) {
  if (path_prefix == nullptr) {
    set_error("path_prefix is NULL");
    return -1;
  }
  if (!ensure_interpreter()) return -1;
  GilGuard gil;
  return bridge_call_int("create", Py_BuildValue("(s)", path_prefix));
}

int PD_PredictorInputNum(int handle) {
  if (!ensure_interpreter()) return -1;
  GilGuard gil;
  return bridge_call_int("input_num", Py_BuildValue("(i)", handle));
}

int PD_PredictorOutputNum(int handle) {
  if (!ensure_interpreter()) return -1;
  GilGuard gil;
  return bridge_call_int("output_num", Py_BuildValue("(i)", handle));
}

int PD_PredictorInputName(int handle, int idx, char *buf, size_t buflen) {
  return io_name_impl(handle, 1, idx, buf, buflen);
}

int PD_PredictorOutputName(int handle, int idx, char *buf, size_t buflen) {
  return io_name_impl(handle, 0, idx, buf, buflen);
}

int PD_PredictorRun(int handle, const PD_TensorData *inputs, int n_in,
                    PD_TensorData *outputs, int max_out) {
  if (n_in < 0 || (n_in > 0 && inputs == nullptr)) {
    set_error("bad inputs");
    return -1;
  }
  if (!ensure_interpreter()) return -1;
  GilGuard gil;

  PyObject *in_list = PyList_New(n_in);
  if (in_list == nullptr) {
    set_error_from_python();
    return -1;
  }
  for (int i = 0; i < n_in; ++i) {
    const PD_TensorData &t = inputs[i];
    if (t.ndim < 0 || t.ndim > PD_MAX_NDIM || t.data == nullptr) {
      Py_DECREF(in_list);
      set_error("bad input tensor " + std::to_string(i));
      return -1;
    }
    PyObject *shape = PyTuple_New(t.ndim);
    for (int d = 0; d < t.ndim; ++d)
      PyTuple_SET_ITEM(shape, d, PyLong_FromLongLong(t.shape[d]));
    PyObject *bytes = PyBytes_FromStringAndSize(
        static_cast<const char *>(t.data), t.nbytes);
    PyObject *triple =
        Py_BuildValue("(NNi)", bytes, shape, static_cast<int>(t.dtype));
    PyList_SET_ITEM(in_list, i, triple);  // steals
  }

  PyObject *r =
      bridge_call("run", Py_BuildValue("(iN)", handle, in_list));
  if (r == nullptr) return -1;

  int n_out = static_cast<int>(PyList_Size(r));
  if (n_out > max_out) {
    // never hand back a count the caller can't release safely
    Py_DECREF(r);
    set_error("model produces " + std::to_string(n_out) +
              " outputs but max_out is " + std::to_string(max_out));
    return -1;
  }
  int filled = n_out;
  for (int i = 0; i < filled; ++i) {
    PyObject *triple = PyList_GetItem(r, i);  // borrowed
    PyObject *bytes = PyTuple_GetItem(triple, 0);
    PyObject *shape = PyTuple_GetItem(triple, 1);
    PyObject *code = PyTuple_GetItem(triple, 2);
    PD_TensorData &o = outputs[i];
    std::memset(&o, 0, sizeof(o));
    o.dtype = static_cast<int32_t>(PyLong_AsLong(code));
    o.ndim = static_cast<int32_t>(PyTuple_Size(shape));
    if (o.ndim > PD_MAX_NDIM) {
      // fail like the input-side check: a truncated shape array with a
      // larger ndim would let the caller read past the fixed array
      for (int j = 0; j < i; ++j) std::free(outputs[j].data);
      Py_DECREF(r);
      set_error("output " + std::to_string(i) + " rank " +
                std::to_string(o.ndim) + " exceeds PD_MAX_NDIM");
      return -1;
    }
    for (int d = 0; d < o.ndim; ++d)
      o.shape[d] = PyLong_AsLongLong(PyTuple_GetItem(shape, d));
    char *src = nullptr;
    Py_ssize_t nbytes = 0;
    PyBytes_AsStringAndSize(bytes, &src, &nbytes);
    o.nbytes = static_cast<int64_t>(nbytes);
    o.data = std::malloc(nbytes > 0 ? nbytes : 1);
    if (o.data == nullptr) {
      for (int j = 0; j < i; ++j) std::free(outputs[j].data);
      Py_DECREF(r);
      set_error("out of memory");
      return -1;
    }
    std::memcpy(o.data, src, nbytes);
  }
  Py_DECREF(r);
  if (PyErr_Occurred()) {
    for (int j = 0; j < filled; ++j) std::free(outputs[j].data);
    set_error_from_python();
    return -1;
  }
  return n_out;
}

void PD_ReleaseOutputs(PD_TensorData *outputs, int n) {
  if (outputs == nullptr) return;
  for (int i = 0; i < n; ++i) {
    std::free(outputs[i].data);
    outputs[i].data = nullptr;
    outputs[i].nbytes = 0;
  }
}

int PD_PredictorDestroy(int handle) {
  if (!ensure_interpreter()) return -1;
  GilGuard gil;
  return bridge_call_int("destroy", Py_BuildValue("(i)", handle));
}

}  // extern "C"
