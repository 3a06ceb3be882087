// The launcher of the port's CUDA libraries: a CPython extension, module
// rtt_launch, that calls a C entry point at a given address with Python
// ints, floats and None, each converted by the kind of its parameter.
//
// It replaces no TPU kernel. It was added because a probe's kernel runs for
// less time than the host takes to launch it, so the card waits on the
// wrapper, and ctypes was one of the largest parts of that path: on every
// call it converts each argument through its argtypes' from_param, prepares
// a libffi call description anew, and releases and retakes the GIL.
// chip_smoke.py's [wrapper] times the ctypes call and this one side by side
// (PERF.md, section 3).
//
//   bind(address, kinds) -> a callable f(*args) returning the entry point's
//       int. `kinds` has one letter a parameter: p a pointer (an int, None
//       for NULL, or an object with a buffer, such as a ctypes array, for its
//       address), i an int (refused with OverflowError outside int32), l a
//       long long, f a float. A wrong count or type raises TypeError.
//
// How it calls without libffi. Every entry point returns an int and takes
// only pointers, ints, long longs and floats. Under the x86-64 System V and
// the AArch64 procedure call standards the integer-class arguments (the
// pointers, ints and long longs) take the integer registers and then 8-byte
// stack slots in their order, an int read from the low 32 bits of its
// register or slot, and up to eight floats take the vector registers in
// their order, wherever they stand among the others. So an entry point with
// W integer-class parameters and F <= 8 floats is called through the type
// int(uint64_t x W, float x F), with its words and its floats each in their
// order; the table below holds one such call for every W <= MAX_WORDS and
// F <= MAX_FLOATS. The file refuses to build for another target.
//
// The GIL is held across the call, as ctypes.PyDLL holds it: an entry point
// checks its arguments, queues its kernels on the stream and returns.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <array>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <utility>

#if !defined(__linux__) || !(defined(__x86_64__) || defined(__aarch64__))
#error "launch.cpp passes arguments as the x86-64 System V or AArch64 Linux ABI does"
#endif

namespace {

constexpr std::size_t MAX_WORDS = 40, MAX_FLOATS = 4;

template <std::size_t, typename T>
using Repeat = T;

using Invoker = int (*)(void*, const uint64_t*, const float*);

template <std::size_t... W, std::size_t... F>
int invoke(void* fn, const uint64_t* w, const float* f,
           std::index_sequence<W...>, std::index_sequence<F...>) {
  using Fn = int (*)(Repeat<W, uint64_t>..., Repeat<F, float>...);
  return reinterpret_cast<Fn>(fn)(w[W]..., f[F]...);
}

template <std::size_t W, std::size_t F>
int invoke_wf(void* fn, const uint64_t* w, const float* f) {
  return invoke(fn, w, f, std::make_index_sequence<W>{},
                std::make_index_sequence<F>{});
}

template <std::size_t F, std::size_t... W>
constexpr std::array<Invoker, sizeof...(W)> invokers_of(std::index_sequence<W...>) {
  return {&invoke_wf<W, F>...};
}

template <std::size_t... F>
constexpr std::array<std::array<Invoker, MAX_WORDS + 1>, sizeof...(F)> invokers(
    std::index_sequence<F...>) {
  return {invokers_of<F>(std::make_index_sequence<MAX_WORDS + 1>{})...};
}

// INVOKERS[F][W]: the call of an entry point of W words and F floats
constexpr auto INVOKERS = invokers(std::make_index_sequence<MAX_FLOATS + 1>{});

constexpr const char* BOUND = "rtt_launch.bound";

struct Bound {
  void* fn;
  Invoker invoke;
  Py_ssize_t n_args;
  char kinds[MAX_WORDS + MAX_FLOATS + 1];
};

void free_bound(PyObject* capsule) {
  PyMem_Free(PyCapsule_GetPointer(capsule, BOUND));
}

PyObject* call(PyObject* self, PyObject* const* args, Py_ssize_t n_args) {
  const Bound* b = static_cast<const Bound*>(PyCapsule_GetPointer(self, BOUND));
  if (b == nullptr) return nullptr;
  if (n_args != b->n_args) {
    PyErr_Format(PyExc_TypeError, "the entry point takes %zd arguments, got %zd",
                 b->n_args, n_args);
    return nullptr;
  }
  uint64_t words[MAX_WORDS];
  float floats[MAX_FLOATS];
  std::size_t n_words = 0, n_floats = 0;
  for (Py_ssize_t k = 0; k < n_args; ++k) {
    PyObject* a = args[k];
    switch (b->kinds[k]) {
      case 'p': {
        void* p = nullptr;
        if (PyLong_Check(a)) {
          p = PyLong_AsVoidPtr(a);
          if (p == nullptr && PyErr_Occurred()) return nullptr;
        } else if (a != Py_None) {
          // an object with a buffer (a ctypes array, as ctypes passes one):
          // its address; the caller's reference keeps that memory in place
          // through the call
          Py_buffer view;
          if (PyObject_GetBuffer(a, &view, PyBUF_SIMPLE) < 0) return nullptr;
          p = view.buf;
          PyBuffer_Release(&view);
        }
        words[n_words++] = reinterpret_cast<uintptr_t>(p);
        break;
      }
      case 'i': {
        const long v = PyLong_AsLong(a);
        if (v == -1 && PyErr_Occurred()) return nullptr;
        if (v < INT_MIN || v > INT_MAX) {
          PyErr_Format(PyExc_OverflowError, "argument %zd: %ld is not an int32", k, v);
          return nullptr;
        }
        words[n_words++] = static_cast<uint64_t>(static_cast<int64_t>(v));
        break;
      }
      case 'l': {
        const long long v = PyLong_AsLongLong(a);
        if (v == -1 && PyErr_Occurred()) return nullptr;
        words[n_words++] = static_cast<uint64_t>(v);
        break;
      }
      default: {  // 'f'
        const double v = PyFloat_AsDouble(a);
        if (v == -1.0 && PyErr_Occurred()) return nullptr;
        floats[n_floats++] = static_cast<float>(v);
      }
    }
  }
  return PyLong_FromLong(b->invoke(b->fn, words, floats));
}

PyMethodDef CALL = {"call", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(call)),
                    METH_FASTCALL, "Call the bound entry point."};

PyObject* bind(PyObject*, PyObject* const* args, Py_ssize_t n_args) {
  if (n_args != 2) {
    PyErr_SetString(PyExc_TypeError, "bind(address, kinds)");
    return nullptr;
  }
  void* fn = PyLong_AsVoidPtr(args[0]);
  if (fn == nullptr) {
    if (!PyErr_Occurred()) PyErr_SetString(PyExc_ValueError, "address is NULL");
    return nullptr;
  }
  Py_ssize_t n = 0;
  const char* kinds = PyUnicode_AsUTF8AndSize(args[1], &n);
  if (kinds == nullptr) return nullptr;
  std::size_t n_words = 0, n_floats = 0;
  for (Py_ssize_t k = 0; k < n; ++k) {
    if (kinds[k] == 'p' || kinds[k] == 'i' || kinds[k] == 'l') {
      ++n_words;
    } else if (kinds[k] == 'f') {
      ++n_floats;
    } else {
      PyErr_Format(PyExc_ValueError, "kind %R: expected p, i, l or f", args[1]);
      return nullptr;
    }
  }
  if (n_words > MAX_WORDS || n_floats > MAX_FLOATS) {
    PyErr_Format(PyExc_ValueError,
                 "%zu pointer and integer and %zu float parameters: the "
                 "launcher takes at most %zu and %zu",
                 n_words, n_floats, MAX_WORDS, MAX_FLOATS);
    return nullptr;
  }
  Bound* b = static_cast<Bound*>(PyMem_Malloc(sizeof(Bound)));
  if (b == nullptr) return PyErr_NoMemory();
  b->fn = fn;
  b->invoke = INVOKERS[n_floats][n_words];
  b->n_args = n;
  std::memcpy(b->kinds, kinds, n + 1);
  PyObject* capsule = PyCapsule_New(b, BOUND, free_bound);
  if (capsule == nullptr) {
    PyMem_Free(b);
    return nullptr;
  }
  PyObject* bound = PyCFunction_NewEx(&CALL, capsule, nullptr);
  Py_DECREF(capsule);
  return bound;
}

PyMethodDef METHODS[] = {
    {"bind", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(bind)),
     METH_FASTCALL, "bind(address, kinds): the call of a C entry point."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef MODULE = {PyModuleDef_HEAD_INIT, "rtt_launch",
                      "Calls of the CUDA libraries' C entry points.", -1, METHODS,
                      nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_rtt_launch(void) {
  PyObject* m = PyModule_Create(&MODULE);
  if (m == nullptr) return nullptr;
  if (PyModule_AddIntConstant(m, "MAX_WORDS", MAX_WORDS) < 0 ||
      PyModule_AddIntConstant(m, "MAX_FLOATS", MAX_FLOATS) < 0) {
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
