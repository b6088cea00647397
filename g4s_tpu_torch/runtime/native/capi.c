/* C embedding API for g4s_tpu_torch (the role of Cantera's clib C API,
 * src/clib, and DeePMD's C/C++ inference libraries, source/api_c +
 * api_cc, which MD engines link against). The entry points and their
 * signatures are those of the JAX package's runtime/native/capi.c, so an MD
 * engine links either library.
 *
 * PyTorch has no standalone C runtime for these models, so the native
 * surface embeds CPython — the move api_cc makes by embedding the TF runtime
 * (source/api_cc/src/DeepPot.cc:411 loads a session into the caller's
 * process). A C program links libg4s_torch_capi.so, calls g4s_init() once,
 * and evaluates models through plain-C entry points; the models run in the
 * embedded interpreter (g4s_tpu_torch.runtime.capi_impl), on the device
 * named by the environment variable G4S_TORCH_DEVICE ("cuda" when unset,
 * which raises without a card; "cpu" runs on the host).
 *
 * Build (g4s_tpu_torch.runtime.capi_impl.build_capi does this with the
 * flags of the running interpreter's sysconfig):
 *   gcc -shared -fPIC capi.c -o libg4s_torch_capi.so $(python3-config
 *       --includes --ldflags --embed)
 * The embedded interpreter must find torch: set PYTHONPATH to the
 * site-packages that hold it when the program does not run from that
 * environment.
 *
 * Entry points:
 *   int  g4s_init(const char* repo_path);
 *   int  g4s_deeppot_load(const char* frozen_npz);      -> handle (>=0)
 *   int  g4s_deeppot_eval(int handle, int natoms,
 *                         const double* coord (3N), const double* box (9),
 *                         const int* types (N), double* energy,
 *                         double* force (3N), double* virial (9));
 *   int  g4s_ignition_delay(const char* mech_yaml, const char* phase,
 *                           double T0, double P0, double* tau);
 *   void g4s_finalize(void);
 * All return 0 on success (handles >= 0), negative on error.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

static PyObject* g4s_mod = NULL;

int g4s_init(const char* repo_path) {
  if (!Py_IsInitialized()) Py_Initialize();
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* sys_path = PySys_GetObject("path");
  PyObject* p = PyUnicode_FromString(repo_path);
  PyList_Insert(sys_path, 0, p);
  Py_DECREF(p);
  g4s_mod = PyImport_ImportModule("g4s_tpu_torch.runtime.capi_impl");
  if (!g4s_mod) {
    PyErr_Print();
    PyGILState_Release(st);
    return -1;
  }
  PyGILState_Release(st);
  return 0;
}

int g4s_deeppot_load(const char* frozen_npz) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g4s_mod, "deeppot_load", "s", frozen_npz);
  if (!r) {
    PyErr_Print();
    PyGILState_Release(st);
    return -1;
  }
  int h = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  PyGILState_Release(st);
  return h;
}

int g4s_deeppot_eval(int handle, int natoms, const double* coord,
                     const double* box, const int* types, double* energy,
                     double* force, double* virial) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* co = PyBytes_FromStringAndSize((const char*)coord,
                                           (Py_ssize_t)natoms * 3 * 8);
  PyObject* bo = PyBytes_FromStringAndSize((const char*)box, 9 * 8);
  PyObject* ty = PyBytes_FromStringAndSize((const char*)types,
                                           (Py_ssize_t)natoms * 4);
  PyObject* r = PyObject_CallMethod(g4s_mod, "deeppot_eval", "iiOOO",
                                    handle, natoms, co, bo, ty);
  Py_XDECREF(co);
  Py_XDECREF(bo);
  Py_XDECREF(ty);
  if (!r) {
    PyErr_Print();
    PyGILState_Release(st);
    return -1;
  }
  /* r = (energy_float, force_bytes, virial_bytes). The copy lengths are
   * validated against the caller's fixed-size buffers (natoms*3 doubles,
   * 9 doubles) so a model returning an unexpected shape can never
   * overflow caller memory. */
  double e = PyFloat_AsDouble(PyTuple_GetItem(r, 0));
  char* fb;
  Py_ssize_t fl;
  PyBytes_AsStringAndSize(PyTuple_GetItem(r, 1), &fb, &fl);
  char* vb;
  Py_ssize_t vl;
  PyBytes_AsStringAndSize(PyTuple_GetItem(r, 2), &vb, &vl);
  if (fl != (Py_ssize_t)natoms * 3 * 8 || vl != 9 * 8) {
    Py_DECREF(r);
    PyGILState_Release(st);
    return -2; /* shape mismatch from the model */
  }
  memcpy(force, fb, (size_t)fl);
  memcpy(virial, vb, (size_t)vl);
  *energy = e;
  Py_DECREF(r);
  PyGILState_Release(st);
  return 0;
}

int g4s_ignition_delay(const char* mech_yaml, const char* phase, double T0,
                       double P0, double* tau) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g4s_mod, "ignition_delay", "ssdd",
                                    mech_yaml, phase, T0, P0);
  if (!r) {
    PyErr_Print();
    PyGILState_Release(st);
    return -1;
  }
  *tau = PyFloat_AsDouble(r);
  Py_DECREF(r);
  PyGILState_Release(st);
  return 0;
}

void g4s_finalize(void) { /* keep the interpreter: cheap, reusable */ }
