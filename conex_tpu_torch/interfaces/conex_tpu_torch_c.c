/* conex_tpu_torch C ABI implementation: embeds CPython and drives
 * conex_tpu_torch.interface.Conex (reference surface: interfaces/conex.cc),
 * the twin of interfaces/conex_tpu_c.c.
 *
 * A program handle is a PyObject* of a Conex instance, whose solves run on
 * the device it was created on (the card unless the caller asks for
 * another).  Every entry point takes the GIL (PyGILState), so the library
 * is callable from arbitrary C threads; on a Python exception it prints the
 * traceback and returns CONEX_FAILURE (mirroring the reference's
 * CONEX_DEMAND error reporting, error_checking_macros.h:15-19).  Matrices
 * are read and written column-major.
 *
 * Build: python3 -m conex_tpu_torch.interfaces (conex_tpu_torch/interfaces/
 * __init__.py compiles this file with cc against the running Python's
 * shared libpython).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <dlfcn.h>
#include <string.h>

#include "conex_tpu.h"

static int ensure_python(void) {
  if (!Py_IsInitialized()) {
#ifdef CONEX_LIBPYTHON
    /* A host that loaded this library with RTLD_LOCAL (MATLAB's loadlibrary
     * does) keeps libpython's symbols from the extension modules that numpy
     * and torch load later: make them global. */
    dlopen(CONEX_LIBPYTHON, RTLD_NOW | RTLD_NOLOAD | RTLD_GLOBAL);
#endif
    Py_InitializeEx(0);
    /* Release the GIL acquired by initialization so PyGILState works. */
    PyEval_SaveThread();
  }
  return 1;
}

/* A new float64 numpy array holding a copy of `data`: a vector of r
 * entries when c == 0; else one r x c matrix stored column-major when
 * blocks == 0, or `blocks` consecutive ones, shaped (blocks, r, c). */
static PyObject* np_array(const double* data, int blocks, int r, int c) {
  Py_ssize_t count = (Py_ssize_t)(blocks ? blocks : 1) * r * (c ? c : 1);
  PyObject *np = NULL, *mv = NULL, *flat = NULL, *shaped = NULL, *arr = NULL;
  np = PyImport_ImportModule("numpy");
  if (np)
    mv = PyMemoryView_FromMemory((char*)data, count * (Py_ssize_t)sizeof(double),
                                 PyBUF_READ);
  if (mv) flat = PyObject_CallMethod(np, "frombuffer", "Os", mv, "float64");
  if (flat && c == 0) {
    arr = PyObject_CallMethod(flat, "copy", NULL);
  } else if (flat) {
    /* column-major: each matrix is the transpose of its (c, r) row-major
     * reading */
    shaped = blocks ? PyObject_CallMethod(flat, "reshape", "(iii)", blocks, c, r)
                    : PyObject_CallMethod(flat, "reshape", "(ii)", c, r);
    PyObject* t =
        shaped ? PyObject_CallMethod(shaped, "swapaxes", "ii", -1, -2) : NULL;
    if (t) {
      arr = PyObject_CallMethod(t, "copy", NULL);
      Py_DECREF(t);
    }
  }
  Py_XDECREF(np);
  Py_XDECREF(mv);
  Py_XDECREF(flat);
  Py_XDECREF(shaped);
  return arr;
}

/* Copy the first n entries of `obj` read as float64 in `order` ("C" or "F",
 * column-major) into out.  Returns 0, or -1 with a Python error set. */
static int copy_out(PyObject* obj, const char* order, double* out,
                    Py_ssize_t n) {
  PyObject *np = PyImport_ImportModule("numpy"), *arr = NULL, *flat = NULL;
  int rc = -1;
  if (np) arr = PyObject_CallMethod(np, "asarray", "Os", obj, "float64");
  if (arr) flat = PyObject_CallMethod(arr, "flatten", "s", order);
  if (flat) {
    Py_buffer view;
    if (PyObject_GetBuffer(flat, &view, PyBUF_C_CONTIGUOUS) == 0) {
      if (view.len < n * (Py_ssize_t)sizeof(double)) {
        PyErr_Format(PyExc_ValueError,
                     "the result has %zd entries, the caller asked for %zd",
                     view.len / (Py_ssize_t)sizeof(double), n);
      } else {
        memcpy(out, view.buf, n * sizeof(double));
        rc = 0;
      }
      PyBuffer_Release(&view);
    }
  }
  Py_XDECREF(np);
  Py_XDECREF(arr);
  Py_XDECREF(flat);
  return rc;
}

static int fail(PyGILState_STATE st) {
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(st);
  return CONEX_FAILURE;
}

/* The id of the constraint just added (num_constraints - 1), after a call
 * whose result is r; CONEX_FAILURE where r is NULL. */
static int added(PyGILState_STATE st, PyObject* prog, PyObject* r) {
  if (!r) return fail(st);
  Py_DECREF(r);
  PyObject* nc = PyObject_GetAttrString(prog, "num_constraints");
  int id = nc ? (int)PyLong_AsLong(nc) - 1 : -1;
  Py_XDECREF(nc);
  PyGILState_Release(st);
  return id;
}

/* CONEX_SUCCESS after a call whose result is r; CONEX_FAILURE where r is
 * NULL. */
static CONEX_STATUS done(PyGILState_STATE st, PyObject* r) {
  if (!r) return fail(st);
  Py_DECREF(r);
  PyGILState_Release(st);
  return CONEX_SUCCESS;
}

void* CONEX_CreateConeProgramOnDevice(const char* device) {
  ensure_python();
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* mod = PyImport_ImportModule("conex_tpu_torch.interface");
  PyObject* prog = NULL;
  if (mod) {
    prog = PyObject_CallMethod(mod, "Conex", "is", -1, device);
    Py_DECREF(mod);
  }
  if (!prog && PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(st);
  return (void*)prog;
}

void* CONEX_CreateConeProgram(void) {
  return CONEX_CreateConeProgramOnDevice("cuda");
}

void CONEX_DeleteConeProgram(void* prog) {
  if (!prog) return;
  PyGILState_STATE st = PyGILState_Ensure();
  Py_DECREF((PyObject*)prog);
  PyGILState_Release(st);
}

CONEX_STATUS CONEX_SetNumberOfVariables(void* prog, int m) {
  PyGILState_STATE st = PyGILState_Ensure();
  return done(st, PyObject_CallMethod((PyObject*)prog, "SetNumberOfVariables",
                                      "i", m));
}

int CONEX_AddDenseLinearConstraint(void* prog, const double* A, int Ar,
                                   int Ac, const double* c, int cr) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* Aa = np_array(A, 0, Ar, Ac);
  PyObject* ca = np_array(c, 0, cr, 0);
  PyObject* r = NULL;
  if (Aa && ca)
    r = PyObject_CallMethod((PyObject*)prog, "AddLinearInequality", "OO", Aa,
                            ca);
  Py_XDECREF(Aa);
  Py_XDECREF(ca);
  return added(st, (PyObject*)prog, r);
}

int CONEX_AddDenseLMIConstraint(void* prog, const double* Aarray, int Ar,
                                int Ac, int m, const double* cmat, int cr,
                                int cc) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* stack = np_array(Aarray, m, Ar, Ac);
  PyObject* Ca = np_array(cmat, 0, cr, cc);
  PyObject* r = NULL;
  if (stack && Ca)
    r = PyObject_CallMethod((PyObject*)prog, "AddDenseLMIConstraint", "OO",
                            stack, Ca);
  Py_XDECREF(stack);
  Py_XDECREF(Ca);
  return added(st, (PyObject*)prog, r);
}

int CONEX_AddLinearInequalities(void* prog, const double* A, int Ar, int Ac,
                                const double* lb, int num_lb,
                                const double* ub, int num_ub) {
  if (Ar != num_lb || Ar != num_ub) return CONEX_FAILURE;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* Aa = np_array(A, 0, Ar, Ac);
  PyObject* lba = np_array(lb, 0, num_lb, 0);
  PyObject* uba = np_array(ub, 0, num_ub, 0);
  PyObject* r = NULL;
  if (Aa && lba && uba)
    r = PyObject_CallMethod((PyObject*)prog, "AddLinearInequalities", "OOO",
                            Aa, lba, uba);
  Py_XDECREF(Aa);
  Py_XDECREF(lba);
  Py_XDECREF(uba);
  if (done(st, r) != CONEX_SUCCESS) return CONEX_FAILURE;
  /* reference returns a placeholder id (interfaces/conex.cc:213-214). */
  return -1;
}

int CONEX_AddQuadraticCost(void* prog, const double* A, int Ar, int Ac) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* Aa = np_array(A, 0, Ar, Ac);
  PyObject* r = NULL;
  if (Aa)
    r = PyObject_CallMethod((PyObject*)prog, "AddQuadraticCost", "O", Aa);
  Py_XDECREF(Aa);
  return done(st, r);
}

int CONEX_AddSparseLMIConstraint(void* prog, const double* Aarray, int Ar,
                                 int Ac, int m, const double* cmat, int cr,
                                 int cc, const long* vars, int vars_c) {
  if (vars_c != m) return CONEX_FAILURE;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* stack = np_array(Aarray, m, Ar, Ac);
  PyObject* Ca = np_array(cmat, 0, cr, cc);
  PyObject* vlist = PyList_New(vars_c);
  int ok = vlist != NULL;
  for (int i = 0; ok && i < vars_c; i++) {
    PyObject* v = PyLong_FromLong(vars[i]);
    if (!v) ok = 0;
    else PyList_SET_ITEM(vlist, i, v); /* steals */
  }
  PyObject* r = NULL;
  if (stack && Ca && ok)
    r = PyObject_CallMethod((PyObject*)prog, "AddSparseLMIConstraint", "OOO",
                            stack, Ca, vlist);
  Py_XDECREF(stack);
  Py_XDECREF(Ca);
  Py_XDECREF(vlist);
  return added(st, (PyObject*)prog, r);
}

static PyObject* config_to_py(const CONEX_SolverConfiguration* c) {
  PyObject* mod = PyImport_ImportModule("conex_tpu_torch");
  if (!mod) return NULL;
  PyObject* cls = PyObject_GetAttrString(mod, "SolverConfig");
  Py_DECREF(mod);
  if (!cls) return NULL;
  PyObject* kwargs = Py_BuildValue(
      "{s:i,s:i,s:d,s:d,s:d,s:d,s:i,s:d,s:i,s:d,s:i,s:i,s:d,s:i,s:i,s:d,"
      "s:d,s:i,s:i}",
      "prepare_dual_variables", c->prepare_dual_variables,
      "initialization_mode", c->initialization_mode,
      "inv_sqrt_mu_max", c->inv_sqrt_mu_max,
      "minimum_mu", c->minimum_mu,
      "maximum_mu", c->maximum_mu,
      "divergence_upper_bound", c->divergence_upper_bound,
      "enable_line_search", c->enable_line_search,
      "dinf_upper_bound", c->dinf_upper_bound,
      "final_centering_steps", c->final_centering_steps,
      "final_centering_tolerance", c->final_centering_tolerance,
      "initial_centering_steps_warmstart",
      c->initial_centering_steps_warmstart,
      "initial_centering_steps_coldstart",
      c->initial_centering_steps_coldstart,
      "warmstart_abort_threshold", c->warmstart_abort_threshold,
      "max_iterations", c->max_iterations,
      "iterative_refinement_iterations", c->iterative_refinement_iterations,
      "infeasibility_threshold", c->infeasibility_threshold,
      "kkt_error_tolerance", c->kkt_error_tolerance,
      "enable_rescaling", c->enable_rescaling,
      "kkt_solver", c->kkt_solver);
  PyObject* out = NULL;
  if (kwargs) {
    PyObject* empty = PyTuple_New(0);
    if (empty) out = PyObject_Call(cls, empty, kwargs);
    Py_XDECREF(empty);
    Py_DECREF(kwargs);
  }
  Py_DECREF(cls);
  return out;
}

void CONEX_SetDefaultOptions(CONEX_SolverConfiguration* c) {
  /* Reference defaults (interfaces/conex.cc:231-257 via cone_program.h). */
  memset(c, 0, sizeof(*c));
  c->prepare_dual_variables = 0;
  c->initialization_mode = 0;
  c->inv_sqrt_mu_max = 1000;
  c->minimum_mu = 1e-15;
  c->maximum_mu = 1e4;
  c->divergence_upper_bound = 1;
  c->enable_line_search = 0;
  c->dinf_upper_bound = 1;
  c->final_centering_steps = 5;
  c->final_centering_tolerance = .01;
  c->initial_centering_steps_warmstart = 0;
  c->initial_centering_steps_coldstart = 0;
  c->warmstart_abort_threshold = 2;
  c->max_iterations = 25;
  c->iterative_refinement_iterations = 0;
  c->infeasibility_threshold = 1e5;
  c->kkt_error_tolerance = 1e10;
  c->enable_rescaling = 1;
  c->kkt_solver = 0;
}

/* With the GIL held: solve through `method` ("Maximize" with the cost b,
 * or "Solve" where b is NULL) and copy the Solution's y out; returns its
 * solved status, or -1 with a Python error set. */
static int solve(PyObject* prog, const char* method, PyObject* b,
                 const CONEX_SolverConfiguration* config, double* y, int yr) {
  PyObject* cfg = config_to_py(config);
  if (!cfg) return -1;
  PyObject* sol = b ? PyObject_CallMethod(prog, method, "OO", b, cfg)
                    : PyObject_CallMethod(prog, method, "O", cfg);
  Py_DECREF(cfg);
  if (!sol) return -1;
  int solved = -1;
  PyObject* status = PyObject_GetAttrString(sol, "status");
  PyObject* yo = status ? PyObject_GetAttrString(sol, "y") : NULL;
  if (yo && copy_out(yo, "C", y, yr) == 0) solved = PyObject_IsTrue(status);
  Py_XDECREF(status);
  Py_XDECREF(yo);
  Py_DECREF(sol);
  return solved;
}

int CONEX_Maximize(void* prog, const double* b, int br,
                   const CONEX_SolverConfiguration* config, double* y,
                   int yr) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* ba = np_array(b, 0, br, 0);
  int solved = ba ? solve((PyObject*)prog, "Maximize", ba, config, y, yr) : -1;
  Py_XDECREF(ba);
  if (solved < 0) return fail(st);
  PyGILState_Release(st);
  return solved;
}

int CONEX_Solve(void* prog, const CONEX_SolverConfiguration* config,
                double* y, int yr) {
  PyGILState_STATE st = PyGILState_Ensure();
  int solved = solve((PyObject*)prog, "Solve", NULL, config, y, yr);
  if (solved < 0) return fail(st);
  PyGILState_Release(st);
  return solved;
}

int CONEX_GetDualVariableSize(void* prog, int i) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* x = PyObject_CallMethod((PyObject*)prog, "GetDualVariable", "i", i);
  if (!x) return fail(st) - 2; /* -1 */
  PyObject* sz = PyObject_GetAttrString(x, "size");
  int out = sz ? (int)PyLong_AsLong(sz) : -1;
  Py_XDECREF(sz);
  Py_DECREF(x);
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(st);
  return out;
}

void CONEX_GetDualVariable(void* prog, int i, double* x, int xr, int xc) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* xa =
      PyObject_CallMethod((PyObject*)prog, "GetDualVariable", "i", i);
  /* column-major output, matching the reference's Eigen::Map fill */
  if (xa) {
    copy_out(xa, "F", x, (Py_ssize_t)xr * xc);
    Py_DECREF(xa);
  }
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(st);
}

void CONEX_GetIterationStats(void* prog, CONEX_IterationStats* stats,
                             int iter_num) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* s = PyObject_CallMethod((PyObject*)prog, "GetIterationNumberStats",
                                    "i", iter_num);
  if (s) {
    PyObject* mu = PyObject_GetAttrString(s, "mu");
    PyObject* it = PyObject_GetAttrString(s, "iteration_number");
    if (mu) stats->mu = PyFloat_AsDouble(mu);
    if (it) stats->iteration_number = (int)PyLong_AsLong(it);
    Py_XDECREF(mu);
    Py_XDECREF(it);
    Py_DECREF(s);
  }
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(st);
}

/* Call `method` with one or two int arguments (b_ < 0: one) and store the
 * id it returns. */
static CONEX_STATUS new_constraint(void* prog, const char* method, int a,
                                   int b_, int* constraint_id) {
  if (!constraint_id) return CONEX_FAILURE;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = b_ >= 0 ? PyObject_CallMethod((PyObject*)prog, method, "ii", a, b_)
                        : PyObject_CallMethod((PyObject*)prog, method, "i", a);
  if (!r) return fail(st);
  *constraint_id = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  if (PyErr_Occurred()) return fail(st);
  PyGILState_Release(st);
  return CONEX_SUCCESS;
}

CONEX_STATUS CONEX_NewLinearMatrixInequality(void* prog, int order,
                                             int hyper_complex_dim,
                                             int* constraint_id) {
  return new_constraint(prog, "NewLinearMatrixInequality", order,
                        hyper_complex_dim, constraint_id);
}

CONEX_STATUS CONEX_NewLorentzConeConstraint(void* prog, int order,
                                            int* constraint_id) {
  return new_constraint(prog, "NewLorentzConeConstraint", order, -1,
                        constraint_id);
}

CONEX_STATUS CONEX_NewLinearInequality(void* prog, int num_rows,
                                       int* constraint_id) {
  return new_constraint(prog, "NewLinearInequality", num_rows, -1,
                        constraint_id);
}

CONEX_STATUS CONEX_UpdateLinearOperator(void* prog, int constraint,
                                        double value, int variable, int row,
                                        int col, int hyper_complex_dim) {
  PyGILState_STATE st = PyGILState_Ensure();
  return done(st, PyObject_CallMethod((PyObject*)prog, "UpdateLinearOperator",
                                      "idiiii", constraint, value, variable,
                                      row, col, hyper_complex_dim));
}

CONEX_STATUS CONEX_NewQuadraticCost(void* prog, int* constraint_id) {
  if (!constraint_id) return CONEX_FAILURE;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod((PyObject*)prog, "NewQuadraticCost", NULL);
  if (!r) return fail(st);
  *constraint_id = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  if (PyErr_Occurred()) return fail(st);
  PyGILState_Release(st);
  return CONEX_SUCCESS;
}

CONEX_STATUS CONEX_UpdateQuadraticCostMatrix(void* prog, int constraint_id,
                                             double value, int row, int col) {
  PyGILState_STATE st = PyGILState_Ensure();
  return done(st, PyObject_CallMethod((PyObject*)prog,
                                      "UpdateQuadraticCostMatrix", "idii",
                                      constraint_id, value, row, col));
}

CONEX_STATUS CONEX_UpdateAffineTerm(void* prog, int constraint, double value,
                                    int row, int col, int hyper_complex_dim) {
  PyGILState_STATE st = PyGILState_Ensure();
  return done(st, PyObject_CallMethod((PyObject*)prog, "UpdateAffineTerm",
                                      "idiii", constraint, value, row, col,
                                      hyper_complex_dim));
}
