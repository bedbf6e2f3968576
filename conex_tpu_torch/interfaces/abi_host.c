/* abi_host: a plain C program that solves one LMI through the port's C
 * ABI, as a C or MATLAB caller does: it starts with no Python interpreter
 * and calls only CONEX_* symbols of conex_tpu.h.
 *
 *   abi_host <program file> <dense|incremental> [device]
 *
 * The program file holds float64 values, native byte order: m, n, then
 * the m column-major n x n blocks A_1..A_m, the n x n matrix C
 * (column-major) and the m entries of b.  The program is
 *   maximize b'y  s.t.  C - sum_i y_i A_i  PSD,
 * built with CONEX_AddDenseLMIConstraint ("dense") or entry by entry
 * ("incremental": CONEX_NewLinearMatrixInequality, then
 * CONEX_UpdateLinearOperator on the lower triangle of every A_i and
 * CONEX_UpdateAffineTerm on the lower triangle of C), and solved by
 * CONEX_Maximize on `device` (default "cuda") under the default options
 * with max_iterations = 100 and prepare_dual_variables = 1.
 *
 * Prints one JSON line: solved, y (17 significant digits), and the walls
 * of the program's creation (the interpreter's start and the imports), of
 * its build and of the solve, by the C clock.  Exits 0 when the solve
 * returned (solved or not), 1 on a failure of the ABI or of the input.
 *
 * Build: conex_tpu_torch.interfaces.build_host(); it links the library
 * with an rpath, and the process finds conex_tpu_torch and torch through
 * PYTHONPATH (interfaces.host_environment()).
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "conex_tpu.h"

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

static int die(const char* msg) {
  fprintf(stderr, "abi_host: %s\n", msg);
  return 1;
}

int main(int argc, char** argv) {
  if (argc < 3 || argc > 4)
    return die("usage: abi_host <program file> <dense|incremental> [device]");
  int incremental = strcmp(argv[2], "incremental") == 0;
  if (!incremental && strcmp(argv[2], "dense") != 0)
    return die("the build is \"dense\" or \"incremental\"");
  const char* device = argc == 4 ? argv[3] : "cuda";

  FILE* f = fopen(argv[1], "rb");
  if (!f) return die("cannot open the program file");
  double dims[2];
  if (fread(dims, sizeof(double), 2, f) != 2) return die("no m, n");
  int m = (int)dims[0], n = (int)dims[1];
  if (m < 1 || n < 1 || m != dims[0] || n != dims[1])
    return die("m and n must be positive integers");
  size_t count = (size_t)m * n * n + (size_t)n * n + (size_t)m;
  double* data = malloc(count * sizeof(double));
  double* y = calloc((size_t)m, sizeof(double));
  if (!data || !y) return die("out of memory");
  if (fread(data, sizeof(double), count, f) != count)
    return die("the program file is shorter than m and n say");
  fclose(f);
  const double* A = data;
  const double* C = A + (size_t)m * n * n;
  const double* b = C + (size_t)n * n;

  double t0 = now();
  void* prog = CONEX_CreateConeProgramOnDevice(device);
  if (!prog) return die("CONEX_CreateConeProgramOnDevice failed");
  double t1 = now();
  if (CONEX_SetNumberOfVariables(prog, m) != CONEX_SUCCESS)
    return die("CONEX_SetNumberOfVariables failed");
  if (incremental) {
    int id = -1;
    if (CONEX_NewLinearMatrixInequality(prog, n, 1, &id) != CONEX_SUCCESS)
      return die("CONEX_NewLinearMatrixInequality failed");
    for (int v = 0; v < m; v++)
      for (int j = 0; j < n; j++)
        for (int i = j; i < n; i++)
          if (CONEX_UpdateLinearOperator(prog, id,
                                         A[(size_t)v * n * n + (size_t)j * n + i],
                                         v, i, j, 0) != CONEX_SUCCESS)
            return die("CONEX_UpdateLinearOperator failed");
    for (int j = 0; j < n; j++)
      for (int i = j; i < n; i++)
        if (CONEX_UpdateAffineTerm(prog, id, C[(size_t)j * n + i], i, j, 0) !=
            CONEX_SUCCESS)
          return die("CONEX_UpdateAffineTerm failed");
  } else if (CONEX_AddDenseLMIConstraint(prog, A, n, n, m, C, n, n) != 0) {
    return die("CONEX_AddDenseLMIConstraint failed");
  }
  double t2 = now();

  CONEX_SolverConfiguration config;
  CONEX_SetDefaultOptions(&config);
  config.max_iterations = 100;
  config.prepare_dual_variables = 1;
  int solved = CONEX_Maximize(prog, b, m, &config, y, m);
  double t3 = now();
  CONEX_DeleteConeProgram(prog);

  printf("{\"build\": \"%s\", \"device\": \"%s\", \"solved\": %d, \"y\": [",
         argv[2], device, solved);
  for (int i = 0; i < m; i++) printf(i ? ", %.17g" : "%.17g", y[i]);
  printf("], \"create_s\": %.6f, \"build_s\": %.6f, \"solve_s\": %.6f}\n",
         t1 - t0, t2 - t1, t3 - t2);
  free(data);
  free(y);
  return 0;
}
