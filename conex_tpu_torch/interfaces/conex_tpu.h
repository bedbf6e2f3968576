/* conex_tpu_torch C ABI: the port's copy of interfaces/conex_tpu.h, the
 * drop-in mirror of the reference C API (interfaces/conex.h:41-99).  Every
 * CONEX_* symbol, argument convention (column-major matrices, LMI operators
 * as m consecutive column-major n x n blocks) and struct layout is
 * unchanged, so a C or MATLAB (loadlibrary) caller switches library and
 * changes nothing else.  One symbol is added:
 * CONEX_CreateConeProgramOnDevice.
 *
 * The implementation (conex_tpu_torch_c.c) embeds CPython and drives
 * conex_tpu_torch.interface.Conex, so the solves run on the card.
 * Build: python3 -m conex_tpu_torch.interfaces (prints this header's path
 * and the library's: conex_tpu_torch/_build/libconex_tpu_torch.so).
 */
#ifndef CONEX_TPU_TORCH_API_H
#define CONEX_TPU_TORCH_API_H
#ifdef __cplusplus
extern "C" {
#endif

typedef int CONEX_STATUS;
enum { CONEX_SUCCESS = 0, CONEX_FAILURE = 1 };

typedef struct {
  int prepare_dual_variables;
  int initialization_mode;
  double inv_sqrt_mu_max;
  double minimum_mu;
  double maximum_mu;
  double divergence_upper_bound;
  int enable_line_search;
  double dinf_upper_bound;
  int final_centering_steps;
  double final_centering_tolerance;
  int initial_centering_steps_warmstart;
  int initial_centering_steps_coldstart;
  double warmstart_abort_threshold;
  int max_iterations;
  int iterative_refinement_iterations;
  double infeasibility_threshold;
  double kkt_error_tolerance;
  int enable_rescaling;
  int kkt_solver;
} CONEX_SolverConfiguration;

typedef struct {
  double mu;
  int iteration_number;
} CONEX_IterationStats;

/* reference: interfaces/conex.h:37-39 (declared, unused by the reference
 * implementation; mirrored for struct-layout parity). */
typedef struct {
  int iterations;
} CONEX_SolutionStats;

/* A program whose solves run on the card: CONEX_CreateConeProgramOnDevice
 * with "cuda". */
void* CONEX_CreateConeProgram(void);
/* A program whose solves run on `device`, a torch device string such as
 * "cuda", "cuda:1" or "cpu".  Returns NULL, with the Python traceback on
 * stderr, when conex_tpu_torch cannot be imported. */
void* CONEX_CreateConeProgramOnDevice(const char* device);
void CONEX_DeleteConeProgram(void*);

int CONEX_AddDenseLinearConstraint(void* prog, const double* A, int Ar,
                                   int Ac, const double* c, int cr);

/* Box constraints lb <= A y <= ub, split into normalized one-sided
 * inequalities + equalities (reference interfaces/conex.h:47-49,
 * PreprocessLinearInequality).  Returns -1 (matching the reference's
 * placeholder id, interfaces/conex.cc:213-214). */
int CONEX_AddLinearInequalities(void* prog, const double* A, int Ar, int Ac,
                                const double* lb, int num_lb,
                                const double* ub, int num_ub);

/* Adds -1/2 y'Ay to the maximized objective (reference
 * interfaces/conex.h:51).  Solving then requires enable_line_search and
 * !enable_rescaling. */
int CONEX_AddQuadraticCost(void* prog, const double* A, int Ar, int Ac);

int CONEX_AddDenseLMIConstraint(void* prog, const double* Aarray, int Ar,
                                int Ac, int m, const double* cmat, int cr,
                                int cc);

/* LMI over the variable subset `vars` (length vars_c == m), reference
 * interfaces/conex.h:59-61. */
int CONEX_AddSparseLMIConstraint(void* prog, const double* Aarray, int Ar,
                                 int Ac, int m, const double* cmat, int cr,
                                 int cc, const long* vars, int vars_c);

int CONEX_Maximize(void* prog, const double* b, int br,
                   const CONEX_SolverConfiguration* config, double* y,
                   int yr);

/* Solve with the accumulated cost terms (quadratic costs and the zero
 * linear cost), reference interfaces/conex.h:66-67. */
int CONEX_Solve(void* prog, const CONEX_SolverConfiguration* config,
                double* y, int yr);

int CONEX_GetDualVariableSize(void* prog, int i);
void CONEX_GetDualVariable(void* prog, int i, double* x, int xr, int xc);

void CONEX_SetDefaultOptions(CONEX_SolverConfiguration* config);

void CONEX_GetIterationStats(void* prog, CONEX_IterationStats* stats,
                             int iter_num);

CONEX_STATUS CONEX_SetNumberOfVariables(void* prog, int m);

CONEX_STATUS CONEX_NewLinearMatrixInequality(void* prog, int order,
                                             int hyper_complex_dim,
                                             int* constraint_id);
CONEX_STATUS CONEX_NewLorentzConeConstraint(void* prog, int order,
                                            int* constraint_id);
CONEX_STATUS CONEX_NewLinearInequality(void* prog, int num_rows,
                                       int* constraint_id);
CONEX_STATUS CONEX_UpdateLinearOperator(void* prog, int constraint,
                                        double value, int variable, int row,
                                        int col, int hyper_complex_dim);
CONEX_STATUS CONEX_UpdateAffineTerm(void* prog, int constraint, double value,
                                    int row, int col, int hyper_complex_dim);

/* Incremental quadratic cost: register an all-zero m x m cost, then fill
 * entries (reference interfaces/conex.h:95-97). */
CONEX_STATUS CONEX_NewQuadraticCost(void* prog, int* constraint_id);
CONEX_STATUS CONEX_UpdateQuadraticCostMatrix(void* prog, int constraint_id,
                                             double value, int row, int col);

#ifdef __cplusplus
}
#endif
#endif
