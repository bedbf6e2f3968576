% ConexTpuTorchProgram — MATLAB/Octave handle over libconex_tpu_torch.so.
%
% Twin of interfaces/matlab/ConexTpuProgram.m (the counterpart of the
% reference's util/ConexProgram.m:28-38): the same loadlibrary/calllib
% pattern against the same CONEX_* ABI, pointed at the PyTorch port's
% library, so the solves run on the card.  The library is built by
%   python3 -m conex_tpu_torch.interfaces
% into conex_tpu_torch/_build/libconex_tpu_torch.so and loaded here with the
% port's header (conex_tpu_torch/interfaces/conex_tpu.h) under the alias
% libconex_tpu_torch.  MATLAB's process starts the embedded Python, which
% finds conex_tpu_torch and torch through PYTHONPATH (the repository root
% and the site-packages of the Python the library was built for).
%
% ConexTpuTorchProgram(num_vars) solves on the card; ConexTpuTorchProgram(
% num_vars, 'cpu') on the CPU.  Every method maps to one extern-C symbol;
% tests/test_torch_matlab_twin.py drives the identical call sequence
% through ctypes, so the shim's data layout is validated without a MATLAB
% runtime.
classdef ConexTpuTorchProgram < handle
  properties(Access=private)
    p
    constraints
  end

  properties(Access=public)
    options
  end

  methods(Static)
    function [m, n] = VerifyLMIData(A, c)
      % A: n x (n*m) horizontal stack of the m operator matrices; c: n x n.
      if size(c, 2) ~= size(c, 1)
        error('Affine term c must be a square matrix.')
      end
      n = size(c, 1);
      if n == 0 || mod(size(A, 2), n) ~= 0 || size(A, 1) ~= n
        error('LMI matrices have incompatible dimensions.')
      end
      m = size(A, 2) / n;
    end
  end

  methods
    function self = ConexTpuTorchProgram(num_vars, device)
      if nargin < 2
        device = 'cuda';
      end
      if ~libisloaded('libconex_tpu_torch')
        interfaces = fileparts(fileparts(mfilename('fullpath')));
        loadlibrary(fullfile(fileparts(interfaces), '_build', ...
                             'libconex_tpu_torch.so'), ...
                    fullfile(interfaces, 'conex_tpu.h'), ...
                    'alias', 'libconex_tpu_torch');
      end
      self.p = calllib('libconex_tpu_torch', ...
        'CONEX_CreateConeProgramOnDevice', device);
      calllib('libconex_tpu_torch', 'CONEX_SetNumberOfVariables', self.p, num_vars);
      self.options = libstruct('CONEX_SolverConfiguration');
      % Touch a field so MATLAB allocates the struct before the C write.
      self.options.divergence_upper_bound = 1;
      calllib('libconex_tpu_torch', 'CONEX_SetDefaultOptions', self.options);
      self.options.prepare_dual_variables = 1;
      self.constraints = [];
    end

    function delete(self)
      calllib('libconex_tpu_torch', 'CONEX_DeleteConeProgram', self.p);
    end

    function AddLinearInequality(self, A, c)
      % c - A y >= 0 elementwise.
      num_var = size(A, 2);
      rows = size(A, 1);
      Aptr = libpointer('doublePtr', full(A(:)));
      cptr = libpointer('doublePtr', full(c));
      self.constraints(end + 1) = calllib('libconex_tpu_torch', ...
        'CONEX_AddDenseLinearConstraint', self.p, Aptr, rows, num_var, ...
        cptr, rows);
    end

    function AddLinearInequalities(self, A, lb, ub)
      % Box constraints lb <= A y <= ub (split + normalized in the solver).
      rows = size(A, 1);
      cols = size(A, 2);
      Aptr = libpointer('doublePtr', full(A(:)));
      lptr = libpointer('doublePtr', full(lb));
      uptr = libpointer('doublePtr', full(ub));
      calllib('libconex_tpu_torch', 'CONEX_AddLinearInequalities', self.p, ...
        Aptr, rows, cols, lptr, rows, uptr, rows);
    end

    function AddQuadraticCost(self, Q)
      n = size(Q, 1);
      Qptr = libpointer('doublePtr', full(Q(:)));
      calllib('libconex_tpu_torch', 'CONEX_AddQuadraticCost', self.p, Qptr, n, n);
    end

    function AddLinearMatrixInequality(self, A, c, variables)
      if nargin < 4
        self.AddDenseLinearMatrixInequality(A, c)
      else
        self.AddSparseLinearMatrixInequality(A, c, variables)
      end
    end

    function AddDenseLinearMatrixInequality(self, A, c)
      [m, n] = ConexTpuTorchProgram.VerifyLMIData(A, c);
      Aptr = libpointer('doublePtr', full(A(:)));
      cptr = libpointer('doublePtr', full(c));
      self.constraints(end + 1) = calllib('libconex_tpu_torch', ...
        'CONEX_AddDenseLMIConstraint', self.p, Aptr, n, n, m, cptr, n, n);
    end

    function AddSparseLinearMatrixInequality(self, A, c, vars)
      % vars: zero-based variable indices, one per operator matrix.
      [m, n] = ConexTpuTorchProgram.VerifyLMIData(A, c);
      Aptr = libpointer('doublePtr', full(A(:)));
      cptr = libpointer('doublePtr', full(c));
      vptr = libpointer('longPtr', int64(full(vars(:))));
      self.constraints(end + 1) = calllib('libconex_tpu_torch', ...
        'CONEX_AddSparseLMIConstraint', self.p, Aptr, n, n, m, cptr, n, n, ...
        vptr, m);
    end

    function x = GetDualVariable(self, i)
      sz = calllib('libconex_tpu_torch', 'CONEX_GetDualVariableSize', self.p, i);
      xptr = libpointer('doublePtr', zeros(sz, 1));
      calllib('libconex_tpu_torch', 'CONEX_GetDualVariable', self.p, i, xptr, sz, 1);
      x = xptr.Value;
    end

    function [y, x, status] = Maximize(self, b)
      if size(b, 2) > 1 && size(b, 1) > 1
        error('Cost must be a vector.')
      end
      num_var = length(b);
      bptr = libpointer('doublePtr', full(b));
      yptr = libpointer('doublePtr', zeros(num_var, 1));
      status = calllib('libconex_tpu_torch', 'CONEX_Maximize', self.p, bptr, ...
        num_var, self.options, yptr, num_var);
      x = {};
      for i = 1:length(self.constraints)
        x{i} = self.GetDualVariable(self.constraints(i));
      end
      y = yptr.Value;
    end

    function [y, status] = Solve(self, num_var)
      % Solve with the accumulated cost terms (QP path; CONEX_Solve).
      yptr = libpointer('doublePtr', zeros(num_var, 1));
      status = calllib('libconex_tpu_torch', 'CONEX_Solve', self.p, ...
        self.options, yptr, num_var);
      y = yptr.Value;
    end

    function stats = GetIterationStats(self, iter_num)
      s = libstruct('CONEX_IterationStats');
      s.mu = 0;
      calllib('libconex_tpu_torch', 'CONEX_GetIterationStats', self.p, s, iter_num);
      stats.mu = s.mu;
      stats.iteration_number = s.iteration_number;
    end
  end
end
