% conex_tpu_torch — SeDuMi-compatible entry point over libconex_tpu_torch.so.
%
%   [x, y, info] = conex_tpu_torch(A, b, c, K)          % on the card
%   [x, y, info] = conex_tpu_torch(A, b, c, K, 'cpu')   % on the CPU
%
% Twin of interfaces/matlab/conex_tpu.m (the counterpart of the reference's
% interfaces/matlab/conex.m:1-2, a drop-in sedumi.m replacement), pointed
% at the PyTorch port through ConexTpuTorchProgram.  Supported cones: K.l
% (nonnegative orthant) and K.s (PSD blocks, any count).  K.f/K.q/K.r are
% not supported: use the Python front end conex_tpu_torch.sedumi.
% solve_sedumi, which carries the full preprocessing pipeline.
%
% SeDuMi convention: A is m x N with one row per primal variable y_i,
% columns indexing the vectorized cone variables [l-part, vec(s-blocks)];
% solves  max b'y  s.t.  c - A'y in K,  returning the cone dual x
% (Ax = b, x in K) and primal y.
function [x, y, info] = conex_tpu_torch(A, b, c, K, device)
  if nargin < 5; device = 'cuda'; end
  if ~isfield(K, 'l'); K.l = 0; end
  if isfield(K, 'f') && any(K.f > 0)
    error('K.f not supported here; use conex_tpu_torch.sedumi (Python).');
  end
  if isfield(K, 'q') && any(K.q > 0)
    error('K.q not supported here; use conex_tpu_torch.sedumi (Python).');
  end
  if isfield(K, 'r') && any(K.r > 0)
    error('K.r not supported here; use conex_tpu_torch.sedumi (Python).');
  end

  m = size(A, 1);
  c = full(c(:));
  b = full(b(:));
  p = ConexTpuTorchProgram(m, device);

  offset = 0;
  if K.l > 0
    p.AddLinearInequality(A(:, 1:K.l)', c(1:K.l));
    offset = K.l;
  end
  if isfield(K, 's')
    for i = 1:length(K.s)
      n = K.s(i);
      cols = offset + (1:n*n);
      % Symmetrize each operator matrix (SeDuMi stores possibly
      % asymmetric vec'd blocks; the LMI needs the symmetric part).
      Ablk = zeros(n, n * m);
      for j = 1:m
        M = reshape(full(A(j, cols)), n, n);
        Ablk(:, (j-1)*n + (1:n)) = 0.5 * (M + M');
      end
      Cm = reshape(c(cols), n, n);
      Cm = 0.5 * (Cm + Cm');
      p.AddDenseLinearMatrixInequality(Ablk, Cm);
      offset = offset + n * n;
    end
  end

  p.options.inv_sqrt_mu_max = 1000;
  p.options.infeasibility_threshold = 1e3;
  p.options.max_iterations = 25;
  p.options.prepare_dual_variables = 1;
  p.options.divergence_upper_bound = 1;
  p.options.final_centering_steps = 5;

  info = struct('numerr', 0, 'pinf', 0, 'dinf', 0, 'feasratio', 1, ...
                'cpusec', 0);
  tic;
  [y, duals, solved] = p.Maximize(b);
  info.cpusec = toc;
  info.pinf = ~solved;
  info.dinf = ~solved;

  % Reassemble the SeDuMi-format cone dual x from the per-block duals.
  x = zeros(K.l + sum(getfield_default(K, 's', []).^2), 1);
  offset = 0;
  bi = 1;
  if K.l > 0
    x(1:K.l) = duals{bi};
    offset = K.l;
    bi = bi + 1;
  end
  if isfield(K, 's')
    for i = 1:length(K.s)
      n = K.s(i);
      x(offset + (1:n*n)) = reshape(duals{bi}, n*n, 1);
      offset = offset + n * n;
      bi = bi + 1;
    end
  end
end

function v = getfield_default(s, f, d)
  if isfield(s, f); v = s.(f); else; v = d; end
end
