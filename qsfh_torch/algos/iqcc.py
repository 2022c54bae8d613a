"""iQCC driver: iterative qubit-coupled-cluster with Hamiltonian dressing.

Counterpart of ``qsfh_tpu/algos/iqcc.py`` (class IQCC: the reference's
molecular ``iqcc.py`` and lattice ``iqcc_hubbard.py`` drivers) with the
same constructor arguments plus ``device``, the same ``run()``,
``select_operator()``, checkpoint files (``theta, phi, tau, H_x, H_z,
H_c``, the meta and the ``.dense.npy`` sidecar), metrics log and printed
lines.  Each epoch:

* DIS screening: one generator per flip mask of the (dressed) Hamiltonian
  (``ops.dressing.dis_generators``, or from the dense matrix,
  ``ops.dense_dressing.dense_dis_generators``), screened at the product
  state in one ``PackedPool.screen_scan`` pass with w = H psi;
* the selected rotations exp(-i tau_k P_k / 2) on the product state
  RZ(phi) RY(theta)|0> as ONE rot segment, differentiable in tau and in
  psi0 (``engine.compiled.rot_segment``: the resident or tile-run kernels
  forward, the adjoint sweep backward; the JAX driver unrolls gates below
  24 selections, an XLA compile-time choice not carried over), trained by
  ``torch.optim.Adam`` or an Adam warm-up and then ``torch.optim.LBFGS``
  with a strong-Wolfe line search, one iteration per call;
* the optimized rotations folded into the Hamiltonian: symbolically on the
  host (``ops.dressing``) or as the dense complex128 matrix on the device
  (``ops.dense_dressing``), then the optional ILC folds (``ops.ilc``).

The energy is ``Observable.expectation_auto`` (the inner-product tiles
forward, the application tiles for the cotangent) or, with
``dense_dressing``, a matvec with the matrix in the state's dtype.
``epoch_stats`` keeps, per epoch, the selection's sizes and the host-clock
milliseconds of each phase (the device synchronized at each phase's ends).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..engine.compiled import lower_program, rot_segment
from ..engine.expectation import Observable, PackedPool
from ..engine.kernels import INNER_TILE_MIN_BITS, KERNELS
from ..engine.state import real_dtype
from ..io import checkpoint as ckpt
from ..io.metrics import MetricsLogger, plot_energy_iterations
from ..ops.dense_dressing import (
    DenseObservable,
    dense_dis_generators,
    dressing_unitary,
    paulisum_to_dense_fast,
    similarity,
)
from ..ops.dressing import dis_generators, dress_hamiltonian
from ..ops.fermion import FermionOperator
from ..ops.ilc import ilc_step_dense
from ..ops.jw import jordan_wigner
from ..ops.pauli import PauliSum
from .base import default_dtype, resolve_device


def product_state(thetas, phis, n_qubits: int, dtype=None) -> torch.Tensor:
    """|psi> = prod_i RZ(phi_i) RY(theta_i) |0> as one Kronecker chain,
    differentiable in thetas and phis.

    RY(t)|0> = cos(t/2)|0> + sin(t/2)|1>, RZ(p) = diag(e^{-ip/2}, e^{ip/2});
    qubit 0 is the most significant index bit.  ``dtype`` defaults to the
    complex dtype of the angles'."""
    half_t = thetas / 2
    half_p = phis / 2
    amp0 = torch.cos(half_t) * torch.exp(-1j * half_p)
    amp1 = torch.sin(half_t) * torch.exp(1j * half_p)
    spinors = torch.stack([amp0, amp1], dim=1)
    if dtype is not None:
        spinors = spinors.to(dtype)
    psi = spinors[0]
    for i in range(1, n_qubits):
        psi = (psi[:, None] * spinors[i][None, :]).reshape(-1)
    return psi


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _global_norm(tensors) -> float:
    return float(torch.sqrt(sum((t.grad.to(torch.float64) ** 2).sum() for t in tensors)))


class IQCC:
    def __init__(
        self,
        hamiltonian,
        n_epoch: int,
        lr: float,
        threshold: float,
        n_qubits: Optional[int] = None,
        n_electrons: Optional[int] = None,
        ratio: float = 0.1,
        max_inner_iterations: int = 10000,
        inner_optimizer: str = "adam",
        max_terms: Optional[int] = None,
        compaction_eps: Optional[float] = None,
        dense_dressing: bool = False,
        ilc: bool = False,
        ilc_cap: int = 32,
        ilc_rounds: int = 2,
        ilc_min_gain: float = 1e-7,
        reference_energy: Optional[float] = None,
        ground_truth: bool = True,
        dtype=None,
        results_root: str = "./results",
        tag: str = "IQCC",
        plot: bool = True,
        log_metrics: bool = True,
        load_model: bool = False,
        device=None,
    ):
        """``hamiltonian``: a FermionOperator (JW-mapped here), a PauliSum or
        a Molecule (tracked against its FCI energy).  ``reference_energy``
        overrides the ground truth; otherwise ``ground_truth=True`` takes
        the lowest eigenvalue of the full-space matrix (no sector
        restriction, at most 14 qubits) on ``device``.  ``device``: ``cuda``
        by default (raises where none exists)."""
        self.device = resolve_device(device)
        if hasattr(hamiltonian, "get_molecular_hamiltonian"):
            molecule = hamiltonian
            hamiltonian = molecule.get_molecular_hamiltonian()
            if n_electrons is None:
                n_electrons = molecule.n_electrons
            if reference_energy is None and molecule.fci_energy is not None:
                reference_energy = molecule.fci_energy
        qubit_h = jordan_wigner(hamiltonian) if isinstance(hamiltonian, FermionOperator) \
            else hamiltonian
        self.initial_hamiltonian = qubit_h
        self.current_hamiltonian = qubit_h.copy()
        self.n_qubits = n_qubits or qubit_h.n_qubits()
        self.n_electrons = n_electrons if n_electrons is not None else self.n_qubits // 2
        self.n_epoch = n_epoch
        self.lr = lr
        self.threshold = threshold
        self.ratio = ratio
        self.max_inner_iterations = max_inner_iterations
        if inner_optimizer not in ("adam", "lbfgs"):
            raise ValueError("inner_optimizer must be 'adam' or 'lbfgs'")
        self.inner_optimizer = inner_optimizer
        self.max_terms = max_terms
        self.compaction_eps = compaction_eps
        self.compaction_bound = 0.0
        self.dense_dressing = bool(dense_dressing)
        if self.dense_dressing and self.n_qubits > 14:
            raise ValueError("dense_dressing is a <=14-qubit backend (4^n memory)")
        self.ilc = bool(ilc)
        if self.ilc and not self.dense_dressing:
            raise ValueError("ilc=True requires dense_dressing=True")
        self.ilc_cap = int(ilc_cap)
        self.ilc_rounds = int(ilc_rounds)
        self.ilc_min_gain = float(ilc_min_gain)
        self._dense_h = None  # the dressed complex128 matrix on the device
        self._dense_nnz = None
        self.plot = plot
        self.dtype = dtype or default_dtype(self.device)
        self._rdt = real_dtype(self.dtype)
        # the kernel wrappers; a reference run on the card may set
        # engine.kernels.PLAIN
        self.impl = KERNELS
        self.epoch_stats: List[dict] = []
        self._stats: dict = {}

        if reference_energy is not None:
            self.ground_state_energy = float(reference_energy)
        elif ground_truth:
            self.ground_state_energy = self._dense_ground_energy(qubit_h)
        else:
            self.ground_state_energy = None

        self.img_filepath = f"./images/{tag}.png"
        self.result_filepath = os.path.join(results_root, "vqe_results", tag + ".json")
        self.model_filepath = os.path.join(results_root, "saved_model", tag + ".npz")
        self.metrics = MetricsLogger(
            os.path.join(results_root, "vqe_results", tag + ".jsonl") if log_metrics else None
        )

        if load_model:
            self.load_model()
        else:
            # theta = pi on the first n_electrons wires (reference iqcc.py:39)
            self.params = {
                "theta": self._param([np.pi] * self.n_electrons
                                     + [0.0] * (self.n_qubits - self.n_electrons)),
                "phi": self._param(np.zeros(self.n_qubits)),
                "tau": self._param(np.zeros(0)),
            }
            self.loss_history = {"iteration": [], "epoch": []}
            self.selected_ops: List[str] = []

    def _param(self, values) -> torch.Tensor:
        """A trainable leaf tensor of the real dtype on the device."""
        return torch.tensor(np.asarray(values, dtype=np.float64), dtype=self._rdt,
                            device=self.device).requires_grad_(True)

    def _dense_ground_energy(self, qubit_h: PauliSum) -> float:
        if self.n_qubits > 14:
            raise ValueError(
                "dense full-space ground truth limited to 14 qubits; pass "
                "reference_energy or ground_truth=False"
            )
        H = paulisum_to_dense_fast(qubit_h, self.n_qubits, self.device)
        return float(torch.linalg.eigvalsh(H)[0])

    @contextlib.contextmanager
    def _phase(self, name: str, each: bool = False):
        """Add this phase's host-clock ms to the epoch's stats, or with
        ``each`` append it to their list (inner steps, ILC folds)."""
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        ms = 1e3 * (time.perf_counter() - t0)
        if each:
            self._stats.setdefault(name, []).append(ms)
        else:
            self._stats[name] = self._stats.get(name, 0.0) + ms

    # -- circuit -------------------------------------------------------------------

    def segment(self, selected):
        """The rotations exp(-i tau_k P_k / 2) of ``selected`` ((x, z) qubit
        masks) as one rot segment (scale 1/2, parameter k)."""
        (seg,) = lower_program(
            [("rot", ((x, z, 0.5),), k) for k, (x, z) in enumerate(selected)], self.n_qubits)
        return seg

    def _state(self, params, seg=None, impl=None):
        """The product state, then ``seg``'s rotations (differentiable)."""
        psi = product_state(params["theta"], params["phi"], self.n_qubits, self.dtype)
        if seg is None or len(seg) == 0:
            return psi
        return rot_segment(seg, psi, params["tau"], self.n_qubits, impl or self.impl)

    def state(self) -> torch.Tensor:
        with torch.no_grad():
            return self._state(self.params)

    # -- operator selection -----------------------------------------------------------

    def _observable(self):
        """The epoch's energy: a DenseObservable of the dressed matrix, or an
        Observable of the dressed sum with its tile layouts built (timed as
        ``layout_ms``)."""
        if self.dense_dressing:
            return DenseObservable(self._dense_h, self.n_qubits, self.dtype)
        obs = Observable(self.current_hamiltonian, self.n_qubits)
        if self.n_qubits >= INNER_TILE_MIN_BITS:
            with self._phase("layout_ms"):
                obs.groups()
                obs.inner_groups()
        return obs

    def select_operator(self, observable):
        """DIS screening: one batched commutator pass over all flip sets.
        If g_max * ratio > threshold select {g > g_max * ratio}, else
        {g > threshold} (reference iqcc.py:123-127), by descending |g|."""
        with self._phase("dis_ms"):
            if self.dense_dressing and self._dense_h is not None and len(self.selected_ops) > 0:
                dis, self._dense_nnz = dense_dis_generators(self._dense_h, self.n_qubits)
            else:
                dis = dis_generators(self.current_hamiltonian)
        self._stats["dis_size"] = len(dis)
        if not dis:
            return [], [], []
        pool = PackedPool([0.5 * P for _, P in dis], self.n_qubits)
        if self.n_qubits >= INNER_TILE_MIN_BITS:
            with self._phase("layout_ms"):
                pool.inner_groups()
        with self._phase("screen_ms"), torch.no_grad():
            psi = product_state(self.params["theta"], self.params["phi"], self.n_qubits,
                                self.dtype)
            w = observable.apply_auto(psi, impl=self.impl)
            grads = pool.screen_scan(psi, w, impl=self.impl)
            grads = np.abs(grads.cpu().numpy().astype(np.float64))
        max_grad = grads.max()
        if max_grad * self.ratio > self.threshold:
            n_sel = int(np.sum(grads > max_grad * self.ratio))
        else:
            n_sel = int(np.sum(grads > self.threshold))
        order = np.argsort(grads)[::-1][:n_sel]
        gens = [dis[i][1] for i in order]
        labels = [dis[i][1].to_terms()[0][0] for i in order]
        return gens, labels, [float(grads[i]) for i in order]

    # -- training ------------------------------------------------------------------

    def _build_step(self, observable, seg, optimizer, style: str = "adam"):
        """step() -> (E, gnorm) at the parameters before the update, which
        ``optimizer`` then makes in place: one Adam step, or one L-BFGS
        iteration (``style="lbfgs"``: its line search evaluates the loss
        again)."""
        params = [self.params[k] for k in ("theta", "phi", "tau")]

        def loss():
            return observable.expectation_auto(self._state(self.params, seg), impl=self.impl)

        def closure():
            optimizer.zero_grad()
            e = loss()
            e.backward()
            return e

        if style == "lbfgs":
            def step():
                first = []

                def recorded():
                    e = closure()
                    if not first:
                        first.append((float(e.detach()), _global_norm(params)))
                    return e

                optimizer.step(recorded)
                return first[0]

            return step

        def step():
            e = closure()
            gnorm = _global_norm(params)
            optimizer.step()
            return float(e.detach()), gnorm

        return step

    def _drive(self, observable, seg, make_optimizer, style, budget, inner,
               stop_at_threshold=True):
        """Inner iterations on ``seg`` under ``observable`` from ``inner`` up
        to ``budget``, each logged; stops early at gnorm < threshold.
        Returns the iteration count."""
        params = [self.params[k] for k in ("theta", "phi", "tau")]
        optimizer = make_optimizer(params)
        step = self._build_step(observable, seg, optimizer, style)
        while inner < budget:
            with self._phase("step_ms", each=True):
                e, gnorm = step()
            self.loss_history["iteration"].append(e)
            self.metrics.log(iter=len(self.loss_history["iteration"]), loss=e, norm=gnorm)
            inner += 1
            if stop_at_threshold and gnorm < self.threshold:
                break
        return inner

    def run(self):
        if self.ground_state_energy is not None:
            print("ground state energy: ", self.ground_state_energy)

        i_epoch = len(self.loss_history["epoch"])
        if self.dense_dressing and self._dense_h is None:
            self._dense_h = paulisum_to_dense_fast(self.current_hamiltonian, self.n_qubits,
                                                   self.device)
        while i_epoch < self.n_epoch:
            self._stats = {}
            observable = self._observable()
            gens, labels, max_grads = self.select_operator(observable)
            if not max_grads:
                print("\nconvergence criterion has satisfied, break the loop!")
                break
            print(f"=== Found operators: {labels}\n with gradients: {max_grads} ===")

            self.params["tau"] = self._param(np.zeros(len(gens)))
            seg = self.segment([(int(P.x[0]), int(P.z[0])) for P in gens])

            def adam(params):
                return torch.optim.Adam(params, lr=self.lr)

            if self.inner_optimizer == "lbfgs":
                # an Adam warm-up hops the high-symmetry stationary points
                # near the tau = 0 start; L-BFGS closes the smooth tail
                inner = self._drive(observable, seg, adam, "adam",
                                    min(100, self.max_inner_iterations // 2), 0)

                def lbfgs(params):
                    # one iteration per call; max_eval leaves the line search
                    # its 25 evaluations (its default, max_iter * 5 / 4,
                    # would leave it none past the first trial step)
                    return torch.optim.LBFGS(params, lr=1.0, max_iter=1, max_eval=26,
                                             history_size=10, line_search_fn="strong_wolfe")

                self._drive(observable, seg, lbfgs, "lbfgs", self.max_inner_iterations, inner)
            else:
                self._drive(observable, seg, adam, "adam", self.max_inner_iterations, 0)

            self.loss_history["epoch"].append(self.loss_history["iteration"][-1])
            self.selected_ops += labels

            # fold the optimized rotations into the Hamiltonian and discard
            # the gates (reference iqcc.py:172-180)
            taus = self.params["tau"].detach().cpu().numpy().astype(np.float64)
            if self.dense_dressing:
                with self._phase("dress_u_ms"):
                    U = dressing_unitary(gens, taus, self.n_qubits, self.device)
                with self._phase("dress_zgemm_ms"):
                    self._dense_h = similarity(U, self._dense_h)
                del U
            else:
                with self._phase("dress_ms"):
                    self.current_hamiltonian, dropped, dweight = dress_hamiltonian(
                        self.current_hamiltonian, gens, taus,
                        max_terms=self.max_terms, compaction_eps=self.compaction_eps,
                    )
                if dropped:
                    self.compaction_bound += dweight
                    print(
                        f"compaction: dropped {dropped} smallest terms "
                        f"({len(self.current_hamiltonian)} kept), epoch bound "
                        f"{dweight:.3e}, cumulative eigenvalue-shift bound "
                        f"{self.compaction_bound:.3e}"
                    )
            if self.ilc:
                self._run_ilc_folds()
            i_epoch += 1
            n_terms = (
                self._dense_nnz
                if self.dense_dressing and self._dense_nnz is not None
                else len(self.current_hamiltonian)
            )
            self._stats.update(epoch=i_epoch, selected=len(gens), h_terms=n_terms,
                               energy=self.loss_history["epoch"][-1])
            self.epoch_stats.append(self._stats)
            print(
                f"epoch: {i_epoch}, total energy: {self.loss_history['epoch'][-1]}, "
                f"H terms: {n_terms}"
            )
            self.save_model()
            if self.plot and self.ground_state_energy is not None:
                plot_energy_iterations(
                    self.img_filepath,
                    self.loss_history["iteration"],
                    self.loss_history["epoch"],
                    self.ground_state_energy,
                    label="iqcc",
                )
        return self.loss_history

    def _run_ilc_folds(self):
        """Up to ``ilc_rounds`` ILC folds at the current product state, each
        on the DIS re-derived from the dressed matrix; the epoch's energy
        entry becomes the folded energy."""
        with torch.no_grad():
            psi = product_state(self.params["theta"].to(torch.float64),
                                self.params["phi"].to(torch.float64), self.n_qubits,
                                torch.complex128)
        for r in range(self.ilc_rounds):
            with self._phase("ilc_ms", each=True):
                dis, self._dense_nnz = dense_dis_generators(self._dense_h, self.n_qubits)
                if not dis:
                    break
                Hd, e_pred, info = ilc_step_dense(
                    self._dense_h, psi, [P for _, P in dis], self.n_qubits, cap=self.ilc_cap)
            self._stats.setdefault("ilc", []).append(
                dict(dis_size=len(dis), selected=info["selected"], gain=info.get("gain", 0.0)))
            if info.get("gain", 0.0) < self.ilc_min_gain:
                break
            self._dense_h = Hd
            self.selected_ops.append(f"ILC[{info['selected']}] gain={info['gain']:.3e}")
            print(
                f"ILC fold {r}: {info['selected']} anticommuting gens, "
                f"E {info['E0']:.6f} -> {e_pred:.6f} "
                f"(gain {info['gain']:.3e}, best single {info['best_single_gain']:.3e})"
            )
            if self.loss_history["epoch"]:
                self.loss_history["epoch"][-1] = float(e_pred)
            self.loss_history["iteration"].append(float(e_pred))
            self.metrics.log(
                iter=len(self.loss_history["iteration"]), loss=float(e_pred),
                norm=0.0, ilc=info["selected"],
            )

    # -- persistence ------------------------------------------------------------------

    def save_model(self):
        ckpt.save_model(
            self.model_filepath,
            {
                **{k: self.params[k].detach().cpu().numpy() for k in ("theta", "phi", "tau")},
                "H_x": np.asarray(self.current_hamiltonian.x),
                "H_z": np.asarray(self.current_hamiltonian.z),
                "H_c": np.asarray(self.current_hamiltonian.c),
            },
            meta={
                "n_qubits": self.n_qubits,
                "selected_ops": self.selected_ops,
                "compaction_bound": self.compaction_bound,
                # with the sidecar the npz's symbolic H is the UNDRESSED
                # initial H: load_model refuses to resume without it
                "dense_sidecar": bool(self.dense_dressing and self._dense_h is not None),
            },
        )
        if self.dense_dressing and self._dense_h is not None:
            # the dressed-H authority, complex128, written atomically
            dense_path = ckpt.resolve(self.model_filepath) + ".dense.npy"
            tmp = dense_path + ".tmp.npy"
            np.save(tmp, self._dense_h.cpu().numpy())
            os.replace(tmp, dense_path)
        ckpt.save_results(self.result_filepath, self.loss_history)

    def load_model(self):
        from ..io.convert import iqcc_from_jax

        if not os.path.exists(ckpt.resolve(self.model_filepath)):
            raise ValueError(f"Please check if the file {self.model_filepath} exists!")
        params, meta, _ = ckpt.load_model(self.model_filepath)
        dense = None
        if self.dense_dressing:
            dense_path = ckpt.resolve(self.model_filepath) + ".dense.npy"
            if os.path.exists(dense_path):
                dense = np.load(dense_path)
            elif meta.get("dense_sidecar"):
                raise RuntimeError(
                    f"dense-dressing checkpoint {self.model_filepath} was "
                    f"saved with a .dense.npy sidecar, but {dense_path} is "
                    "missing; refusing to rebuild from the undressed "
                    "symbolic H. Restore the sidecar or restart the run."
                )
        state = iqcc_from_jax(params, (params["H_x"], params["H_z"], params["H_c"]), dense,
                              device=self.device, dtype=self._rdt)
        self.params = state["params"]
        self.current_hamiltonian = state["hamiltonian"]
        self.selected_ops = list(meta.get("selected_ops", []))
        self.compaction_bound = float(meta.get("compaction_bound", 0.0))
        self.loss_history = ckpt.load_results(self.result_filepath)
        if self.dense_dressing:
            # a legacy checkpoint without a sidecar saved the dressed H in
            # the npz's symbolic form
            self._dense_h = state["dense"] if state["dense"] is not None else \
                paulisum_to_dense_fast(self.current_hamiltonian, self.n_qubits, self.device)


if __name__ == "__main__":
    # reference __main__ config (iqcc_hubbard.py:215-231)
    from ..ops.lattice import fermi_hubbard

    hamiltonian = fermi_hubbard(
        x_dimension=2, y_dimension=2, tunneling=1, coulomb=4, periodic=True, spinless=False
    )
    vqe = IQCC(hamiltonian, n_epoch=100, lr=1e-2, threshold=5e-3, tag="iqcc-hubbard-2x2")
    vqe.run()
