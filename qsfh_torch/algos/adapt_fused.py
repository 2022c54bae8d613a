"""Chunked ADAPT training: K train steps per call, one host read per chunk.

Counterpart of ``qsfh_tpu/algos/adapt_fused.py`` (``FusedAdaptRunner``,
``initial_state_reim``) with the same constructor arguments, epoch loop,
in-flight checkpoint file and result histories.  The flagship 3x3
convergence run takes tens of thousands of Adam iterations; driving
:meth:`ADAPT.run`'s inner loop costs ~50 device operations a step, each a
Python call, and a host read of every step's metrics, so the card idles
most of a step.  This runner runs the inner loop in chunks:

* a chunk is K train steps (forward, energy, cotangent, adjoint gradient,
  Adam update) composed from ADAPT's stages
  (:meth:`ADAPT._build_stages`), with Sz, S^2 and fidelity on the chunk's
  last iteration (every iteration with ``metrics_every_iter``) and the
  float64 Rayleigh energy of H at the post-update angles
  (``energy_df``: the parameters the in-flight checkpoint carries);
* per-iteration energies and gradient norms, the metrics and the float64
  readout land in one float64 buffer on the device, read once per chunk;
* ``dispatch="fused"`` on a CUDA device captures the chunk once per epoch
  (ansatz, K, metrics flag) as one ``torch.cuda.CUDAGraph`` and replays
  it: theta and the Adam state (``capturable=True``) are updated in place
  on the device.  Before the capture one step runs on the capture stream
  (term tensors, tile layouts, inner schedules, the grid-barrier and fold
  words, the Adam state are made there, outside the capture) and theta
  and the Adam state are put back.  A capture that fails raises: there is
  no eager fallback.  On the CPU the same chunk runs eagerly;
* ``dispatch="stages"`` runs the chunk as eager per-stage calls with the
  merged ``cot_e`` / ``adj_upd`` stages (E = 1/2 Re <psi|2 H psi>, no
  separate H pass);
* a chunk ends before the loop tests the gradient norm, so an epoch runs
  at most K - 1 steps past the step that met ``threshold2``;
* every chunk writes an in-flight checkpoint (angles, Adam moments as
  optax's ``[count, mu, nu]`` leaves, epoch, learning rate, iterations
  done), in the JAX runner's npz schema: either package resumes the
  other's file.  A resume continues the epoch's iteration budget (the
  iterations done less those in the epoch-boundary checkpoint), so it
  ends where a run without the stop would; the JAX runner restarts the
  budget;
* the chunk, its in-flight save and the selection are spans of
  ``utils/profiling.py`` (``fused.chunk``, ``fused.inflight_save``,
  ``fused.select``) and a replay is its device interval
  (``fused.replay``); :meth:`FusedAdaptRunner.run_inner` takes a callback
  after each chunk's save.

Not ported: the TPU compile-service workarounds of the JAX runner (the
program salt bump, the K -> K/2 halving after a rejected compile, the 30 s
back-off, the (2, 2^n) real-plane program I/O).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..engine.dfloat import combine_rayleigh
from ..io import checkpoint as ckpt
from ..io.convert import from_jax, load_adam_state, to_jax_leaves
from ..utils.profiling import device, span


def initial_state(vqe) -> torch.Tensor:
    """|psi0>: the basis state of the occupied k-modes, on the ADAPT
    instance's device in its dtype."""
    return vqe._initial_state()


class FusedAdaptRunner:
    """Drive an :class:`ADAPT` instance in chunks of K train steps.

    Parameters
    ----------
    vqe:
        A constructed ADAPT instance.  Its ``selected_indices`` /
        ``params_t`` / ``results`` are advanced in place and checkpointed
        through its own ``save_model``.
    chunk_iters:
        Train steps per chunk (K).
    metrics_every_iter:
        Compute Sz / S^2 / fidelity on every iteration instead of only the
        chunk's last one (the result arrays then repeat the freshest value
        so their lengths stay aligned with ``iteration loss``).
    inflight_path:
        Where to write the per-chunk crash-recovery state.  Defaults to
        ``<model file>.inflight.npz``.
    dispatch:
        ``"fused"``: one CUDA graph replay per chunk on a CUDA device (the
        chunk runs eagerly on the CPU); ``"stages"``: eager per-stage calls.
    df_energy:
        Read the float64 Rayleigh energy of each chunk's final state
        (``E_df`` in the metrics log, ``epoch loss df`` in the results).
    """

    def __init__(
        self,
        vqe,
        chunk_iters: int = 8,
        metrics_every_iter: bool = False,
        inflight_path: Optional[str] = None,
        max_inner_iterations: Optional[int] = None,
        verbose: bool = True,
        on_epoch_end=None,
        dispatch: str = "fused",
        df_energy: bool = True,
    ):
        if dispatch not in ("fused", "stages"):
            raise ValueError("dispatch must be 'fused' or 'stages'")
        if int(chunk_iters) < 1:
            raise ValueError("chunk_iters must be at least 1")
        self.vqe = vqe
        self.chunk_iters = int(chunk_iters)
        self.metrics_every_iter = bool(metrics_every_iter)
        self.df_energy = bool(df_energy)
        self.max_inner_iterations = (
            vqe.max_inner_iterations if max_inner_iterations is None
            else int(max_inner_iterations)
        )
        self.verbose = verbose
        self.on_epoch_end = on_epoch_end  # called(epoch_index) after save_model
        self.dispatch = dispatch
        base = ckpt.resolve(vqe.model_filepath)
        self.inflight_path = inflight_path or (base + ".inflight.npz")
        self._psi0 = initial_state(vqe)
        self._last_df_energy: Optional[float] = None
        # CUDA graph bookkeeping: captures, replays, and per capture its
        # milliseconds and the device memory it left allocated (bytes)
        self.captures = 0
        self.replays = 0
        self.capture_stats = []
        # the last chunk's final state (the post-update forward pass that the
        # float64 readout reads)
        self.final_state: Optional[torch.Tensor] = None

    # -- the chunk ------------------------------------------------------------------

    def _rows(self, k: int) -> int:
        return k if self.metrics_every_iter else 1

    def _body(self, raw, th, optimizer, k: int, out: torch.Tensor):
        """K train steps from theta ``th`` (updated in place through
        ``optimizer``), every result written into ``out`` (float64, on the
        device): [E (k), gnorm (k), Sz (m), S^2 (m), fidelity (m), the
        float64 readout (4)], m = k or 1.  Returns the final state (the
        post-update forward pass) or None without ``df_energy``."""
        m = self._rows(k)
        merged = self.dispatch == "stages"
        psi0 = self._psi0
        psi = None

        def put_metrics(row, psi):
            for col, v in enumerate(raw["metrics"](psi)):
                out[2 * k + col * m + row] = v

        for j in range(k):
            psi = raw["fwd_from"](psi0, th)
            if merged:
                lam, e = raw["cot_e"](psi)
            else:
                e = raw["energy"](psi)
                lam = raw["cotangent"](psi)
            out[j] = e
            if self.metrics_every_iter:
                put_metrics(j, psi)
            if merged:
                _, _, gn = raw["adj_upd"](psi, lam, th, optimizer)
            else:
                _, _, gn = raw["update"](th, raw["adjoint"](psi, lam, th), optimizer)
            out[k + j] = gn
        if not self.metrics_every_iter:
            put_metrics(0, psi)
        if not self.df_energy:
            return None
        final = raw["fwd_from"](psi0, th)
        out[2 * k + 3 * m:] = raw["energy_df"](final)
        return final

    def _unpack(self, vals: np.ndarray, k: int) -> dict:
        m = self._rows(k)
        return dict(
            energy=vals[:k], gnorm=vals[k:2 * k], Sz=vals[2 * k:2 * k + m],
            S2=vals[2 * k + m:2 * k + 2 * m], fidelity=vals[2 * k + 2 * m:2 * k + 3 * m],
            df=vals[2 * k + 3 * m:] if self.df_energy else None,
        )

    def build_chunk(self, th: torch.Tensor, optimizer, k: int):
        """A callable running one chunk of ``k`` train steps of the current
        ansatz from ``th`` (updated in place through ``optimizer``, a
        ``torch.optim.Adam`` over ``[th]``, capturable on a CUDA device for
        the fused dispatch) and returning its results read to the host:
        ``energy`` and ``gnorm`` (k,), ``Sz`` / ``S2`` / ``fidelity`` (m,),
        ``df`` (4,) or None.  With ``dispatch="fused"`` on a CUDA device
        the chunk is captured here as one CUDA graph; the callable replays
        it."""
        raw = self.vqe._build_stages(tuple(self.vqe.selected_indices))
        out = torch.zeros(2 * k + 3 * self._rows(k) + 4, dtype=torch.float64, device=th.device)
        if self.dispatch == "fused" and th.is_cuda:
            graph, final = self._capture(raw, th, optimizer, k, out)

            def run():
                with device("fused.replay"):
                    graph.replay()
                self.replays += 1
                self.final_state = final
                return self._unpack(out.cpu().numpy(), k)

            # the graph reads and writes device memory it does not own: theta,
            # the Adam state and the stages' cached term and tile tensors.  The
            # callable keeps them alive as long as the graph.
            run.keep_alive = (raw, th, optimizer)
            return run

        def run():
            self.final_state = self._body(raw, th, optimizer, k, out)
            return self._unpack(out.cpu().numpy(), k)

        return run

    def _capture(self, raw, th, optimizer, k: int, out: torch.Tensor):
        """(graph, its final-state tensor): K steps captured as one CUDA
        graph, after one warm-up step on the capture stream whose effect on
        theta and the Adam state is undone."""
        if not any(g.get("capturable", False) for g in optimizer.param_groups):
            raise ValueError("the fused dispatch on CUDA needs torch.optim.Adam(capturable=True)")
        stream = torch.cuda.Stream(device=th.device)
        stream.wait_stream(torch.cuda.current_stream(th.device))
        saved_th = th.detach().clone()
        saved = {key: v.clone() for key, v in optimizer.state.get(th, {}).items()}
        with torch.cuda.stream(stream):
            self._body(raw, th, optimizer, 1, torch.zeros_like(out[:9]))  # k = m = 1
            th.detach().copy_(saved_th)
            for key, v in optimizer.state[th].items():
                if key in saved:
                    v.copy_(saved[key])
                else:  # the warm-up made the state: a fresh one is all zeros
                    v.zero_()
        torch.cuda.current_stream(th.device).wait_stream(stream)
        torch.cuda.synchronize(th.device)
        before = torch.cuda.memory_allocated(th.device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=stream):
            final = self._body(raw, th, optimizer, k, out)
        torch.cuda.synchronize(th.device)
        self.capture_stats.append(dict(
            k=k, ms=1e3 * (time.perf_counter() - t0),
            pool_bytes=torch.cuda.memory_allocated(th.device) - before))
        self.captures += 1
        return graph, final

    # -- in-flight state ----------------------------------------------------------

    def _save_inflight(self, th: torch.Tensor, optimizer, epoch: int, lr: float):
        blob = {
            "t": th.detach().cpu().numpy(),
            "selected_indices": np.asarray(self.vqe.selected_indices, dtype=np.int64),
            "epoch": np.int64(epoch),
            "lr": np.float64(lr),
            "n_iters": np.int64(len(self.vqe.results["iteration loss"])),
        }
        for i, leaf in enumerate(to_jax_leaves(optimizer, th)):
            blob[f"opt_{i}"] = leaf
        # np.savez appends ".npz" unless the name already ends with it
        tmp = self.inflight_path + ".tmp.npz"
        os.makedirs(os.path.dirname(tmp) or ".", exist_ok=True)
        np.savez(tmp, **blob)
        os.replace(tmp, self.inflight_path)

    def load_inflight(self):
        """The in-flight state of the CURRENT ansatz-growth step (a dict of
        selected_indices, t, epoch, lr, n_iters, opt_leaves), or None.

        It matches when its selected_indices extend ADAPT's
        checkpointed ones: the run stopped inside an epoch whose selection
        is not yet in the epoch-boundary checkpoint.
        """
        if not os.path.exists(self.inflight_path):
            return None
        d = np.load(self.inflight_path, allow_pickle=False)
        stored = [int(i) for i in d["selected_indices"]]
        cur = self.vqe.selected_indices
        if stored[: len(cur)] != cur:
            return None
        opt_leaves = []
        i = 0
        while f"opt_{i}" in d:
            opt_leaves.append(d[f"opt_{i}"])
            i += 1
        return {
            "selected_indices": stored,
            "t": d["t"],
            "epoch": int(d["epoch"]),
            "lr": float(d["lr"]),
            "n_iters": int(d["n_iters"]),
            "opt_leaves": opt_leaves,
        }

    # -- the loop -----------------------------------------------------------------

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    def _run_inner(self, lr: float, epoch: int, adam_state: Optional[dict] = None,
                   inner: int = 0) -> float:
        """:meth:`run_inner` without a callback."""
        return self.run_inner(lr, epoch, adam_state, inner)

    def run_inner(self, lr: float, epoch: int, adam_state: Optional[dict] = None,
                  inner: int = 0, on_chunk=None) -> float:
        """Chunked inner optimization, ``inner`` of the epoch's iterations
        already done; returns the final gradient norm.

        Each chunk is the span ``fused.chunk`` (the replay and the readback)
        and its in-flight save the span ``fused.inflight_save``
        (``utils/profiling.py``).  ``on_chunk(results, chunk_s, save_s)`` is
        called after each chunk's save with the chunk's results (as
        :meth:`build_chunk`'s callable returns them) and the two spans'
        seconds."""
        vqe = self.vqe
        th = vqe.params_t.detach().clone()
        optimizer = torch.optim.Adam([th], lr=lr, capturable=th.is_cuda)
        if adam_state is not None:
            load_adam_state(optimizer, th, adam_state)
        k = self.chunk_iters
        chunk = self.build_chunk(th, optimizer, k)
        gnorm = float("inf")
        while inner < self.max_inner_iterations:
            with span("fused.chunk", steps=k) as timed:
                res = chunk()
            es, gns = res["energy"], res["gnorm"]
            sz, s2, fid = res["Sz"], res["S2"], res["fidelity"]
            e_df = combine_rayleigh(res["df"]) if res["df"] is not None else None
            if e_df is not None:
                self._last_df_energy = e_df
            for j in range(len(es)):
                mj = min(j, len(sz) - 1)
                vqe.results["iteration loss"].append(float(es[j]))
                vqe.results["Sz"].append(float(sz[mj]))
                vqe.results["S^2"].append(float(s2[mj]))
                vqe.results["fidelity"].append(float(fid[mj]))
                extra = {"E_df": e_df} if (e_df is not None and j == len(es) - 1) else {}
                vqe.metrics.log(
                    iter=len(vqe.results["iteration loss"]),
                    loss=float(es[j]),
                    norm=float(gns[j]),
                    fidelity=float(fid[mj]),
                    Sz=float(sz[mj]),
                    S_square=float(s2[mj]),
                    **extra,
                )
            inner += len(es)
            gnorm = float(gns[-1])
            vqe.params_t = th
            with span("fused.inflight_save") as saved:
                self._save_inflight(th, optimizer, epoch, lr)
            df_part = f" | E_df {e_df:+.12f}" if e_df is not None else ""
            self._log(
                f"[fused] epoch {epoch + 1} iter {len(vqe.results['iteration loss'])}"
                f" | E {es[-1]:+.7f}{df_part} | gnorm {gnorm:.3e} | fid {fid[-1]:.6f}"
                f" | {timed.seconds / len(es) * 1e3:.2f} ms/iter (K={k})"
            )
            if on_chunk is not None:
                on_chunk(res, timed.seconds, saved.seconds)
            if bool(np.any(gns < vqe.threshold2)):
                break
        return gnorm

    def run(self, n_epoch: Optional[int] = None, select_fn=None) -> dict:
        """Selection / growth / optimization epochs until an empty selection
        or ``n_epoch``.

        A matching in-flight state resumes first (same epoch, same Adam
        moments, the rest of the epoch's iteration budget).  ``select_fn``
        replaces ADAPT's ``select_operator`` with another source of the same
        ``(indices, grads)`` contract.
        """
        vqe = self.vqe
        if select_fn is None:
            select_fn = vqe.select_operator
        if n_epoch is not None:
            vqe.n_epoch = n_epoch
        i_epoch = len(vqe.results["epoch loss"])
        if vqe.ground_state_energy is not None:
            self._log(f"ground state energy: {vqe.ground_state_energy}")

        inflight = self.load_inflight()
        if inflight is not None and inflight["epoch"] == i_epoch:
            self._log(
                f"[fused] resuming in-flight epoch {i_epoch + 1}: "
                f"{len(inflight['selected_indices'])} params, lr {inflight['lr']:.6g}"
            )
            new = inflight["selected_indices"][len(vqe.selected_indices):]
            vqe.selected_indices = inflight["selected_indices"]
            vqe.results["selected operators"] += [
                repr(vqe.fermion_pool[i]).replace("\n", " ") for i in new
            ]
            if len(vqe.results["n_params"]) <= i_epoch:
                vqe.results["n_params"].append(len(vqe.selected_indices))
            vqe.params_t, _, adam_state = from_jax(
                {"t": inflight["t"], "selected_indices": inflight["selected_indices"]},
                inflight["opt_leaves"], device=vqe.device, dtype=vqe._rdt,
            )
            done = inflight["n_iters"] - len(vqe.results["iteration loss"])
            self._finish_epoch(inflight["lr"], i_epoch, adam_state, max(done, 0))
            i_epoch += 1

        while i_epoch < vqe.n_epoch:
            with span("fused.select") as timed:
                new_indices, max_grads = select_fn()
            self._log(f"[fused] screening: {len(new_indices)} ops in {timed.seconds:.1f}s")
            if not new_indices:
                self._log("\nconvergence criterion has satisfied, break the loop!")
                break
            vqe.selected_indices = vqe.selected_indices + new_indices
            vqe.params_t = torch.cat([
                vqe.params_t.detach(),
                torch.zeros(len(new_indices), dtype=vqe._rdt, device=vqe.device),
            ])
            vqe.results["selected operators"] += [
                repr(vqe.fermion_pool[i]).replace("\n", " ") for i in new_indices
            ]
            vqe.results["n_params"].append(len(vqe.selected_indices))
            n_new = len(new_indices)
            lr = float(np.linalg.norm(max_grads) / np.sqrt(n_new) * vqe.lr_scale)
            self._log(f"epoch {i_epoch + 1}: selected {n_new} operators, lr = {lr:.6f}")
            self._finish_epoch(lr, i_epoch, None)
            i_epoch += 1
        return vqe.results

    def _finish_epoch(self, lr: float, i_epoch: int, adam_state: Optional[dict], inner: int = 0):
        vqe = self.vqe
        self._last_df_energy = None
        self.run_inner(lr, i_epoch, adam_state, inner)
        vqe.results["epoch loss"].append(vqe.results["iteration loss"][-1])
        if self._last_df_energy is not None:
            # the float64 Rayleigh energy of each epoch's final state beside
            # the reference-schema "epoch loss"
            vqe.results.setdefault("epoch loss df", []).append(float(self._last_df_energy))
        vqe.save_model()
        if os.path.exists(self.inflight_path):
            os.remove(self.inflight_path)
        if self.on_epoch_end is not None:
            self.on_epoch_end(i_epoch)
        if vqe.plot and vqe.ground_state_energy is not None:
            from ..io.metrics import plot_energy_iterations

            plot_energy_iterations(
                vqe.img_filepath,
                vqe.results["iteration loss"],
                vqe.results["epoch loss"],
                vqe.ground_state_energy,
            )
