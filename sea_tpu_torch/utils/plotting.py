"""Field visualization: a copy of ``sea_tpu/utils/plotting.py``.

Matplotlib scatters of node field values at mesh coordinates, one subplot
per field, and the rollout error against time, on the Agg backend
(headless). matplotlib is imported inside each function, only when a plot
is drawn: the port needs it for nothing else, and a machine without it
(the H100 machine the port is measured on has none, and nothing can be
installed there) still serves, trains and writes every CSV. The
evaluation's artifact writers ask ``matplotlib_missing()`` first and,
where it names a module, print one line naming the plots they skip.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def matplotlib_missing() -> Optional[str]:
    """None where matplotlib imports, else the name of the missing
    module."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        return exc.name or "matplotlib"
    return None


def plot_all_fields_2d(data: np.ndarray, coordx: np.ndarray,
                       coordy: np.ndarray, idx: int, *,
                       filename: Optional[str] = None,
                       show: bool = False) -> None:
    """data: [T, N, F]; plots all fields at timestep idx."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    snap = np.asarray(data[idx])
    F = snap.shape[-1]
    fig, axes = plt.subplots(1, F, figsize=(6 * F, 4))
    if F == 1:
        axes = [axes]
    for f in range(F):
        sc = axes[f].scatter(coordx, coordy, c=snap[:, f], s=4, cmap="jet")
        axes[f].set_title(f"Field {f + 1} (t={idx})")
        fig.colorbar(sc, ax=axes[f])
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=100)
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)


def plot_fields_2d(data: np.ndarray, coordx: np.ndarray,
                   coordy: np.ndarray, field_index: int, time_index: int, *,
                   filename: Optional[str] = None, ax=None,
                   show: bool = False) -> None:
    """Single-field 2D scatter: data [T, N, F], one field at one
    timestep; optionally draws into a caller-provided axes."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    vals = np.asarray(data[time_index, :, field_index])
    if ax is None:
        fig, ax = plt.subplots(figsize=(14, 4))
    else:  # pragma: no cover - composition path
        fig = ax.figure
    sc = ax.scatter(coordx, coordy, c=vals, cmap="viridis",
                    vmin=vals.min(), vmax=vals.max())
    cbar = fig.colorbar(sc, ax=ax, orientation="vertical")
    cbar.set_label("Field Value")
    ax.set_title(f"Field {field_index}")
    ax.set_xlabel("X Coordinate")
    ax.set_ylabel("Y Coordinate")
    if filename:
        fig.savefig(filename)
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)


def plot_fields_3d(data: np.ndarray, coordx: np.ndarray, coordy: np.ndarray,
                   coordz: np.ndarray, field_index: int, time_index: int, *,
                   filename: Optional[str] = None, vmin=None, vmax=None,
                   ax=None, show: bool = False) -> None:
    """Single-field 3D scatter."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    vals = np.asarray(data[time_index, :, field_index])
    if ax is None:
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
    else:  # pragma: no cover - composition path
        fig = ax.figure
    sc = ax.scatter(coordx, coordy, coordz, c=vals, cmap="viridis",
                    vmin=vals.min() if vmin is None else vmin,
                    vmax=vals.max() if vmax is None else vmax)
    cbar = fig.colorbar(sc, ax=ax, orientation="vertical")
    cbar.set_label("Field Value")
    ax.set_title(f"Field {field_index}")
    ax.set_xlabel("X Coordinate")
    ax.set_ylabel("Y Coordinate")
    if filename:
        fig.savefig(filename)
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)


def plot_all_fields_3d(data: np.ndarray, coordx: np.ndarray,
                       coordy: np.ndarray, coordz: np.ndarray, idx: int, *,
                       filename: Optional[str] = None,
                       show: bool = False) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    snap = np.asarray(data[idx])
    F = snap.shape[-1]
    fig = plt.figure(figsize=(6 * F, 5))
    for f in range(F):
        ax = fig.add_subplot(1, F, f + 1, projection="3d")
        sc = ax.scatter(coordx, coordy, coordz, c=snap[:, f], s=3,
                        cmap="jet")
        ax.set_title(f"Field {f + 1} (t={idx})")
        fig.colorbar(sc, ax=ax, shrink=0.6)
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=100)
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)


def plot_rollout_error(decoded_rel_mse: np.ndarray, filename: str) -> None:
    """decoded_rel_mse: [T, F] — rollout-error-vs-time curves."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    T, F = decoded_rel_mse.shape
    steps = np.arange(1, T + 1)
    plt.figure(figsize=(10, 6))
    for f in range(F):
        plt.plot(steps, decoded_rel_mse[:, f], label=f"Field {f + 1}")
    plt.plot(steps, decoded_rel_mse.mean(axis=1),
             label="average Relative MSE")
    plt.xlabel("Time Step")
    plt.ylabel("Relative MSE")
    plt.title("Rollout Error: Relative MSE over Time for Each Field")
    plt.legend()
    plt.grid(True, which="both", ls="-", alpha=0.2)
    plt.savefig(filename)
    plt.close()
