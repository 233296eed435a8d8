"""Behavioral tests for the plotting layer: not
import smoke — render to the Agg backend and assert the axes, line,
legend and scale STATE the reference tutorials rely on
(``orphics/io.py:429`` Plotter, ``:689`` FisherPlots, ``:903``
WhiskerPlot, gallery HTML writers)."""
import os

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from orphics_tpu.utils import plot as uplot
from orphics_tpu import io as tio


def test_plotter_scheme_sets_labels_scales_and_scalefn(tmp_path):
    p = uplot.Plotter(scheme="Dell")
    ells = np.arange(2.0, 100.0)
    cl = 1.0 / ells ** 2
    p.add(ells, cl, label="theory")
    ax = p._ax
    assert ax.get_xlabel() == r"$\ell$"
    assert ax.get_ylabel() == r"$D_{\ell}$"
    assert ax.get_xscale() == "linear"
    assert ax.get_yscale() == "log"
    (line,) = ax.get_lines()
    # Dell scheme multiplies by l^2/2pi
    np.testing.assert_allclose(line.get_ydata(),
                               cl * ells ** 2 / 2 / np.pi, rtol=1e-12)
    np.testing.assert_allclose(line.get_xdata(), ells)
    out = tmp_path / "dell.png"
    p.done(str(out))
    assert out.stat().st_size > 1000
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plotter_legend_appears_only_with_labels(tmp_path):
    p = uplot.Plotter(xlabel="x", ylabel="y")
    p.add([1, 2], [3, 4])
    assert not p.do_legend
    p.add([1, 2], [4, 5], label="curve-b")
    assert p.do_legend
    leg = p.legend()
    texts = [t.get_text() for t in leg.get_texts()]
    assert texts == ["curve-b"]
    p.done(str(tmp_path / "leg.png"))


def test_plotter_add_err_band_and_errorbar():
    p = uplot.Plotter()
    x = np.arange(5.0)
    p.add_err(x, x * 2, yerr=np.ones(5), label="pts")
    containers = p._ax.containers
    assert len(containers) == 1          # one errorbar container
    p.add_err(x, x * 3, yerr=np.ones(5), band=True)
    # band mode adds a fill_between polygon
    assert len(p._ax.collections) >= 1
    p._plt.close(p._fig)


def test_plotter_plot2d_colorbar_and_limits():
    p = uplot.Plotter()
    arr = np.linspace(-3, 3, 16).reshape(4, 4)
    p.plot2d(arr, lim=2.0, label="uK")
    assert len(p._fig.axes) == 2          # main + colorbar
    img = p._ax.images[0]
    assert img.get_clim() == (-2.0, 2.0)
    p._plt.close(p._fig)


def test_plotter_hline_vline_state():
    p = uplot.Plotter()
    p.hline(y=1.5)
    p.vline(x=2.5)
    ys = [l.get_ydata()[0] for l in p._ax.get_lines()
          if len(set(l.get_ydata())) == 1]
    xs = [l.get_xdata()[0] for l in p._ax.get_lines()
          if len(set(l.get_xdata())) == 1]
    assert 1.5 in ys and 2.5 in xs
    p._plt.close(p._fig)


def test_fisher_plots_pair_renders_ellipses(tmp_path):
    fp = uplot.FisherPlots()
    fp.addSection("lcdm", ["om", "s8"], ["\\Omega_m", "\\sigma_8"],
                  {"om": 0.3, "s8": 0.8})
    F1 = np.array([[4e4, 1e4], [1e4, 9e4]])
    F2 = F1 * 4.0
    fp.addFisher("lcdm", "planck", F1)
    fp.addFisher("lcdm", "so", F2)
    out = tmp_path / "pair.png"
    fp.plotPair("lcdm", ("om", "s8"), ["planck", "so"],
                labels=["planck", "so"], saveFile=str(out))
    assert out.stat().st_size > 1000
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_fisher_plots_1d_gaussians(tmp_path):
    fp = uplot.FisherPlots()
    fp.addSection("lcdm", ["om"], ["\\Omega_m"], {"om": 0.3})
    fp.addFisher("lcdm", "exp", np.array([[1e4]]))
    out = tmp_path / "oned.png"
    fp.plot1d("lcdm", "om", np.linspace(0.25, 0.35, 101), ["exp"],
              labels=["exp"], saveFile=str(out))
    assert out.stat().st_size > 1000


def test_whisker_plot_points_and_save(tmp_path):
    w = uplot.WhiskerPlot(means=[0.80, 0.76, 0.83],
                          errs=[0.02, 0.03, 0.015],
                          labels=["A", "B", "C"], vline=0.8)
    # three errorbar points + the vline
    assert len(w.ax.containers) == 3
    texts = [t.get_text() for t in w.ax.texts]
    assert texts == ["A", "B", "C"]
    assert w.ax.get_xlabel() == "$S_8$"
    out = tmp_path / "whisker.png"
    w.save(str(out))
    assert out.stat().st_size > 1000


def test_gallery_html_contents(tmp_path):
    # two tiny real PNGs
    import matplotlib.pyplot as plt
    files = []
    for i in range(2):
        f = tmp_path / f"img{i}.png"
        fig = plt.figure(figsize=(1, 1))
        plt.plot([0, 1], [0, i + 1])
        fig.savefig(str(f))
        plt.close(fig)
        files.append(str(f))
    html = uplot.generate_gallery_html(files, titles=["first", "second"])
    assert "<html" in html.lower()
    for f in files:
        assert os.path.basename(f) in html
    assert "first" in html and "second" in html
    out = tmp_path / "gallery.html"
    uplot.write_gallery_html(files, str(out))
    assert out.read_text() == html or os.path.basename(files[0]) \
        in out.read_text()


def test_plotter_facade_names_exist():
    # the reference tutorials use these via orphics.io
    for name in ("Plotter", "FisherPlots", "WhiskerPlot", "fisher_plot",
                 "plot_img", "hist", "power_crop", "fplot", "mplot",
                 "generate_gallery_html", "write_gallery_html"):
        assert hasattr(tio, name), name
