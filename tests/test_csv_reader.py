"""The stdlib CSV reader (sbayes_tpu.utils.read_csv_columns) against the
fixture files: one-hot values and NA, applicable states and confounder
groups, and a geo cost matrix."""
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).parent / "fixtures"


def _read():
    from sbayes_tpu.data.loader import read_features_from_csv

    return read_features_from_csv(FIXTURES / "features.csv",
                                  FIXTURES / "feature_states.csv",
                                  ["universal", "family"])


def test_reader_values_and_na():
    objects, features, _ = _read()
    # F1: A B B C A ; F2: X X Y Y <NA>
    want = np.zeros((5, 2, 3), bool)
    for n, s in enumerate([0, 1, 1, 2, 0]):
        want[n, 0, s] = True
    for n, s in enumerate([0, 0, 1, 1]):
        want[n, 1, s] = True
    np.testing.assert_array_equal(features.values, want)
    assert features.na_number == 1
    np.testing.assert_array_equal(features.na_values[:, 1], [False] * 4 + [True])
    assert objects.id == ["o1", "o2", "o3", "o4", "o5"]
    assert objects.names == ["obj1", "obj2", "obj3", "obj4", "obj5"]
    np.testing.assert_allclose(objects.locations[4], [0.3, 0.8])


def test_reader_applicable_states_and_groups():
    _, features, confounders = _read()
    assert list(features.names) == ["F1", "F2"]
    assert features.state_names == [["A", "B", "C"], ["X", "Y"]]
    np.testing.assert_array_equal(features.states, [[True, True, True],
                                                    [True, True, False]])
    fam = confounders["family"]
    assert fam.group_names == ["famA", "famB"]
    np.testing.assert_array_equal(fam.group_assignment,
                                  [[1, 1, 0, 0, 0], [0, 0, 1, 1, 1]])
    uni = confounders["universal"]
    assert uni.group_names == ["<ALL>"] and uni.group_assignment.all()


def test_reader_cost_matrix(tmp_path):
    """Rows and columns in another order than the objects, asymmetric:
    the matrix comes back in object order, symmetrized."""
    from sbayes_tpu.data.geo import read_geo_cost_matrix

    names = ["o1", "o2", "o3"]
    full = np.array([[0.0, 1.0, 2.0], [3.0, 0.0, 4.0], [2.0, 4.0, 0.0]])
    order = [2, 0, 1]
    lines = ["," + ",".join(names[j] for j in order)]
    for i in order:
        lines.append(names[i] + "," + ",".join(str(float(full[i, j])) for j in order))
    path = tmp_path / "costs.csv"
    path.write_text("\n".join(lines) + "\n")
    got = read_geo_cost_matrix(names, path)
    np.testing.assert_allclose(got, (full + full.T) / 2)


def test_reference_csv_writer_roundtrip(tmp_path):
    """testing.write_reference_csvs (what chip_smoke.py feeds the CLI) reads
    back through the loader as the same dataset, NA cells included."""
    from sbayes_tpu.data.loader import read_features_from_csv
    from sbayes_tpu.testing import synthetic_data, write_reference_csvs

    data = synthetic_data(n_objects=30, n_features=8, n_states=4, n_families=3, seed=1)
    feats, states = write_reference_csvs(data, tmp_path)
    objects, features, confounders = read_features_from_csv(
        feats, states, ["universal", "family"])
    np.testing.assert_array_equal(features.values, data.features.values)
    np.testing.assert_array_equal(features.states, data.features.states)
    assert features.na_number == data.features.na_number > 0
    np.testing.assert_allclose(objects.locations, data.objects.locations)
    for name in ("universal", "family"):
        assert confounders[name].group_names == data.confounders[name].group_names
        np.testing.assert_array_equal(confounders[name].group_assignment,
                                      data.confounders[name].group_assignment)
