"""The port's deploy manifests, held against the checked-in `deploy/`
files and the JAX package's generator on the CPU.

The cases of tests/test_observability.py::TestDeployManifests on the
port (the generator's drift check, the CRDs' admission schema, the RBAC
triples the controllers need), plus `render()` equal to the JAX
`render()` and the module importing without PyYAML.

Tolerance: byte equality.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from karpenter_tpu import deploy as jdeploy
from karpenter_tpu_torch import deploy
from karpenter_tpu_torch.kube.real import RESOURCES, WRITE_ONLY_KINDS

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("crds.yaml", "karpenter.yaml")


@pytest.mark.parametrize("name", NAMES)
def test_checked_in_manifests_match_generator(name):
    assert (ROOT / "deploy" / name).read_text() == deploy.render()[name], (
        f"deploy/{name} differs from python -m karpenter_tpu_torch.deploy")


@pytest.mark.parametrize("name", NAMES)
def test_render_equals_jax(name):
    assert deploy.render()[name] == jdeploy.render()[name]


def test_objects_equal_jax():
    assert deploy.crds() == jdeploy.crds()
    assert deploy.operator_manifests() == jdeploy.operator_manifests()
    assert deploy.operator_manifests("img:1") == jdeploy.operator_manifests("img:1")


@pytest.mark.parametrize("plural", ["nodepools", "nodeclaims"])
def test_crds_carry_admission_schema(plural):
    docs = {d["metadata"]["name"]: d
            for d in yaml.safe_load_all(deploy.render()["crds.yaml"])}
    artifact = json.loads(
        (ROOT / "karpenter_tpu_torch" / "apis" / "crds" / f"karpenter.sh_{plural}.json").read_text())
    installed = docs[f"{plural}.karpenter.sh"]["spec"]["versions"][0]["schema"]["openAPIV3Schema"]
    assert installed == artifact["openAPIV3Schema"]


def test_rbac_grants_required_group_resource_verbs():
    docs = list(yaml.safe_load_all(deploy.render()["karpenter.yaml"]))
    role = next(d for d in docs if d["kind"] == "ClusterRole")

    def granted(group, resource, verb):
        return any(group in rule["apiGroups"] and resource in rule["resources"]
                   and verb in rule["verbs"] for rule in role["rules"])

    def group_of(prefix):
        return "" if prefix == "/api/v1" else prefix.split("/")[2]

    for kind, (prefix, plural, _ns) in RESOURCES.items():
        verbs = (("create", "update") if kind in WRITE_ONLY_KINDS
                 else ("get", "list", "watch"))
        for verb in verbs:
            assert granted(group_of(prefix), plural, verb), f"RBAC missing {verb} on {plural}"
    for group, resource, verb in [
        ("karpenter.sh", "nodeclaims", "create"),
        ("karpenter.sh", "nodeclaims", "delete"),
        ("karpenter.sh", "nodepools", "update"),
        ("", "nodes", "create"),
        ("", "nodes", "update"),
        ("", "nodes", "delete"),
        ("", "pods", "create"),
        ("", "pods", "delete"),
        ("coordination.k8s.io", "leases", "create"),
        ("coordination.k8s.io", "leases", "update"),
    ]:
        assert granted(group, resource, verb), f"RBAC missing {verb} on {group or 'core'}/{resource}"


def test_write_renders_both_files(tmp_path):
    deploy.write(str(tmp_path))
    for name in NAMES:
        assert (tmp_path / name).read_text() == (ROOT / "deploy" / name).read_text()


def test_without_pyyaml_imports_and_names_it():
    """With `yaml` unimportable the module still imports; `render()`
    raises an ImportError that names PyYAML."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "import karpenter_tpu_torch.deploy as d\n"
        "assert d.crds() and d.operator_manifests()\n"
        "try:\n"
        "    d.render()\n"
        "except ImportError as err:\n"
        "    print('raised:', err)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "raised:" in out.stdout and "PyYAML" in out.stdout
