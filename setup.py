import os

from setuptools import find_packages, setup

pwd = os.path.dirname(__file__)


def get_version():
    with open(os.path.join(pwd, 'lmdeploy_tpu', 'version.py')) as f:
        for line in f:
            if line.startswith('__version__'):
                return line.split('=')[1].strip().strip("'\"")
    raise RuntimeError('version not found')


setup(
    name='lmdeploy_tpu',
    version=get_version(),
    description='TPU-native LLM inference & serving (JAX/XLA/Pallas)',
    packages=find_packages(exclude=('tests', 'benchmark')),
    python_requires='>=3.10',
    install_requires=[
        'jax',
        'numpy',
        'safetensors',
        'transformers',
        'aiohttp',
        'pydantic',
    ],
    entry_points={
        'console_scripts': [
            'lmdeploy-tpu = lmdeploy_tpu.cli.main:main',
            'lmdeploy-tpu-torch = lmdeploy_tpu_torch.cli.main:main',
        ],
    },
)
