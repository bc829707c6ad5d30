"""Build the image-source core ahead of its first use:
``python -m sarssl_torch.data.build_native``."""
from .native import build, load

if __name__ == "__main__":
    print("built", build(verbose=True))
    load()
    print("loads OK")
