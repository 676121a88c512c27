import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.join(HERE, "..", "src"), os.path.join(HERE, "..")):
    path = os.path.abspath(path)
    if path not in sys.path:
        sys.path.insert(0, path)
