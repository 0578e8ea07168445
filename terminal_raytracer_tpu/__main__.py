import sys

from terminal_raytracer.cli import main

if __name__ == "__main__":
    sys.exit(main())
