"""The former name of the `terminal_raytracer` package, kept so that
`python -m` under this name still starts the CLI. Code imports
`terminal_raytracer`."""
