from .core_types import (
    CPUPlace,
    CUDAPlace,
    Place,
    VarType,
    convert_dtype,
    default_place,
)
from .framework import (
    Block,
    EMPTY_VAR_NAME,
    OpRole,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    grad_var_name,
    op_role_guard,
    program_guard,
    switch_main_program,
    switch_startup_program,
)
from .scope import Scope, global_scope, scope_guard
from .executor import Executor, program_as_function
from . import unique_name
